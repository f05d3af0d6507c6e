"""Self-contained scoring artifacts, in `torch.export`'s format.

Counterpart of `coskad_tpu/export_hlo.py`, whose name it keeps so a reader
finds it; the JAX package writes StableHLO through `jax.export`, this one
`torch.export` programs, so neither package loads the other's artifact.

`export_scorer` traces a scorer's window-scoring program for one chunk
(`scoring_program`: the identity transform and coordinate slice of
`gather_batch`, the eval forward, the variant's window score and the
decoder's reconstruction error) with the weights, the BatchNorm statistics
and the geometry (center, inv_cov, mean_vector) held as the program's
buffers, and writes it to one zip. `load_artifact` runs it with no model
code: this module imports torch, numpy, `kernels.stse_fused` (which
registers K1's custom op) and `geometry.sphere`, nothing of `models/` or
`train/`.

The encoder step is K1 (the custom op `coskad_torch::stse_fused_hidden`, or
`coskad_torch::stse_fused_hidden_bf16` at bf16, on the packed operand, a
buffer) where the library's eval forward takes it: the sts_gcn encoder on
the card, in a layout the planner of its form takes (`STSE.kernel_takes`).
Elsewhere it is the module path, with its bf16 rounding points (meta
`encoder_route`: "K1" or "modules"). The decoder variants' decoder step
is K1 likewise, on the decoder's own packed operand, where the eval decode
takes it (`STSAE.decoder_kernel_takes`). A K1 artifact
moved to the CPU runs the op's CPU implementation, the plain version; a
module-route artifact written on the CPU runs its modules on the card.

A sampling VAE cannot draw inside the program: PowerSpherical's Beta draw
depends on the concentration the program computes, and a program holds no
`torch.Generator`. Its artifact is two programs around the draw: `encode`
(windows -> z_mean, z_var), then the loader draws z as the model does
(`PowerSpherical.rsample`, or a normal draw for 'normal') from a generator
seeded from the meta's `draw_key` (cfg.run.seed, step, 7), as
`Trainer._generator(step, 7)`, one chunk after another, then `scoring`
((z, windows) -> scores, rec).

Artifact layout (zip):
    scoring.pt2   torch.export program: windows f32[B, C_in, T, V] ->
                  (scores f32[B], rec f32[B]); for a sampling VAE
                  (z f32[B, D], windows) -> (scores, rec)
    encode.pt2    a sampling VAE's windows -> (z_mean, z_var)
    meta.json     variant, geometry and preprocessing metadata, the
                  device it was exported on, the encoder route and the
                  serve chunking contract (see ExportedScorer)
    scaler.npz    the fitted robust scaler, when the checkpoint has one
"""

from __future__ import annotations

import dataclasses
import io
import json
import zipfile
from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from .device import resolve_device
from .geometry.sphere import PowerSpherical
from .kernels import stse_fused  # noqa: F401  (registers K1's custom op)

ARTIFACT_VERSION = 1
SCORING_MEMBER = "scoring.pt2"
ENCODE_MEMBER = "encode.pt2"
META_MEMBER = "meta.json"
SCALER_MEMBER = "scaler.npz"
DRAW_STREAM = 7  # the eval pass's generator key after the step (train/loop.py)
MIN_SYMBOLIC_BATCH = 2  # torch.export specializes batches of 0 and 1


class _ScoringProgram(nn.Module):
    """One chunk's scoring program over `trainer.model` and `state`.
    `part`: "all" (windows -> scores, rec) or "encode" (windows -> z_mean,
    z_var); `_ScoreHalf` is the third, (z, windows) -> (scores, rec). The
    packed K1 operands (the encoder's, and the decoder variants' decoder's),
    folded before tracing (the fold's cache keys on storage pointers, which
    traced tensors lack), are buffers of their own."""

    def __init__(self, trainer, state, part: str = "all"):
        super().__init__()
        cfg = trainer.cfg
        self.cfg, self.part, self.model = cfg, part, trainer.model
        self.register_buffer("identity", trainer.trans_table[0].detach().clone())
        for name in ("center", "inv_cov", "mean_vector"):
            self.register_buffer(name, getattr(state, name).detach().clone())
        self.k1 = trainer.device.type == "cuda" and self.model.kernel_takes()
        if self.k1:
            _, packed = self.model.folded()
            weights, *self.k1_args = packed.op_args
            self.k1_op = packed.op
            self.register_buffer("k1_weights", weights.clone())
        self.k1_decoder = (trainer.device.type == "cuda" and cfg.model.use_decoder
                           and self.model.decoder_kernel_takes())
        if self.k1_decoder:
            self.k1_decoder_packed = self.model.decoder_folded()[1]
            self.register_buffer("k1_decoder_weights", self.k1_decoder_packed.weights.clone())

    def _batch(self, windows: torch.Tensor) -> torch.Tensor:
        """`gather_batch` with the identity transform (x' = 1x + 0y + 0,
        the library's bits) and the coordinate slice."""
        from .data.transforms import apply_transforms

        mats = self.identity.expand(windows.shape[0], 3, 3)
        if self.cfg.model.num_coords == 2 and windows.shape[1] > 2:
            return apply_transforms(windows[:, :2], mats)
        return apply_transforms(windows, mats)[:, :self.cfg.model.num_coords]

    def _features(self, batch: torch.Tensor) -> torch.Tensor:
        """The projected hidden state on the eval forward's route."""
        if self.k1:
            h = self.k1_op(batch.contiguous(), self.k1_weights, *self.k1_args)
        else:
            h = self.model._module_hidden(batch, False, False)
        return self.model._project(h, False)

    def _decoded(self, z: torch.Tensor) -> torch.Tensor:
        """The reconstruction on the eval decode's route: K1 on the
        decoder's packed operand, or the modules."""
        if not self.k1_decoder:
            return self.model.decode(z)
        return self.model.k1_decode(z, dataclasses.replace(self.k1_decoder_packed,
                                                           weights=self.k1_decoder_weights))

    def _scores(self, z: torch.Tensor, batch: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        from .train import objectives

        scores = objectives.window_scores(self.cfg, z, self.center, self.inv_cov,
                                          self.mean_vector)
        if self.cfg.model.use_decoder:
            rec = torch.mean((self._decoded(z) - batch) ** 2, dim=(1, 2, 3))
        else:
            rec = scores.new_zeros(scores.shape[0])
        return scores.float(), rec.float()

    def forward(self, windows: torch.Tensor):
        batch = self._batch(windows)
        feat = self._features(batch)
        if not self.cfg.model.use_vae:
            return self._scores(feat, batch)
        z_mean, z_var = self.model.posterior(feat)
        if self.part == "encode":
            return z_mean, z_var
        return self._scores(z_mean, batch)  # the VAE on its posterior mean


class _ScoreHalf(_ScoringProgram):
    """A sampling VAE's scoring after the draw: (z, windows) -> (scores, rec)."""

    def forward(self, z: torch.Tensor, windows: torch.Tensor):
        return self._scores(z, self._batch(windows))


def _samples(trainer) -> bool:
    """Whether the library's eval pass samples the VAE's latent."""
    return bool(trainer.cfg.model.use_vae and trainer.vae_sample
                and trainer.cfg.eval.vae_sample)


def scoring_program(trainer, state) -> nn.Module:
    """The pure scoring program of one chunk for (trainer, state), as a
    module holding its state as buffers: windows [B, C_in, T, V] ->
    (scores [B], rec [B]), rec zero for the encoder-only variants. A
    sampling VAE's is the `score` half, (z, windows) -> (scores, rec),
    after `scoring_program_encode`."""
    cls = _ScoreHalf if _samples(trainer) else _ScoringProgram
    return cls(trainer, state).eval()


def scoring_program_encode(trainer, state) -> nn.Module:
    """A sampling VAE's `encode` half: windows -> (z_mean, z_var)."""
    return _ScoringProgram(trainer, state, "encode").eval()


def _export(program: nn.Module, example: tuple, symbolic: bool) -> bytes:
    """The traced program, saved. opt_einsum is off while tracing: it picks
    a contraction order from the sizes, which would fix the batch (the
    Mahalanobis score's three-operand einsum is then taken left to right)."""
    batch = torch.export.Dim("batch", min=MIN_SYMBOLIC_BATCH) if symbolic else None
    dynamic = tuple({0: batch} if symbolic else None for _ in example)
    with torch.no_grad(), torch.backends.opt_einsum.flags(enabled=False):
        ep = torch.export.export(program, example, dynamic_shapes=dynamic)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def export_scorer(scorer, out_path: str, batch_size: Optional[int] = None,
                  in_channels: Optional[int] = None) -> dict:
    """Write `scorer`'s (a `serve.AnomalyScorer`) scoring program to the
    artifact zip `out_path`, traced on the scorer's device, and return its
    metadata.

    batch_size: a fixed leading dimension; None exports a symbolic batch
        (any request of at least 2 windows a chunk: the loader never sends
        fewer).
    in_channels: the windows' channels; default the training window layout
        (the train set's, else num_coords + 1: x, y, confidence)."""
    trainer, state = scorer.trainer, scorer.state
    cfg = trainer.cfg
    if in_channels is None:
        data = getattr(trainer.train_ds, "data", None)
        in_channels = (int(data.shape[1]) if data is not None and data.ndim == 4
                       else cfg.model.num_coords + 1)
    t, v = cfg.data.seg_len, cfg.data.n_joints
    symbolic = batch_size is None
    b = 2 * MIN_SYMBOLIC_BATCH if symbolic else int(batch_size)
    windows = torch.zeros((b, in_channels, t, v), device=trainer.device)
    members = {}
    program = scoring_program(trainer, state)
    if _samples(trainer):
        encode = scoring_program_encode(trainer, state)
        members[ENCODE_MEMBER] = _export(encode, (windows,), symbolic)
        with torch.no_grad():
            z = encode(windows)[0]
        members[SCORING_MEMBER] = _export(program, (z, windows), symbolic)
    else:
        members[SCORING_MEMBER] = _export(program, (windows,), symbolic)

    meta = {
        "artifact_version": ARTIFACT_VERSION,
        "torch_version": torch.__version__,
        "device": trainer.device.type,
        "encoder_route": "K1" if program.k1 else "modules",
        "variant": cfg.model.variant,
        "distance": cfg.model.distance,
        "distribution": cfg.model.distribution,
        "use_decoder": bool(cfg.model.use_decoder),
        "use_vae": bool(cfg.model.use_vae),
        "vae_sample": _samples(trainer),
        "num_coords": cfg.model.num_coords,
        "in_channels": int(in_channels),
        "seg_len": int(t),
        "n_joints": int(v),
        "batch_size": None if symbolic else int(batch_size),
        # the library's chunking (Trainer._chunked_indices) and its eval
        # draws' generator key (Trainer._generator(step, 7))
        "serve_batch_size": int(cfg.data.batch_size),
        "draw_key": [int(cfg.run.seed), int(state.step), DRAW_STREAM],
        # host-side preprocessing recipe (serve.preprocess_windows)
        "preprocess": {
            "kp18_format": bool(cfg.data.kp18_format),
            "headless": bool(cfg.data.headless),
            "normalize_pose": bool(cfg.data.normalize_pose),
            "normalization_strategy": cfg.data.normalization_strategy,
            "vid_res": list(cfg.data.vid_res),
            "symm_range": bool(cfg.data.symm_range),
            "sub_mean": bool(cfg.data.sub_mean),
            "kp_threshold": float(cfg.data.kp_threshold),
        },
    }
    with zipfile.ZipFile(out_path, "w", zipfile.ZIP_DEFLATED) as zf:
        for name, blob in members.items():
            zf.writestr(name, blob)
        zf.writestr(META_MEMBER, json.dumps(meta, indent=1))
        scaler = getattr(scorer, "scaler", None)
        if scaler is not None:
            buf = io.BytesIO()
            np.savez(buf, center=np.asarray(scaler.center), scale=np.asarray(scaler.scale))
            zf.writestr(SCALER_MEMBER, buf.getvalue())
    return meta


class ExportedScorer:
    """Run a scoring artifact, with no model code.

    `score_windows` reproduces the library's `AnomalyScorer.score_windows`
    (`Trainer._eval_pass`): chunks of min(serve_batch_size, n) windows, the
    last one filled by wrapping around (window i % n), a sampling VAE's
    draws from one generator seeded from `draw_key` across the chunks in
    order. Two departures: a symbolic artifact takes at least 2 windows a
    chunk, so one window is scored as a chunk of two (itself twice); a
    fixed-batch artifact takes chunks of its batch, the last zero-padded,
    as JAX's does. `__call__` is the raw program on one chunk."""

    def __init__(self, programs: dict, meta: dict, scaler_arrays=None,
                 device: Union[str, torch.device] = "cuda"):
        self.meta = meta
        self.scaler_arrays = scaler_arrays
        self.device = resolve_device(device)
        self._scoring = programs[SCORING_MEMBER].module()
        self._encode = programs[ENCODE_MEMBER].module() if ENCODE_MEMBER in programs else None

    def _generator(self, draw_key) -> Optional[torch.Generator]:
        """The draws' generator (None for a program that draws nothing),
        seeded from `draw_key` (default the meta's) as `Trainer._generator`."""
        if self._encode is None:
            return None
        key = self.meta["draw_key"] if draw_key is None else draw_key
        seed = np.random.SeedSequence(tuple(int(k) for k in key)).generate_state(
            1, np.uint64)[0]
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _chunk(self, x: torch.Tensor, gen: Optional[torch.Generator]):
        if self._encode is None:
            return self._scoring(x)
        z_mean, z_var = self._encode(x)
        if self.meta["distribution"] == "ps":
            z = PowerSpherical(z_mean, z_var.squeeze(-1)).rsample(gen)
        else:
            z = z_mean + z_var * torch.randn(z_mean.shape, generator=gen, device=z_mean.device)
        return self._scoring(z, x)

    def __call__(self, windows, draw_key=None) -> Tuple[np.ndarray, np.ndarray]:
        """One chunk [B, C_in, T, V] -> ([B] scores, [B] rec), a sampling
        VAE's draws from a generator seeded from `draw_key` (default the
        meta's)."""
        x = torch.as_tensor(np.asarray(windows, np.float32), device=self.device)
        with torch.no_grad():
            scores, rec = self._chunk(x, self._generator(draw_key))
        return scores.cpu().numpy(), rec.cpu().numpy()

    def score_windows(self, windows: np.ndarray, draw_key=None, return_rec: bool = False):
        """[N, C_in, T, V] -> [N] scores (and [N] reconstruction errors,
        zeros for the encoder-only variants)."""
        windows = np.ascontiguousarray(windows, np.float32)
        n = len(windows)
        if n == 0:
            empty = np.zeros(0, np.float32)
            return (empty, empty.copy()) if return_rec else empty
        data = torch.as_tensor(windows, device=self.device)
        fixed = self.meta.get("batch_size")
        if fixed is None:
            bs = max(min(int(self.meta["serve_batch_size"]), n), MIN_SYMBOLIC_BATCH)
            k = -(-n // bs)
            idx = torch.remainder(torch.arange(k * bs, device=self.device), n).reshape(k, bs)
            chunks = [data.index_select(0, idx[i]) for i in range(k)]
        else:
            bs = int(fixed)
            k = -(-n // bs)
            padded = data.new_zeros((k * bs, *data.shape[1:]))
            padded[:n] = data
            chunks = list(padded.split(bs))
        gen = self._generator(draw_key)
        scores, recs = [], []
        with torch.no_grad():
            for chunk in chunks:
                s, r = self._chunk(chunk, gen)
                scores.append(s)
                recs.append(r)
        scores = torch.cat(scores)[:n].cpu().numpy()
        recs = torch.cat(recs)[:n].cpu().numpy()
        return (scores, recs) if return_rec else scores


def load_artifact(path: str, device: Union[str, torch.device] = "cuda") -> ExportedScorer:
    """Load an artifact written by `export_scorer` onto `device` (default
    CUDA; raises without it), moving one exported on the other device with
    `torch.export.passes.move_to_device_pass`."""
    device = resolve_device(device)
    with zipfile.ZipFile(path) as zf:
        meta = json.loads(zf.read(META_MEMBER))
        if meta.get("artifact_version", 0) > ARTIFACT_VERSION:
            raise ValueError(
                f"artifact {path!r} has version {meta['artifact_version']}, this loader "
                f"supports <= {ARTIFACT_VERSION}")
        blobs = {name: zf.read(name) for name in (SCORING_MEMBER, ENCODE_MEMBER)
                 if name in zf.namelist()}
        scaler_arrays = None
        if SCALER_MEMBER in zf.namelist():
            with np.load(io.BytesIO(zf.read(SCALER_MEMBER))) as npz:
                scaler_arrays = {k: npz[k] for k in npz.files}
    programs = {}
    for name, blob in blobs.items():
        ep = torch.export.load(io.BytesIO(blob))
        if meta["device"] != device.type:
            from torch.export.passes import move_to_device_pass

            ep = move_to_device_pass(ep, device)
        programs[name] = ep
    return ExportedScorer(programs, meta, scaler_arrays, device)
