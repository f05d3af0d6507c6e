"""The Trainer (counterpart of `coskad_tpu/train/loop.py`) for every
variant (euclidean static / dynamic, hyperbolic, autoencoder, VAE):
training, center initialization, scoring and validation.

Windows are uploaded once, flat [N, C*T*V], to the device. A pass walks
[K, B] index chunks in an eager Python loop (the JAX package's `lax.scan`):
per chunk, gather the batch (sample i % N, transform i // N), then

  * train (`train_epoch`, `fit`): the train-mode forward, loss, backward,
    Adam step and the epoch accumulators. The forward is the ghost-BN
    K2-K4 path (`kernels/stse_train.py`) when `run.fused_train` allows it
    and the batch is a multiple of `run.ghost_size`, else the module path
    with live BatchNorm (or running statistics under `freeze_bn_after`);
  * score (`score_all`, `embed_all`): the eval forward (on CUDA at float32,
    the fused encoder kernel K1) and the variant's window score; the
    decoder variants also give each window's reconstruction MSE.

The VAE draws its training samples from a `torch.Generator` seeded from
(cfg.run.seed, step), so a resumed run draws what a straight one does; an
eval pass that samples (`eval.vae_sample`) draws from one seeded from
(cfg.run.seed, step, 7), so scoring one state twice gives the same bits.
Dropout (`model.dropout` > 0) draws its train-mode masks from a separate
stream seeded from (cfg.run.seed, step, 0x60), JAX's `fold_in(key, 0x60)`,
so a VAE with dropout draws both and a resumed run draws what a straight
one does.
`Trainer.vae_sample = False` puts train and eval on the posterior mean
(the lockstep tests' deterministic path).

Per-step metrics stay on the device until one copy to the host at the end
of an epoch. The model is switched to `train()` for a train epoch and back
to `eval()` after it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..config import Config
from ..data.transforms import canonical_transforms, gather_batch
from ..data.windows import SegmentDataset
from ..device import resolve_device
from ..geometry import poincare as hyp
from ..kernels import stse_train
from ..models import build_model
from ..score.aggregate import EvalResult, ScoringConfig, evaluate_windows
from ..score.masks import AVENUE_MASKED_CLIPS
from ..utils.logging import MetricLogger
from . import objectives, schedulers
from .state import TrainState, clamp_center, init_state


def model_kwargs_from_config(cfg: Config) -> dict:
    # as the JAX package: the modules' dtype is bf16 for "bfloat16" alone; the
    # fused path takes the string itself ("bfloat16_f32store" too)
    return dict(
        dtype=torch.bfloat16 if cfg.run.compute_dtype == "bfloat16" else torch.float32,
        use_decoder=cfg.model.use_decoder,
        use_vae=cfg.model.use_vae,
        distribution=cfg.model.distribution,
        decoder_channels=cfg.model.decoder_channels,
        kappa_floor=cfg.model.kappa_floor,
        input_dim=cfg.model.num_coords,
        layer_channels=tuple(cfg.model.channels),
        hidden_dimension=cfg.model.h_dim,
        latent_dim=cfg.model.latent_dim,
        n_frames=cfg.data.seg_len,
        n_joints=cfg.data.n_joints,
        encoder_type=cfg.model.encoder_type,
        projector=cfg.model.projector,
        projector_hidden_layers=cfg.model.projector_hidden_layers,
        dropout=cfg.model.dropout,
    )


class Trainer:
    """Training, scoring and validation for one config.

    Args:
        cfg: full configuration.
        train_ds: training SegmentDataset (resident once on the device).
        val_ds: optional SegmentDataset for validation AUC.
        ground_truths: {(scene, clip): labels} for validation scoring.
        device: 'cuda' (default; raises if CUDA is missing) or 'cpu'.
        logger: per-step and per-epoch metrics (stdout JSONL by default).

    The model is built with weights drawn from `cfg.run.seed`; load other
    weights into `trainer.model` (e.g. `interop.load_jax_variables`). The
    optimizer is `trainer.optimizer`: Adam at `cfg.opt.lr` without weight
    decay, the formula of optax's `adam` (eps 1e-8 outside the square
    root); assign another one over `trainer.model.parameters()` to replace
    it (the tests use SGD).
    """

    def __init__(
        self,
        cfg: Config,
        train_ds: SegmentDataset,
        val_ds: Optional[SegmentDataset] = None,
        ground_truths: Optional[dict] = None,
        device: Union[str, torch.device] = "cuda",
        logger: Optional[MetricLogger] = None,
    ):
        # JAX shards over a (data, model) mesh built from these; the port
        # trains on one device until multi-GPU is ported.
        if cfg.run.data_parallel not in (-1, 1) or cfg.run.model_parallel != 1:
            raise ValueError(
                f"run.data_parallel {cfg.run.data_parallel}, run.model_parallel "
                f"{cfg.run.model_parallel}: the port trains on one device (data_parallel -1 "
                "or 1, model_parallel 1); multi-GPU is not ported yet (ROADMAP.md, Queue 1 "
                "item 5)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(**model_kwargs_from_config(cfg))
        self.model.reset_parameters(torch.Generator().manual_seed(cfg.run.seed))
        self.model = self.model.to(self.device).eval()
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=cfg.opt.lr, eps=1e-8)
        self.logger = logger or MetricLogger()
        self._lr = cfg.opt.lr
        self._epochs_done = 0
        # the VAE samples in training and, with eval.vae_sample, in eval
        self.vae_sample = True
        # ReduceLROnPlateau analogue; its counters survive per-epoch fit calls.
        self._best_auc = -np.inf
        self._since_best = 0
        # The fused ghost-BN kernels need the sts_gcn encoder, the linear
        # projector, no dropout and an encoder-only variant (as JAX's); 'auto'
        # falls back to the module path otherwise, 'on' refuses.
        self._fused_compat = (
            cfg.run.fused_train != "off"
            and cfg.model.encoder_type == "sts_gcn"
            and cfg.model.projector == "linear"
            and cfg.model.dropout == 0
            and not cfg.model.use_decoder
        )
        if cfg.run.fused_train == "on" and not self._fused_compat:
            raise ValueError(
                "fused_train='on' requires sts_gcn encoder, linear projector, "
                "dropout 0 and an encoder-only variant")
        self.train_ds = train_ds
        self.val_ds = val_ds
        self.ground_truths = ground_truths or {}
        self.trans_table = torch.as_tensor(
            canonical_transforms(max(cfg.data.num_transform, 1)), device=self.device)
        self.batch_size = cfg.data.batch_size
        # The transform table has cfg.data.num_transform rows while the index
        # stream spans len(ds) = N * ds.num_transform: refuse a mismatch
        # rather than gather a wrong matrix. num_transform=1 (raw serving
        # windows) stays valid: every transform index is 0, the identity.
        for name, ds in (("train", train_ds), ("validation", val_ds)):
            k = getattr(ds, "num_transform", None)
            if ds is not None and k not in (None, 1, cfg.data.num_transform):
                raise ValueError(
                    f"{name} dataset carries num_transform={k} but the config "
                    f"says {cfg.data.num_transform}; rebuild the dataset with "
                    "the config's transform count")
        self.train_data = self._device_data(train_ds)
        self.val_data = self._device_data(val_ds) if val_ds is not None else None

    def init_state(self) -> TrainState:
        """A fresh state: step 0, zero center, identity inverse covariance,
        empty accumulators. The weights are the model's (drawn from
        cfg.run.seed at construction) and the optimizer's state is its own."""
        return init_state(self.cfg.model.latent_dim, self.device)

    def schedule_state(self) -> dict:
        """Host-side schedule state a resumed run needs: the global epoch
        counter and the plateau reducer's counters."""
        return {
            "epochs_done": int(self._epochs_done),
            "plateau_best_auc": float(self._best_auc),
            "plateau_since_best": int(self._since_best),
        }

    def restore_schedule_state(self, extra: dict) -> None:
        """Counterpart of schedule_state(); falls back to extra['epoch'] + 1
        for a record without the epoch counter."""
        if "epochs_done" in extra:
            self._epochs_done = int(extra["epochs_done"])
        elif "epoch" in extra:
            self._epochs_done = int(extra["epoch"]) + 1
        self._best_auc = float(extra.get("plateau_best_auc", -np.inf))
        self._since_best = int(extra.get("plateau_since_best", 0))

    def _fused_usable(self, batch: torch.Tensor) -> bool:
        return self._fused_compat and batch.shape[0] % self.cfg.run.ghost_size == 0

    def _generator(self, *key: int) -> torch.Generator:
        """A generator on the device seeded from (cfg.run.seed, *key)."""
        seed = np.random.SeedSequence((self.cfg.run.seed, *key)).generate_state(1, np.uint64)[0]
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _forward(self, batch: torch.Tensor, train: bool, frozen_bn: bool = False,
                 generator: Optional[torch.Generator] = None, vae_draws=None,
                 dropout_generator: Optional[torch.Generator] = None):
        """The model's outputs for a batch; in train mode through the
        ghost-BN kernels when usable (running statistics updated in place
        either way). The VAE samples where `vae_sample` and (train or
        eval.vae_sample) hold, from fed `vae_draws` or from `generator`;
        train-mode dropout draws from `dropout_generator`."""
        if train and not frozen_bn and self._fused_usable(batch):
            return stse_train.fused_stse_apply(
                self.model, batch, ghost_size=self.cfg.run.ghost_size,
                compute_dtype=self.cfg.run.compute_dtype)
        if not self.cfg.model.use_vae:
            return self.model(batch, train=train, frozen_bn=frozen_bn,
                              dropout_generator=dropout_generator)
        sample = self.vae_sample and (train or self.cfg.eval.vae_sample)
        return self.model(batch, train=train, frozen_bn=frozen_bn, sample=sample,
                          sample_draws=vae_draws, generator=generator,
                          dropout_generator=dropout_generator)

    def _samples(self) -> bool:
        return self.cfg.model.use_vae and self.vae_sample

    def _set_lr(self, lr: float) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    def train_step(self, state: TrainState, data: torch.Tensor, indices: torch.Tensor,
                   frozen_bn: bool = False, vae_draws=None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimizer step on the batch of logical `indices`: forward,
        loss, backward, optimizer step, then the epoch accumulators from the
        step's latents (taken before the update; the VAE's posterior means
        where eval.vae_sample is off, as they are what it scores)."""
        cfg = self.cfg
        if cfg.opt.contrastive_weight > 0:
            raise NotImplementedError(
                "the contrastive second view is not ported yet (ROADMAP.md, Queue 1 item 4)")
        batch = self._gather(data, indices)
        gen = self._generator(state.step) if self._samples() and vae_draws is None else None
        dgen = self._generator(state.step, 0x60) if cfg.model.dropout > 0 else None
        out = self._forward(batch, train=True, frozen_bn=frozen_bn, generator=gen,
                            vae_draws=vae_draws, dropout_generator=dgen)
        loss, metrics = objectives.compute_loss(
            cfg, out, batch, self.model, state.center, state.inv_cov,
            mean_vector=state.mean_vector)
        z = objectives.latent_of(cfg.model.variant, out)
        if cfg.model.use_vae and not cfg.eval.vae_sample:
            z = out[2][0]
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        acc = objectives.accumulate_stats(
            (state.acc_vec, state.acc_weight, state.acc_outer), cfg.model.variant,
            cfg.model.distance, z, state.center)
        state = state.replace(step=state.step + 1, acc_vec=acc[0], acc_weight=acc[1],
                              acc_outer=acc[2])
        return state, {k: v.detach() for k, v in metrics.items()}

    def train_epoch(self, state: TrainState, data: torch.Tensor, indices: torch.Tensor,
                    frozen_bn: bool = False) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """Train steps over [K, B] index chunks; metrics stacked to [K]."""
        steps = []
        for i in range(indices.shape[0]):
            state, metrics = self.train_step(state, data, indices[i], frozen_bn=frozen_bn)
            steps.append(metrics)
        return state, {k: torch.stack([m[k] for m in steps]) for k in steps[0]}

    def _device_data(self, ds: SegmentDataset) -> torch.Tensor:
        """Windows flat [N, C*T*V] on the device; `_gather` reshapes."""
        n = ds.data.shape[0]
        return torch.as_tensor(
            np.ascontiguousarray(ds.data.reshape(n, -1), np.float32), device=self.device)

    @staticmethod
    def _window_shape_of(ds):
        data = getattr(ds, "data", None)
        return None if data is None else tuple(data.shape[1:])

    def _gather(self, data: torch.Tensor, indices: torch.Tensor, window_shape=None):
        ws = tuple(window_shape or self.train_ds.data.shape[1:])
        if data.dim() == 2 and data.shape[1] != int(np.prod(ws)):
            raise ValueError(
                f"flat window data has {data.shape[1]} features but window_shape "
                f"{ws} expects {int(np.prod(ws))}; pass the owning dataset's window "
                "shape to _gather/embed_all/score_all")
        return gather_batch(data, indices, self.trans_table, self.cfg.model.num_coords,
                            window_shape=ws)

    def _chunked_indices(self, n: int) -> Tuple[torch.Tensor, int]:
        """[K, B] index chunks with the tail wrap-padded (index i % n), and
        K. A pass smaller than one batch runs as one chunk of n rows: eval
        rows are independent, so nothing needs the padding."""
        if n < 1:
            raise ValueError("nothing to score: the dataset has no windows")
        bs = min(self.batch_size, n)
        k = (n + bs - 1) // bs
        idx = torch.remainder(torch.arange(k * bs, device=self.device), n)
        return idx.reshape(k, bs), k

    def _embed_step(self, data, indices, window_shape=None, generator=None
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Eval-mode latents for one batch of logical indices, and for the
        decoder variants each window's reconstruction MSE (else None)."""
        batch = self._gather(data, indices, window_shape=window_shape)
        out = self._forward(batch, train=False, generator=generator)
        z = objectives.latent_of(self.cfg.model.variant, out)
        if not self.cfg.model.use_decoder:
            return z, None
        return z, torch.mean((out[1] - batch) ** 2, dim=(1, 2, 3))

    def _eval_pass(self, state: TrainState, ds: SegmentDataset, data: torch.Tensor, fn):
        """fn(z) over every (window x transform) item of ds in batches:
        (values [n], reconstruction errors [n], zeros for encoder-only
        variants), as numpy. A sampling VAE draws from a generator seeded
        from the state's step."""
        n = len(ds)
        idx, k = self._chunked_indices(n)
        ws = self._window_shape_of(ds)
        gen = (self._generator(state.step, 7)
               if self._samples() and self.cfg.eval.vae_sample else None)
        vals, recs = [], []
        for i in range(k):
            z, rec = self._embed_step(data, idx[i], ws, generator=gen)
            vals.append(fn(z))
            recs.append(rec)
        rec = (np.zeros(n, np.float32) if recs[0] is None
               else torch.cat(recs)[:n].cpu().numpy())
        return torch.cat(vals)[:n].cpu().numpy(), rec

    @torch.inference_mode()
    def embed_all(self, state: TrainState, ds: SegmentDataset, data: torch.Tensor,
                  return_rec: bool = False):
        """Latents for every (window x transform) item, as numpy [n, D] (and
        the reconstruction errors [n], zeros for encoder-only variants)."""
        z, rec = self._eval_pass(state, ds, data, lambda z: z)
        return (z, rec) if return_rec else z

    @torch.inference_mode()
    def score_all(self, state: TrainState, ds: SegmentDataset, data: torch.Tensor):
        """Anomaly scores for every (window x transform) item: ([n] scores,
        [n] reconstruction errors, zeros for encoder-only variants) as numpy."""
        return self._eval_pass(state, ds, data, lambda z: objectives.window_scores(
            self.cfg, z, state.center, state.inv_cov, state.mean_vector))

    def initialize_center(self, state: TrainState) -> TrainState:
        """Full eval-mode pass over the train set. Euclidean, autoencoder and
        VAE: center = clamp(mean(z)), the mean taken in float64. Hyperbolic:
        the Einstein midpoint of the exp-mapped latents, which must lie
        inside the ball. Mahalanobis also inverts the latent covariance
        around the center."""
        variant = self.cfg.model.variant
        z = self.embed_all(state, self.train_ds, self.train_data)
        if variant == "hyperbolic":
            z_h = hyp.project(hyp.expmap0(torch.as_tensor(z, device=self.device)))
            c = hyp.midpoint_from_stats(*hyp.streaming_midpoint_stats(z_h))
            if not bool(torch.all(torch.abs(c) < 1.0)):
                raise ValueError("hyperbolic center left the Poincaré ball")
        else:
            c = torch.as_tensor(z.mean(axis=0, dtype=np.float64), dtype=torch.float32)
            c = clamp_center(c, self.cfg.opt.center_tolerance).to(self.device)
        state = state.replace(center=c)
        if self.cfg.model.distance == "mahalanobis":
            d = z - c.cpu().numpy()
            cov = self._shrink_cov((d.T @ d) / (len(z) - 1))
            state = state.replace(inv_cov=torch.as_tensor(
                np.linalg.inv(cov), dtype=torch.float32, device=self.device))
        return state

    def _shrink_cov(self, cov):
        """Optional shrinkage toward mu*I (mu = trace/d) before inverting;
        opt.cov_shrinkage = 0 (default) keeps the raw covariance. Takes a
        numpy array or a tensor."""
        lam = self.cfg.opt.cov_shrinkage
        if lam <= 0.0:
            return cov
        d = cov.shape[-1]
        if isinstance(cov, torch.Tensor):
            eye = torch.eye(d, dtype=cov.dtype, device=cov.device)
            return (1.0 - lam) * cov + lam * (torch.trace(cov) / d) * eye
        return (1.0 - lam) * cov + lam * (np.trace(cov) / d) * np.eye(d, dtype=cov.dtype)

    def apply_epoch_updates(self, state: TrainState) -> TrainState:
        """End of an epoch: euclidean_dynamic's center becomes the epoch's
        latent mean (clamped), the hyperbolic center the midpoint of the
        epoch's ball points; Mahalanobis inverts the epoch's covariance.
        Then the accumulators restart."""
        if self.cfg.model.variant == "euclidean_dynamic":
            c = clamp_center(state.acc_vec / state.acc_weight, self.cfg.opt.center_tolerance)
            state = state.replace(center=c)
        elif self.cfg.model.variant == "hyperbolic":
            state = state.replace(center=hyp.midpoint_from_stats(state.acc_vec,
                                                                 state.acc_weight))
        if self.cfg.model.distance == "mahalanobis":
            cov = state.acc_outer / (state.acc_weight - 1.0)
            state = state.replace(inv_cov=torch.linalg.inv(self._shrink_cov(cov)))
        return state.reset_accumulators()

    def update_mean_vector(self, state: TrainState) -> TrainState:
        """The VAE's scoring anchor: the epoch's latent mean (the other
        variants have none)."""
        if self.cfg.model.variant != "vae":
            return state
        return state.replace(mean_vector=state.acc_vec / state.acc_weight)

    def fit(self, state: Optional[TrainState] = None, epochs: Optional[int] = None
            ) -> Tuple[TrainState, Dict]:
        """Train for `epochs` (default cfg.opt.epochs) from `state` (default:
        a fresh state with the center initialized). Each epoch shuffles with
        np.random.default_rng((seed, epoch)) and drops the tail that does not
        fill a batch; then validation (every run.validate_every epochs, with
        the plateau reducer unless a named lr schedule owns the lr) and the
        epoch-end center/covariance updates."""
        cfg = self.cfg
        epochs = epochs if epochs is not None else cfg.opt.epochs
        if state is None:
            state = self.initialize_center(self.init_state())
        n = len(self.train_ds)
        bs = min(self.batch_size, max(n, 1))
        steps_per_epoch = max(n // bs, 1)
        history = {"validation_auc": [], "loss": []}
        schedule = (schedulers.build_schedule(cfg.opt.lr_schedule, cfg.opt.lr, cfg.opt.epochs,
                                              cfg.opt.lr_decay)
                    if cfg.opt.lr_schedule else None)
        for local_epoch in range(epochs):
            epoch = self._epochs_done + local_epoch
            if schedule is not None:
                self._lr = float(schedule(epoch))
                self._set_lr(self._lr)
            perm = np.random.default_rng((cfg.run.seed, epoch)).permutation(n)
            flat = perm[np.arange(steps_per_epoch * bs) % n]
            idx = torch.as_tensor(flat.reshape(steps_per_epoch, bs), device=self.device)
            frozen = cfg.run.freeze_bn_after >= 0 and epoch >= cfg.run.freeze_bn_after
            self.model.train()
            try:
                state, metrics = self.train_epoch(state, self.train_data, idx, frozen_bn=frozen)
            finally:
                self.model.eval()
            metrics = {k: v.cpu().numpy() for k, v in metrics.items()}  # [K]
            for step in range(steps_per_epoch):
                global_step = epoch * steps_per_epoch + step + 1
                if global_step % self.logger.every_n_steps == 0:
                    self.logger.log({k: float(v[step]) for k, v in metrics.items()}, global_step)
            history["loss"].append(float(metrics["loss"].mean()))

            state = self.update_mean_vector(state)
            result = None
            if cfg.opt.validation and (epoch + 1) % cfg.run.validate_every == 0:
                result = self.validate(state)
            if result is not None:
                auc = result.auc
                history["validation_auc"].append(auc)
                self.logger.log({"validation_auc": auc, "epoch": epoch}, state.step, force=True)
                if schedule is not None:
                    pass
                elif auc > self._best_auc:
                    self._best_auc, self._since_best = auc, 0
                else:
                    self._since_best += 1
                    if self._since_best > cfg.opt.plateau_patience:
                        # reduce from the live lr, which a resumed run also has
                        live = float(self.optimizer.param_groups[0]["lr"])
                        self._lr = max(live * cfg.opt.plateau_factor, cfg.opt.min_lr)
                        self._set_lr(self._lr)
                        self._since_best = 0
            state = self.apply_epoch_updates(state)
            if cfg.model.variant == "hyperbolic":
                # the center's euclidean norm and its geodesic distance from
                # the origin, as the reference logs them at epoch end
                c = state.center
                self.logger.log({"center/eucl": float(torch.linalg.vector_norm(c)),
                                 "center/hyp": float(hyp.dist0(c))}, state.step, force=True)
        self._epochs_done += epochs
        return state, history

    def validate(self, state: TrainState) -> Optional[EvalResult]:
        """Frame-level AUC of the validation set under the current center;
        the autoencoder's windows are scored by reconstruction error, as the
        reference validates it (its offline eval scores by latent distance)."""
        if self.val_ds is None or not self.ground_truths:
            return None
        scores, rec = self.score_all(state, self.val_ds, self.val_data)
        if self.cfg.model.variant == "autoencoder":
            scores = rec
        k = max(self.cfg.data.num_transform, 1)
        avenue_masks = (
            AVENUE_MASKED_CLIPS if self.cfg.data.dataset_choice == "HR-Avenue" else {})
        # Metadata is identical across the k transforms (scores are
        # transform-major), so pass the base arrays once.
        return evaluate_windows(
            scores, None, self.val_ds.meta, self.val_ds.frame_ids, self.ground_truths,
            ScoringConfig(num_transform=k, pad_size=self.cfg.eval.pad_size),
            avenue_clip_masks=avenue_masks,
        )
