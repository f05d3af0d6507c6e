#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (coskad_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing a line before the last:
  1. environment: the card's name and power limit (nvidia-smi), torch and
     CUDA versions; builds every kernel of the port from csrc/ with nvcc,
     one process per source, all at once.
  2. kernel: K1 (eval encoder) against its plain PyTorch version on the
     card, in fp32 and in float64, at the serving path's shapes (full
     width, B=2048, a ragged B=2047 and a batch of one block and one
     window more), on a one-layer identity-residual stack and on a stack
     whose last layer narrows (16 -> 8 channels, 35 nodes); each case
     launched twice gives the same bits; times kernel and plain version,
     and each flagship layer alone with its windows a block, shared bytes
     and blocks an SM (the `K1 layers` line); STSE.forward(train=False)
     with grad mode on raises (K1 has no backward).
  3. train kernels: K2 (ghost-BN forward), K3 (a lower layer's backward)
     and K4 (the top layer's backward with the projector's) against their
     plain versions on the card: full width at B=2048 ghost 64, B=96 ghost
     32, a one-layer identity-residual stack, a stack whose last layer
     narrows with 35 nodes. Times each kernel and its plain version; K2,
     K4 and K3 launched twice on the same inputs give the same bits; per
     flagship layer the device ms of the per-window passes bwd_pre and
     bwd_dx (a profiler trace of one K3/K4 call) and each pass's shared
     bytes and blocks an SM (the top layer's bwd_dx needs two); likewise
     K2's passes fwd_pre, fwd_stats, fwd_sums, fwd_apply and the
     projector's (a trace of one K2 call). Product
     check: each of the 13 batch-reduction products of a step (dW, dW_res,
     dM a layer, dwp), alone through stse_train.product, at B=2048 and at
     K5's 128-window chunk, against float64 einsum on the card, with its
     ms, its bound (3xTF32 on the tensor cores, or bytes) and the time of
     one fp32 torch.mm / einsum call (TF32 off); `--only products` runs
     just this check.
  3b. mono: K5 (the mono backward, from x and dz alone) against its plain
     version in float64 and against the split kernels (K4, then K3) on the
     same inputs, on the train-kernel cases plus a batch whose last chunk
     is ragged and chunks of one ghost block; K5's time beside K2 and K4 +
     K3, its plain version's, and over chunk sizes with the workspace of
     each. Then the mono path: 20 steps of fused_stse_apply(bwd_mode=
     "mono") + Adam at B=2048 ghost 64 against 20 split steps from the same
     weights (per-step losses, K5 launched once a step, K3/K4 never); the
     step time of each mode, in turns; the peak memory of one step of each
     (mono also at K5 chunks of 512 and 1024 windows) and the bytes it
     saves for backward.
  3c. probe: the bf16 operand probes (P), one kernel per job of
     scripts/probe_mosaic.py, each against its plain version and timed.
  4. slice (serving): the serving path at the flagship width (sts_gcn
     2->32->16->32->64, latent 16, windows [2, 12, 18], 5 transforms, batch
     2048, fp32) with random weights from a seed: Trainer.initialize_center
     and score_all over 40,000 resident windows x 5 transforms, validate's
     frame AUC on synthetic ground truth, AnomalyScorer.score_clip_json on
     an AlphaPose clip. Launch counts, scores against the plain CPU path on
     a subset, a per-stage breakdown and a profiler trace.
  5. train (training): Trainer.fit for 3 epochs with fused_train='on',
     ghost 64, batch 2048 over the same 40,000 windows x 5 transforms, with
     validation; steady train windows/s, launch counts (K2/K3/K4 97/291/97
     an epoch, K1 in validate), finite losses and running statistics; three
     steps of a 256-window subset against the plain CPU path; a per-stage
     breakdown of one step, the live-BN (fused_train='off') step for
     context, and the profiler's idle share over one epoch, flagged where
     its K2-K4 kernel time is more than 10% off their CUDA-event times.
  6. a JSON line of every kernel (launches on the main paths, error, times,
     bound), then the last line {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no result.
It imports nothing of JAX or of the JAX package. TF32 is switched off for
matmuls and cuDNN: it would cost ~1e-3 of accuracy against the fp32
reference. Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): fp32 outside the tensor cores and
# HBM3 bandwidth, at the full 700 W power limit.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12  # tensor cores: the least time for the bf16 probes
PEAK_BYTES_PER_S = 3.35e12
# TF32 on the tensor cores, dense: the batch-reduction products run as 3xTF32
# (three TF32 products for each fp32 one), so their least time is 3 FLOPs
# over this rate
PEAK_TF32_FLOPS = 495e12
TOL = dict(rtol=2e-4, atol=2e-5)  # kernel vs plain: fp32 reassociation
# K2 vs plain (tests/test_fused_train_kernel.py:50-58): ghost statistics sum
# 13,824 rows per channel in another order
TRAIN_TOL = dict(rtol=2e-4, atol=2e-4)
# K3/K4 gradients vs plain: err < 1e-3 * max(scale, 1) + 1e-6
# (test_fused_train_kernel.py:84-91, fp32 reassociation through the BN
# backward's 1/cnt cancellations)
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-6
LOSS_RTOL = 1e-3  # per-step losses vs the CPU path (test_lockstep_parity.py:538)
TRAIN_EPOCHS = 3
TRAIN_BATCH = 2048
FULL = dict(input_dim=2, layer_channels=(32, 16, 32), hidden_dimension=64, latent_dim=16,
            n_frames=12, n_joints=18)
# (label, model, batch, ghost) of the K2-K4 checks; the first is timed
TRAIN_KERNEL_CASES = (
    ("full_B2048_ghost64", FULL, 2048, 64),
    ("full_B96_ghost32", FULL, 96, 32),
    ("identity_residual_B64_ghost16", dict(input_dim=8, layer_channels=(), hidden_dimension=8,
                                           latent_dim=4, n_frames=6, n_joints=5), 64, 16),
    ("narrowing_last_layer_B64_ghost16", dict(input_dim=2, layer_channels=(16,),
                                              hidden_dimension=8, latent_dim=4, n_frames=5,
                                              n_joints=7), 64, 16),
)
# (label, model, batch, ghost, chunk windows) of K5's own extra checks
MONO_EXTRA_CASES = (
    ("full_B320_ghost64_ragged_last_chunk", FULL, 320, 64, 128),  # chunks 128, 128, 64
    ("full_B256_ghost64_one_block_chunks", FULL, 256, 64, 64),  # 4 chunks of one block
)
# batch sizes of the product check: the training step's and K5's default chunk
PRODUCT_BATCHES = (2048, 128)
MONO_STEPS = 20
MONO_CHUNK_SWEEP = (64, 128, 256, 512, 1024, 2048)  # windows, at B=2048 ghost 64
MONO_PEAK_CHUNKS = (512, 1024)  # a mono step's peak memory also at these chunks
# probes: elementwise jobs are exact; sums of up to 16,384 exact bf16
# products in f32, in another order than the plain version's
PROBE_SUM_TOL = dict(rtol=1e-5, atol=2e-3)
SCORE_TOL = dict(rtol=1e-3, atol=1e-6)  # scores square latent differences
DEVICE = "cuda"
# csrc/stse_train.cu's kernels, as the profiler names them: K2-K4's device time
# in an epoch trace
FORWARD_PASSES = ("fwd_pre_kernel", "fwd_stats_kernel", "fwd_sums_kernel", "fwd_apply_kernel",
                  "projector_z_kernel", "projector_sum_kernel")
TRAIN_KERNELS = (*FORWARD_PASSES, "transpose_kernel", "projector_dy_kernel", "bwd_pre_kernel",
                 "bwd_consts_kernel", "bwd_reduce_kernel", "bwd_dx_kernel", "product_rows_kernel",
                 "product_windows_kernel", "sum_splits_kernel")
TRAIN_CLIPS, VAL_CLIPS = 100, 20  # x 2 actors x 200 windows: 40,000 and 8,000 windows
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def within(a, b, rtol, atol) -> bool:
    import torch

    return bool(torch.all((a - b).abs() <= atol + rtol * b.abs()))


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` launches, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_of(flops, nbytes, peak_flops=PEAK_FP32_FLOPS):
    """(bound ms, what bounds it): the larger of operations over the peak
    rate and bytes over the memory rate."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def seeded_train_stse(gen, device, **kw):
    """STSE with torch-default weights from `gen`, BN affines and PReLU
    slopes jittered (`jitter_affine`), on `device`."""
    from coskad_tpu_torch.models import STSE

    model = STSE(**kw)
    model.reset_parameters(gen)
    jitter_affine(model, gen)
    return model.to(device)


def seeded_stse(gen, device, **kw):
    """STSE with torch-default weights from `gen` and non-trivial running
    BatchNorm statistics, in eval mode on `device`."""
    import torch
    from coskad_tpu_torch.models import STSE

    model = STSE(**kw)
    model.reset_parameters(gen)
    jitter_bn(model, gen)
    return model.to(device).eval()


def jitter_bn(model, gen):
    import torch

    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith(".mean"):
                buf.copy_(torch.empty(buf.shape).uniform_(-0.5, 0.5, generator=gen))
            elif name.endswith(".var"):
                buf.copy_(torch.empty(buf.shape).uniform_(0.5, 2.0, generator=gen))


def phase_environment():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0].strip()
    print(card)
    print(f"environment: python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s), "
          f"device 0 {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from coskad_tpu_torch.kernels import build

    t0 = time.perf_counter()
    libs = build.build_all()
    build_s = time.perf_counter() - t0
    regs = [line.strip() for k in build.KERNELS for line in build.ptxas_report(k).splitlines()
            if "registers" in line or "spill" in line]
    print(f"build: {len(libs)} kernel librar{'y' if len(libs) == 1 else 'ies'} in "
          f"{build_s:.1f} s; ptxas: {' | '.join(regs)}")
    return card, build_s


def folded_f64(folded):
    """The folded weights in float64, for the plain version's float64 run."""
    from coskad_tpu_torch.kernels import stse_fused

    return stse_fused.FoldedSTSE(
        [stse_fused.FoldedLayer(*(t.double() for t in lay)) for lay in folded.layers],
        folded.w_proj.double(), folded.b_proj.double())


def phase_kernel(card):
    """K1 against its plain version on the card, in fp32 and float64, and
    launched twice for the same bits; each flagship layer's time alone with
    its windows a block, shared bytes and blocks an SM. Returns its kernel
    record."""
    import torch
    from coskad_tpu_torch.kernels import stse_fused

    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(1234)
    full = dict(input_dim=2, layer_channels=(32, 16, 32), hidden_dimension=64,
                latent_dim=16, n_frames=12, n_joints=18)
    model = seeded_stse(gen, dev, **full)
    folded, packed = model.folded()
    occupancy = stse_fused.occupancy(packed)
    wb = occupancy["windows_per_block"]
    cases = []
    x_main = None
    for label, kw, batch in (("full_B2048", full, 2048), ("full_B2047", full, 2047),
                             (f"full_B{wb + 1}_ragged_block", full, wb + 1),
                             ("identity_residual_B64",
                              dict(input_dim=8, layer_channels=(8,), hidden_dimension=8,
                                   latent_dim=4, n_frames=6, n_joints=5), 64),
                             ("narrowing_last_layer_B64",
                              dict(input_dim=2, layer_channels=(16,), hidden_dimension=8,
                                   latent_dim=4, n_frames=5, n_joints=7), 64)):
        m = model if kw is full else seeded_stse(gen, dev, **kw)
        f, p = m.folded()
        x = torch.randn(batch, kw["input_dim"], kw["n_frames"], kw["n_joints"],
                        generator=gen).to(dev)
        with torch.no_grad():
            h_k = stse_fused.fused_stse_hidden(x, f, p)
            h_again = stse_fused.fused_stse_hidden(x, f, p)
            h_r = stse_fused.fused_stse_hidden_reference(x, f)
            h_64 = stse_fused.fused_stse_hidden_reference(x.double(), folded_f64(f))
            z_k = stse_fused.fused_stse_forward(x, f, p)
            z_r = stse_fused.fused_stse_forward_reference(x, f)
        torch.cuda.synchronize()
        err_h = float((h_k - h_r).abs().max())
        err_64 = float((h_k.double() - h_64).abs().max())
        err_z = float((z_k - z_r).abs().max())
        same_bits = torch_equal(h_k, h_again)
        ok = (within(h_k, h_r, **TOL) and within(h_k.double(), h_64, **TOL)
              and within(z_k, z_r, **TOL) and bool(torch.isfinite(h_k).all()))
        cases.append(dict(case=label, batch=batch, max_abs_err_hidden=err_h,
                          max_abs_err_hidden_f64=err_64, max_abs_err_latent=err_z,
                          same_bits_twice=same_bits, ok=ok))
        check(ok, f"stse_fused {label}: kernel vs plain max abs err hidden {err_h:.3e} "
                  f"(float64 {err_64:.3e}), latent {err_z:.3e} outside rtol {TOL['rtol']} "
                  f"atol {TOL['atol']}")
        check(same_bits, f"stse_fused {label}: two launches gave different bits")
        if label == "full_B2048":
            x_main = x

    # K1 has no backward: the eval forward on the card raises where autograd
    # would record it, rather than return a latent cut from the graph.
    try:
        model(x_main[:4])
        raised = ""
    except RuntimeError as e:
        raised = str(e)
    check("no_grad" in raised, "STSE.forward(train=False) with grad mode on did not raise on the "
                               "card")
    with torch.no_grad():
        kernel_ms = cuda_ms(lambda: stse_fused.fused_stse_hidden(x_main, folded, packed))
        plain_ms = cuda_ms(lambda: stse_fused.fused_stse_hidden_reference(x_main, folded))
        kernel_ms_2 = cuda_ms(lambda: stse_fused.fused_stse_hidden(x_main, folded, packed))
        plain_ms_2 = cuda_ms(lambda: stse_fused.fused_stse_hidden_reference(x_main, folded))
        per_layer_ms, layers = {}, {}
        for lay in folded.layers:  # each layer alone, as a one-layer stack
            one = folded._replace(layers=[lay])
            one_packed = stse_fused.pack_folded(one)
            x1 = torch.randn(2048, lay.w.shape[0], 12, 18, generator=gen).to(dev)
            name = "{}->{}".format(*lay.w.shape)
            per_layer_ms[name] = cuda_ms(lambda: stse_fused.fused_stse_hidden(x1, one, one_packed))
            layers[name] = dict(ms=per_layer_ms[name], **stse_fused.occupancy(one_packed))
    flops, nbytes = stse_fused.work(folded, 2048)
    # every FLOP runs on the tensor cores as 3xTF32: three TF32 products for each
    bound_ms, bound_by = bound_of(3.0 * flops, nbytes, PEAK_TF32_FLOPS)
    rec = dict(
        name="stse_fused", route="cuda", source=stse_fused.SOURCE,
        replaces=stse_fused.REPLACES, launches=None,
        max_abs_err=max(c["max_abs_err_hidden"] for c in cases),
        tolerance=TOL, ms=min(kernel_ms, kernel_ms_2), kernel_ms=min(kernel_ms, kernel_ms_2),
        plain_ms=min(plain_ms, plain_ms_2), bound_ms=bound_ms, bound_by=bound_by,
        bound_fp32_ms=bound_of(flops, nbytes)[0], library_ms=None,
        batch=2048, flops=flops, bytes=nbytes, cases=cases, per_layer_ms=per_layer_ms,
        layers=layers, occupancy=occupancy,
        timing_runs_ms=dict(kernel=[kernel_ms, kernel_ms_2], plain=[plain_ms, plain_ms_2]),
    )
    print("kernel check: " + json.dumps(dict(
        name="stse_fused", cases=cases, eval_forward_with_grad_raises=True,
        kernel_ms=rec["kernel_ms"], plain_ms=rec["plain_ms"],
        bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
        bound_fp32_ms=rec["bound_fp32_ms"], card=card)))
    print("K1 layers: " + json.dumps(dict(stack=occupancy, layers=layers, card=card)))
    return rec


def synthetic_windows(rng, n_clips, n_actors, n_windows, seg_len, n_joints,
                      anomalous=None):
    """Random-walk skeletons windowed at stride 1: data [N, 3, T, V] (x, y,
    confidence), meta [N, 4], frame_ids [N, T], and per-clip ground truth.
    With `anomalous` = (lo, hi), actor 1 of every clip jumps in frames lo..hi."""
    n_frames = n_windows + seg_len - 1
    steps = rng.normal(scale=0.02, size=(n_clips, n_actors, n_frames, n_joints, 2))
    traj = rng.normal(scale=0.3, size=(n_clips, n_actors, 1, n_joints, 2)) + steps.cumsum(2)
    gt = np.zeros(n_frames, np.int64)
    if anomalous is not None:
        lo, hi = anomalous
        gt[lo:hi] = 1
        traj[:, 0, lo:hi] += rng.normal(scale=0.5, size=(n_clips, hi - lo, n_joints, 2))
    conf = rng.uniform(0.5, 1.0, size=traj.shape[:-1] + (1,))
    frames = np.concatenate([traj, conf], axis=-1)  # [clips, actors, F, V, 3]
    starts = np.arange(n_windows)
    win = frames[:, :, starts[:, None] + np.arange(seg_len)]  # [clips, actors, W, T, V, 3]
    data = win.reshape(-1, seg_len, n_joints, 3).transpose(0, 3, 1, 2).astype(np.float32)
    clip, actor, start = np.meshgrid(np.arange(1, n_clips + 1), np.arange(1, n_actors + 1),
                                     starts, indexing="ij")
    meta = np.stack([np.ones_like(clip), clip, actor, start + 1], -1).reshape(-1, 4)
    frame_ids = (meta[:, 3:4] + np.arange(seg_len)).astype(np.int32)
    gts = {(1, c): gt for c in range(1, n_clips + 1)}
    return data, meta.astype(np.int64), frame_ids, gts


def write_clip_json(path, rng, n_frames, n_joints=17, n_actors=2):
    clip = {}
    for pid in range(1, n_actors + 1):
        base = rng.uniform(150, 500, size=(n_joints, 2))
        frames = {}
        for f in range(1, n_frames + 1):
            base = base + rng.normal(scale=1.5, size=(n_joints, 2))
            kp = np.concatenate([base, rng.uniform(0.5, 1.0, size=(n_joints, 1))], -1)
            frames[f"{f:04d}"] = {"keypoints": kp.reshape(-1).tolist()}
        clip[str(pid)] = frames
    with open(path, "w") as f:
        json.dump(clip, f)


def phase_slice(card):
    import torch
    from coskad_tpu_torch.config import Config, DataConfig, ModelConfig, RunConfig
    from coskad_tpu_torch.data.windows import SegmentDataset
    from coskad_tpu_torch.kernels import stse_fused
    from coskad_tpu_torch.serve import AnomalyScorer
    from coskad_tpu_torch.train.loop import Trainer

    cfg = Config(
        model=ModelConfig(variant="euclidean_static", channels=(32, 16, 32), h_dim=64,
                          latent_dim=16, projector="linear"),
        data=DataConfig(seg_len=12, kp18_format=True, num_transform=5, batch_size=2048),
        run=RunConfig(seed=0),
    )
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    data, meta, fids, _ = synthetic_windows(rng, TRAIN_CLIPS, 2, 200, 12, 18)
    train_ds = SegmentDataset(data, meta, fids, num_transform=5)
    vdata, vmeta, vfids, gts = synthetic_windows(rng, VAL_CLIPS, 2, 200, 12, 18,
                                                 anomalous=(80, 130))
    val_ds = SegmentDataset(vdata, vmeta, vfids, num_transform=5)
    check(train_ds.num_windows == TRAIN_CLIPS * 400, "resident set is 400 windows a clip")
    trainer = Trainer(cfg, train_ds, val_ds=val_ds, ground_truths=gts, device=DEVICE)
    jitter_bn(trainer.model, torch.Generator().manual_seed(7))
    scorer = AnomalyScorer(cfg, None, trainer=trainer)
    clip_dir = tempfile.mkdtemp(prefix="coskad_clip_")
    clip_path = os.path.join(clip_dir, "01_0001_tracked.json")
    write_clip_json(clip_path, rng, n_frames=300)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # --- the main path, counted ---
    stse_fused.launches.value = 0
    t0 = time.perf_counter()
    state = trainer.initialize_center(trainer.init_state())
    torch.cuda.synchronize()
    center_s = time.perf_counter() - t0
    scorer.state = state
    t0 = time.perf_counter()
    scores, _ = trainer.score_all(state, train_ds, trainer.train_data)
    torch.cuda.synchronize()
    first_score_s = time.perf_counter() - t0
    result = trainer.validate(state)
    clip_scores = scorer.score_clip_json(clip_path)
    launches = {"stse_fused": stse_fused.launches.value}
    # --- end of the counted run ---

    n_items = len(train_ds)
    check(scores.shape == (n_items,) and bool(np.isfinite(scores).all())
          and bool((scores >= 0).all()), "score_all gives finite non-negative scores")
    check(bool(torch.isfinite(state.center).all()), "center is finite")
    check(result is not None and np.isfinite(result.auc) and 0.0 <= result.auc <= 1.0,
          f"validation AUC finite in [0, 1], got {None if result is None else result.auc}")
    check(clip_scores.ndim == 1 and len(clip_scores) > 0,
          "score_clip_json gives one score per frame")
    check(bool(np.isfinite(clip_scores).all()), "clip scores are finite")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the slice's main path")

    # The same scores from the plain CPU path on a subset (not counted).
    sub = SegmentDataset(data[:400], meta[:400], fids[:400], num_transform=5)
    cpu = Trainer(cfg, sub, device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in trainer.model.state_dict().items()})
    cpu_state = cpu.init_state().replace(center=state.center.cpu())
    s_gpu, _ = trainer.score_all(state, sub, trainer._device_data(sub))
    s_cpu, _ = cpu.score_all(cpu_state, sub, cpu.train_data)
    ref_err = float(np.abs(s_gpu - s_cpu).max())
    check(np.allclose(s_gpu, s_cpu, **SCORE_TOL),
          f"CUDA scores vs plain CPU path: max abs err {ref_err:.3e}")

    # Steady state: the first pass above also pays each kernel's first-launch
    # cost (lazy module loading), so throughput is the best of two more.
    steady = []
    for _ in range(2):
        t0 = time.perf_counter()
        trainer.score_all(state, train_ds, trainer.train_data)
        torch.cuda.synchronize()
        steady.append(time.perf_counter() - t0)
    score_s = min(steady)
    wps = n_items / score_s
    breakdown = stage_breakdown(trainer, state, train_ds)
    breakdown["score_all_batch_host_clock"] = score_s * 1e3 / -(-n_items // cfg.data.batch_size)
    trace = device_profile(lambda: trainer.score_all(state, train_ds, trainer.train_data))
    summary = dict(
        windows=train_ds.num_windows, items=n_items, batch=cfg.data.batch_size,
        setup_s=setup_s, initialize_center_s=center_s, score_all_first_s=first_score_s,
        score_all_steady_s=steady, windows_per_s=wps, auc=result.auc,
        clip_frames=int(clip_scores.shape[0]), launches=launches,
        cpu_subset_max_abs_err=ref_err, breakdown_ms=breakdown, trace=trace, card=card,
    )
    print(f"slice: score_all {n_items} items in {score_s:.4f} s = {wps:.0f} windows/s "
          f"(steady, best of {[round(t, 4) for t in steady]} s; first pass "
          f"{first_score_s:.4f} s) on {card}; initialize_center {center_s:.3f} s; "
          f"validation AUC {result.auc:.4f}; clip frames {clip_scores.shape[0]}; "
          f"launches {launches}; CPU-subset max abs err {ref_err:.2e}")
    print("slice breakdown per 2048-window batch (ms; stages by CUDA events, batch by host "
          "clock): " + json.dumps(breakdown))
    print("slice trace of one score_all pass (torch.profiler): " + json.dumps(trace))
    return summary


def device_profile(fn):
    """Device busy time, span and idle share of one call of fn, and the
    share of device time in the port's kernels, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    check(len(events) > 0, "torch.profiler recorded no device activity")
    busy = sum(e.time_range.elapsed_us() for e in events)
    span = max(e.time_range.end for e in events) - min(e.time_range.start for e in events)
    k1 = sum(e.time_range.elapsed_us() for e in events if "stse_fused_kernel" in e.name)
    by_name = ms_by_kernel(events)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:14]
    return dict(device_busy_ms=busy / 1e3, device_span_ms=span / 1e3,
                idle_share=1.0 - busy / span, stse_fused_share_of_busy=k1 / busy,
                device_events=len(events), top_device_ms={k: v for k, v in top},
                train_kernels_ms=sum(v for k, v in by_name.items() if k in TRAIN_KERNELS))


def kernel_name(e) -> str:
    """A profiler event's kernel name, namespace and arguments cut off."""
    name = e.name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
    return name[len("void "):] if name.startswith("void ") else name


def ms_by_kernel(events) -> dict:
    """Device ms of profiler events summed by kernel name."""
    out = {}
    for e in events:
        out[kernel_name(e)] = out.get(kernel_name(e), 0.0) + e.time_range.elapsed_us() / 1e3
    return out


def traced_launches(fn) -> list:
    """(kernel name, device ms) of each launch in one call of fn, in the
    order they ran, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    return [(kernel_name(e), e.time_range.elapsed_us() / 1e3) for e in events]


def traced_ms(fn) -> dict:
    """Device ms by kernel name of one call of fn, from torch.profiler."""
    out = {}
    for name, ms in traced_launches(fn):
        out[name] = out.get(name, 0.0) + ms
    return out


def stage_breakdown(trainer, state, ds):
    """Device time of each stage of one scoring batch (CUDA events)."""
    import torch
    from coskad_tpu_torch.geometry import euclidean
    from coskad_tpu_torch.kernels import stse_fused

    idx, _ = trainer._chunked_indices(len(ds))
    ws = trainer._window_shape_of(ds)
    folded, packed = trainer.model.folded()
    with torch.inference_mode():
        batch = trainer._gather(trainer.train_data, idx[0], ws)
        hidden = stse_fused.fused_stse_hidden(batch, folded, packed)
        flat = hidden.reshape(hidden.shape[0], -1)
        z = flat @ folded.w_proj + folded.b_proj
        out = dict(
            gather=cuda_ms(lambda: trainer._gather(trainer.train_data, idx[0], ws)),
            encoder_kernel=cuda_ms(lambda: stse_fused.fused_stse_hidden(batch, folded, packed)),
            projector_matmul=cuda_ms(lambda: flat @ folded.w_proj + folded.b_proj),
            distance=cuda_ms(lambda: euclidean.mse_to_center(z, state.center)),
        )
    return out


def jitter_affine(model, gen):
    """BN affines away from (1, 0) and PReLU slopes away from 0.25, so the
    ghost-BN backward has no trivial terms."""
    import torch

    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("_bn.scale"):
                p.copy_(torch.empty(p.shape).uniform_(0.5, 1.5, generator=gen))
            elif name.endswith("_bn.bias"):
                p.copy_(torch.empty(p.shape).uniform_(-0.3, 0.3, generator=gen))
            elif name.endswith("alpha"):
                p.fill_(float(torch.empty(()).uniform_(0.1, 0.4, generator=gen)))


def grad_err(got, want) -> tuple:
    """(max abs err, whether it is inside err < GRAD_RTOL * max(scale, 1) + GRAD_ATOL)."""
    scale = max(float(want.abs().max()), 1e-6)
    err = float((got - want).abs().max())
    return err, err < GRAD_RTOL * max(scale, 1.0) + GRAD_ATOL


def products_bound(flops, prod_flops, nbytes):
    """(bound ms, what bounds it) of work whose `prod_flops` run as 3xTF32
    on the tensor cores and the rest as fp32 outside them."""
    t_ops = ((flops - prod_flops) / PEAK_FP32_FLOPS + 3.0 * prod_flops / PEAK_TF32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def phase_products(card, ops):
    """Each batch-reduction product of a split backward step (dW, dW_res and
    dM a layer, dwp), alone through stse_train.product at the flagship
    width, at B=2048 and at K5's default chunk: error against float64
    einsum on the card, kernel ms, library_ms (the same product as one fp32
    torch.mm / torch.einsum call, TF32 off; timed only, never called by the
    port) and the bound (3xTF32 FLOPs on the tensor cores or bytes). The
    operands are random: a product's cost does not depend on its values."""
    import torch
    from coskad_tpu_torch.kernels import stse_train as st

    dev = torch.device(DEVICE)
    dgen = torch.Generator(device=dev).manual_seed(97)

    def library(form, a, b):
        return torch.mm(a.t(), b) if form == "rows" else torch.einsum("wpk,wqk->pq", a, b)

    results = []
    for batch in PRODUCT_BATCHES:
        for pr in st.products(ops, batch):
            form, p, q, n, k = (pr[f] for f in ("form", "p", "q", "n", "k"))
            a = torch.randn(*((n, p) if form == "rows" else (n, p, k)), generator=dgen,
                            device=dev)
            b = torch.randn(*((n, q) if form == "rows" else (n, q, k)), generator=dgen,
                            device=dev)
            got = st.product(form, a, b)
            want = st.product_reference(form, a.double(), b.double()).float()
            torch.cuda.synchronize()
            err, ok = grad_err(got, want)
            check(ok and bool(torch.isfinite(got).all()),
                  f"product {pr['name']} at B={batch}: max abs err {err:.3e} vs float64 einsum, "
                  f"scale {float(want.abs().max()):.3e}")
            del want
            runs = dict(kernel=[], library=[])
            for _ in range(2):
                runs["kernel"].append(cuda_ms(lambda: st.product(form, a, b), iters=10, warmup=2))
                runs["library"].append(cuda_ms(lambda: library(form, a, b), iters=10, warmup=2))
            bound_ms, bound_by = products_bound(pr["flops"], pr["flops"], pr["bytes"])
            results.append(dict(
                name=pr["name"], kernel=pr["key"], batch=batch, form=form, p=p, q=q, n=n, k=k,
                splits=st.product_splits(form, p, q, n, k), max_abs_err=err,
                ms=min(runs["kernel"]), library_ms=min(runs["library"]), bound_ms=bound_ms,
                bound_by=bound_by, flops=pr["flops"], bytes=pr["bytes"], timing_runs_ms=runs))
            del a, b, got
    torch.cuda.empty_cache()
    print("product check: " + json.dumps(dict(card=card, products=[
        {k: r[k] for k in ("name", "batch", "splits", "max_abs_err", "ms", "library_ms",
                           "bound_ms", "bound_by")} for r in results])))
    return results


def phase_train_kernels(card):
    """K2, K3 and K4 against their plain versions on the card; returns their
    kernel records (launches filled in by the training phase)."""
    import torch
    from coskad_tpu_torch.kernels import stse_train as st

    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(4321)
    errs = {"K2": [], "K3": [], "K4": []}
    results, timing, work, timed = [], {}, {}, TRAIN_KERNEL_CASES[0]
    for label, kw, batch, ghost in TRAIN_KERNEL_CASES:
        model = seeded_train_stse(gen, dev, **kw)
        ops = st.detached(st.encoder_ops(model))
        # The plain versions run in float64: a channel whose spread is small
        # against its mean (layer 0 mixes only 2 input channels) loses more
        # to fp32 rounding in the plain E[t^2] - E[t]^2 than the tolerance.
        ops64 = st.detached(ops, torch.float64)
        n = kw["n_frames"] * kw["n_joints"]
        x = torch.randn(batch, n, kw["input_dim"], generator=gen).to(dev)
        dz = torch.randn(batch, kw["latent_dim"], generator=gen).to(dev)
        z, sums, acts, stats = st.ghost_forward(x, ops, ghost)
        ref = st.ghost_forward_reference(x.double(), ops64, ghost)
        z_r, sums_r, acts_r, stats_r = (ref[0].float(), *([t.float() for t in r] for r in ref[1:]))
        torch.cuda.synchronize()
        # The full-batch sums are compared as moments (sum / count), what the
        # running statistics take from them: a sum over 442,368 rows has an
        # absolute rounding error no fixed atol fits.
        cnt = batch * n
        outs = dict(z=(z, z_r), **{f"sums{l}": (a / cnt, b / cnt) for l, (a, b) in
                                   enumerate(zip(sums, sums_r))},
                    **{f"act{l}": p for l, p in enumerate(zip(acts, acts_r))},
                    **{f"stats{l}": p for l, p in enumerate(zip(stats, stats_r))})
        fwd = {k: float((a - b).abs().max()) for k, (a, b) in outs.items()}
        bad = [f"{k} err {fwd[k]:.3e}" for k, (a, b) in outs.items()
               if not (within(a, b, **TRAIN_TOL) and bool(torch.isfinite(a).all()))]
        fwd_err = max(fwd.values())
        errs["K2"].append(fwd_err)
        check(not bad, f"stse_train forward (K2) {label}: outside rtol {TRAIN_TOL['rtol']} "
                       f"atol {TRAIN_TOL['atol']}: " + "; ".join(bad))
        # Each backward kernel starts from K2's activations and statistics
        # (what the training path hands it) and the float64 cotangent of the
        # layer above, so each is held alone. The float64 reference takes
        # PReLU's branch where K2 took it (the sign of its output): a
        # pre-activation within rounding of 0 would otherwise flip between
        # the two (5 of 28 M in the top layer at B=2048), which moves dW and
        # dM by up to 0.5 without any fault in either.
        top = len(ops.layers) - 1
        x_in = [x, *acts[:-1]]
        g, dwp, dbp, dy = st.top_backward(x_in[top], acts[top], dz, ops.layers[top], stats[top],
                                          ops.wp, ops.bp, ghost, need_dx=top > 0)
        w, dwp_r, dbp_r, dy_r = st.top_backward_reference(
            x_in[top].double(), dz.double(), ops64.layers[top], ops64.wp, ops64.bp, ghost,
            need_dx=top > 0, positive=acts[top] >= 0)
        pairs = [("K4", "dwp", dwp, dwp_r), ("K4", "dbp", dbp, dbp_r)]
        if top > 0:
            pairs.append(("K4", "dx", dy, dy_r))
        pairs += [("K4", f"layer{top}.d{f}", getattr(g, f), getattr(w, f))
                  for f in st.LayerOps._fields if getattr(w, f) is not None]
        for l in reversed(range(top)):
            g, dx = st.layer_backward(x_in[l], acts[l], dy_r.float(), ops.layers[l], stats[l],
                                      ghost, need_dx=l > 0)
            w, dx_r = st.layer_backward_reference(x_in[l].double(), dy_r, ops64.layers[l], ghost,
                                                  need_dx=l > 0, positive=acts[l] >= 0)
            pairs += [("K3", f"layer{l}.d{f}", getattr(g, f), getattr(w, f))
                      for f in st.LayerOps._fields if getattr(w, f) is not None]
            if l > 0:
                pairs.append(("K3", f"layer{l}.dx", dx, dx_r))
                dy_r = dx_r
        pairs = [(k, name, a, b.float()) for k, name, a, b in pairs]
        torch.cuda.synchronize()
        bad = []
        for k, name, a, b in pairs:
            err, ok = grad_err(a, b)
            errs[k].append(err)
            if not ok or not bool(torch.isfinite(a).all()):
                bad.append(f"{k} {name} err {err:.3e} scale {float(b.abs().max()):.3e}")
        check(not bad, f"stse_train backward {label}: " + "; ".join(bad))
        results.append(dict(case=label, batch=batch, ghost=ghost, forward_max_abs_err=fwd_err,
                            forward_max_abs_err_by_output=fwd,
                            backward_max_abs_err=max(e for _, _, a, b in pairs
                                                     for e in [float((a - b).abs().max())])))
        if label == timed[0]:
            timing = time_train_kernels(st, ops, x, dz, acts_r, stats_r, ghost)
            work = st.work(ops, batch, ghost)
            repeat = repeat_bits(st, ops, x, dz, acts, stats, ghost)
            passes = pass_report(st, ops, x, dz, acts, stats, ghost)
            forward = forward_report(st, ops, x, ghost)
            timed_ops = ops
    products = phase_products(card, timed_ops)
    records = []
    for key, name in (("K2", "stse_train_forward"), ("K3", "stse_train_layer_backward"),
                      ("K4", "stse_train_top_backward")):
        parts = [k for k in work if k.startswith(key)]
        flops = sum(work[k][0] for k in parts)
        nbytes = sum(work[k][1] for k in parts)
        # K3's and K4's products, per window and batch-reduction, run on the tensor cores
        bound_ms, bound_by = products_bound(flops, sum(work[k][2] + work[k][3] for k in parts),
                                            nbytes)
        t = timing[key]
        own = [r for r in products if r["batch"] == timed[2] and r["kernel"] in parts]
        records.append(dict(
            name=name, route="cuda", source=st.SOURCE, replaces=st.REPLACES[name], launches=None,
            max_abs_err=max(errs[key]),
            tolerance=(TRAIN_TOL if key == "K2" else
                       dict(rule="err < rtol * max(max|plain|, 1) + atol", rtol=GRAD_RTOL,
                            atol=GRAD_ATOL)),
            ms=t["kernel_ms"], kernel_ms=t["kernel_ms"], plain_ms=t["plain_ms"],
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, batch=timed[2], ghost=timed[3], flops=flops, bytes=nbytes,
            per_layer_ms=t.get("per_layer"), timing_runs_ms=t["runs"],
            per_layer_bound_ms={k: products_bound(work[k][0], work[k][2] + work[k][3],
                                                  work[k][1])[0] for k in parts},
            # the bound with the per-window FLOPs at fp32 outside the tensor cores, as
            # before the per-window passes ran on them
            bound_fp32_window_ms=products_bound(flops, sum(work[k][2] for k in parts),
                                                nbytes)[0],
            repeats_bit_for_bit=repeat[key],
            **(dict(product_ms=sum(r["ms"] for r in own),
                    product_library_ms=sum(r["library_ms"] for r in own),
                    product_bound_ms=sum(r["bound_ms"] for r in own)) if own else {})))
    for r in records:
        if r["name"] == "stse_train_forward":
            r["passes"] = forward
        else:
            r["passes"] = {k: v for k, v in passes.items()
                           if v["kernel"] == ("K4" if "top" in r["name"] else "K3")}
    print("train kernel check: " + json.dumps(dict(
        cases=results, card=card, repeats_bit_for_bit=repeat,
        times={r["name"]: dict(kernel_ms=r["kernel_ms"], plain_ms=r["plain_ms"],
                               bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                               product_ms=r.get("product_ms"), per_layer_ms=r["per_layer_ms"],
                               bound_fp32_window_ms=r.get("bound_fp32_window_ms"))
               for r in records})))
    print("per-window passes (one K3/K4 call each, torch.profiler; blocks an SM by "
          "cudaOccupancyMaxActiveBlocksPerMultiprocessor): " + json.dumps(dict(card=card, **{
              k: {f: v[f] for f in v if f != "traced_ms"} for k, v in passes.items()})))
    print("forward passes (one K2 call, torch.profiler; blocks an SM by "
          "cudaOccupancyMaxActiveBlocksPerMultiprocessor): " + json.dumps(dict(card=card,
                                                                               **forward)))
    return records, products


def repeat_bits(st, ops, x, dz, acts, stats, ghost):
    """K2, K4 and K3 (each layer) launched twice on the same inputs give the
    same bits: no sum depends on the order blocks run in."""
    top = len(ops.layers) - 1
    x_of = [x] + list(acts[:-1])
    runs = {
        "K2": lambda: st.ghost_forward(x, ops, ghost),
        "K4": lambda: st.top_backward(x_of[top], acts[top], dz, ops.layers[top], stats[top],
                                      ops.wp, ops.bp, ghost, need_dx=top > 0),
        **{f"K3_layer{l}": (lambda l=l: st.layer_backward(x_of[l], acts[l], acts[l],
                                                          ops.layers[l], stats[l], ghost,
                                                          need_dx=l > 0))
           for l in range(top)}}
    out = {}
    for key, fn in runs.items():
        first, second = flat_tensors(fn()), flat_tensors(fn())
        same = all(torch_equal(a, b) for a, b in zip(first, second))
        check(same, f"{key}: two launches on the same inputs differ")
        out[key] = same
    return dict(K2=out["K2"], K4=out["K4"],
                K3=all(v for k, v in out.items() if k.startswith("K3")))


def pass_report(st, ops, x, dz, acts, stats, ghost):
    """Per flagship layer: the device ms of bwd_pre and bwd_dx (and K4's
    projector_dy) in one K4 or K3 call, from a torch.profiler trace of it
    after a warm-up call; each pass's shared bytes a block and blocks an SM
    (stse_train.pass_occupancy). The top layer's bwd_dx must fit two
    blocks an SM."""
    import torch

    top = len(ops.layers) - 1
    x_of = [x] + list(acts[:-1])
    lib = st._library()
    out = {}
    for l, lay in enumerate(ops.layers):
        if l == top:
            fn = lambda: st.top_backward(x_of[top], acts[top], dz, lay, stats[top], ops.wp, ops.bp,
                                         ghost, need_dx=top > 0)
        else:
            fn = lambda l=l: st.layer_backward(x_of[l], acts[l], acts[l], ops.layers[l], stats[l],
                                               ghost, need_dx=l > 0)
        fn()
        torch.cuda.synchronize()
        ms = traced_ms(fn)
        ci, co = lay.w.shape
        occ = st.pass_occupancy(lib, x.shape[1], ci, co)
        out[f"layer{l}"] = dict(
            kernel="K4" if l == top else "K3", ci=ci, co=co, bwd_pre_ms=ms.get("bwd_pre_kernel"),
            bwd_dx_ms=ms.get("bwd_dx_kernel"), projector_dy_ms=ms.get("projector_dy_kernel"),
            traced_ms=ms, **{k: v for k, v in occ.items() if k.startswith("bwd")})
    check(out[f"layer{top}"]["bwd_dx_blocks_per_sm"] >= 2,
          f"the top layer's bwd_dx runs {out[f'layer{top}']['bwd_dx_blocks_per_sm']} block(s) an "
          "SM, not 2")
    return out


def forward_report(st, ops, x, ghost):
    """Per flagship layer: the device ms of each of K2's passes in one K2
    call, from a torch.profiler trace of it after a warm-up call (a pass's
    l-th launch is layer l's; the projector's kernels are the top layer's),
    and each pass's shared bytes a block and blocks an SM (the forward
    fields of stse_train.pass_occupancy)."""
    import torch

    fn = lambda: st.ghost_forward(x, ops, ghost)
    fn()
    torch.cuda.synchronize()
    launches = traced_launches(fn)
    top = len(ops.layers) - 1
    out = {f"layer{l}": {} for l in range(top + 1)}
    seen = {}
    for name, ms in launches:
        l = top if name.startswith("projector") else seen.get(name, 0)
        seen[name] = seen.get(name, 0) + 1
        layer = out.setdefault(f"layer{l}", {})
        key = name.replace("_kernel", "_ms")
        layer[key] = layer.get(key, 0.0) + ms
    lib = st._library()
    for l, lay in enumerate(ops.layers):
        ci, co = lay.w.shape
        occ = st.pass_occupancy(lib, x.shape[1], ci, co)
        keep = ("fwd", "projector") if l == top else ("fwd",)
        out[f"layer{l}"].update(ci=ci, co=co, **{k: v for k, v in occ.items()
                                                 if k.startswith(keep)})
    out["k2_traced_ms"] = sum(ms for _, ms in launches)
    return out


def flat_tensors(out) -> list:
    """A wrapper's returns, lists and the gradients of LayerOps spread out."""
    return [t for item in out for t in (item if isinstance(item, (tuple, list)) else (item,))]


def torch_equal(a, b) -> bool:
    import torch

    return (a is None and b is None) or bool(torch.equal(a, b))


def time_train_kernels(st, ops, x, dz, acts, stats, ghost):
    """Kernel and plain-version times of K2, K3 (each lower layer) and K4 at
    the flagship shapes, each measured twice, in turns."""
    top = len(ops.layers) - 1
    x_of = [x] + list(acts[:-1])
    dys = {l: acts[l] for l in range(top)}  # any [B, N, C_out] cotangent times the same
    fns = {
        "K2": (lambda: st.ghost_forward(x, ops, ghost),
               lambda: st.ghost_forward_reference(x, ops, ghost)),
        "K4": (lambda: st.top_backward(x_of[top], acts[top], dz, ops.layers[top], stats[top],
                                       ops.wp, ops.bp, ghost, need_dx=True),
               lambda: st.top_backward_reference(x_of[top], dz, ops.layers[top], ops.wp, ops.bp,
                                                 ghost, need_dx=True)),
    }
    for l in range(top):
        fns[f"K3_layer{l}"] = (
            lambda l=l: st.layer_backward(x_of[l], acts[l], dys[l], ops.layers[l], stats[l],
                                          ghost, need_dx=l > 0),
            lambda l=l: st.layer_backward_reference(x_of[l], dys[l], ops.layers[l], ghost,
                                                    need_dx=l > 0))
    runs = {}
    for key, (kern, plain) in fns.items():
        a = cuda_ms(kern, iters=5, warmup=2)
        b = cuda_ms(plain, iters=5, warmup=2)
        c = cuda_ms(kern, iters=5, warmup=1)
        d = cuda_ms(plain, iters=5, warmup=1)
        runs[key] = dict(kernel=[a, c], plain=[b, d])
    out = {}
    for key in ("K2", "K4"):
        out[key] = dict(kernel_ms=min(runs[key]["kernel"]), plain_ms=min(runs[key]["plain"]),
                        runs=runs[key])
    k3 = [k for k in runs if k.startswith("K3")]
    out["K3"] = dict(kernel_ms=sum(min(runs[k]["kernel"]) for k in k3),
                     plain_ms=sum(min(runs[k]["plain"]) for k in k3),
                     per_layer={k: dict(kernel_ms=min(runs[k]["kernel"]),
                                        plain_ms=min(runs[k]["plain"])) for k in k3},
                     runs={k: runs[k] for k in k3})
    return out


def phase_mono(card, checks_only=False):
    """K5 against its float64 plain version and the split kernels; its
    times; then (unless checks_only) the mono path against the split path.
    Returns (K5's kernel record, summary)."""
    import torch
    from coskad_tpu_torch.kernels import stse_train as st

    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(2468)
    cases, errs = [], []
    timed = None
    all_cases = [(*c, None) for c in TRAIN_KERNEL_CASES] + list(MONO_EXTRA_CASES)
    for label, kw, batch, ghost, chunk in all_cases:
        model = seeded_train_stse(gen, dev, **kw)
        ops = st.detached(st.encoder_ops(model))
        n = kw["n_frames"] * kw["n_joints"]
        x = torch.randn(batch, n, kw["input_dim"], generator=gen).to(dev)
        dz = torch.randn(batch, kw["latent_dim"], generator=gen).to(dev)
        _, _, acts, stats = st.ghost_forward(x, ops, ghost)
        got = st.mono_backward(x, dz, ops, ghost, chunk)
        split = st.split_backward(x, dz, ops, acts, stats, ghost)
        # float64, PReLU's branch where K2 took it (see phase_train_kernels)
        want = st.mono_backward_reference(x.double(), dz.double(), st.detached(ops, torch.float64),
                                          ghost, positive=[a >= 0 for a in acts])
        torch.cuda.synchronize()
        names = [f"layer{l}.d{f}" for l in range(len(ops.layers)) for f in st.LayerOps._fields]
        bad, err_plain, err_split = [], 0.0, 0.0
        for name, a, w, s in zip(names + ["dwp", "dbp"], st._flatten(got), st._flatten(want),
                                 st._flatten(split)):
            if w is None:
                check(a is None and s is None, f"K5 {label} {name}: a gradient of no operand")
                continue
            e_p, ok_p = grad_err(a, w.float())
            e_s, ok_s = grad_err(a, s)
            err_plain, err_split = max(err_plain, e_p), max(err_split, e_s)
            if not (ok_p and ok_s and bool(torch.isfinite(a).all())):
                bad.append(f"{name} err vs plain {e_p:.3e} (scale {float(w.abs().max()):.3e}), "
                           f"vs split {e_s:.3e}")
        check(not bad, f"stse_train mono backward (K5) {label}: " + "; ".join(bad))
        used = st.mono_chunk(batch, ghost, chunk)
        cases.append(dict(case=label, batch=batch, ghost=ghost, chunk=used,
                          n_chunks=-(-batch // used), max_abs_err_vs_plain=err_plain,
                          max_abs_err_vs_split=err_split))
        errs.append(err_plain)
        if timed is None:
            timed = (ops, x, dz, acts, stats, ghost, n)
    ops, x, dz, acts, stats, ghost, n = timed
    timing = time_mono(st, *timed)
    flops, nbytes, prod_flops, window_flops = st.work(ops, x.shape[0], ghost)["K5"]
    bound_ms, bound_by = products_bound(flops, prod_flops + window_flops, nbytes)
    rec = dict(
        name="stse_train_mono_backward", route="cuda", source=st.SOURCE,
        replaces=st.REPLACES["stse_train_mono_backward"], launches=None, max_abs_err=max(errs),
        tolerance=dict(rule="err < rtol * max(max|plain|, 1) + atol, vs the float64 plain "
                            "version and vs K4 + K3", rtol=GRAD_RTOL, atol=GRAD_ATOL),
        ms=timing["kernel_ms"], kernel_ms=timing["kernel_ms"], plain_ms=timing["plain_ms"],
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None, batch=x.shape[0], ghost=ghost,
        bound_fp32_window_ms=products_bound(flops, prod_flops, nbytes)[0],
        chunk=st.mono_chunk(x.shape[0], ghost), flops=flops, bytes=nbytes, cases=cases,
        timing=timing)
    print("mono kernel check: " + json.dumps(dict(cases=cases, card=card, **{
        k: rec[k] for k in ("kernel_ms", "plain_ms", "bound_ms", "bound_by", "chunk")}, **{
        k: timing[k] for k in ("split_ms", "k2_ms", "kernel_workspace_bytes",
                               "kernel_peak_bytes", "chunk_sweep")})))
    return rec, None if checks_only else mono_path(card)


def time_mono(st, ops, x, dz, acts, stats, ghost, n):
    """K5, the split backward (K4 + K3) and K2 at the flagship shapes, each
    twice, in turns; K5's plain version; K5 over chunk sizes; K5's own peak
    memory beyond its inputs."""
    import torch

    fns = dict(kernel=lambda: st.mono_backward(x, dz, ops, ghost),
               split=lambda: st.split_backward(x, dz, ops, acts, stats, ghost),
               k2=lambda: st.ghost_forward(x, ops, ghost),
               plain=lambda: st.mono_backward_reference(x, dz, ops, ghost))
    runs = {k: [] for k in fns}
    for _ in range(2):
        for k, fn in fns.items():
            runs[k].append(cuda_ms(fn, iters=5, warmup=2))
    b = x.shape[0]
    sweep = {}
    for want in MONO_CHUNK_SWEEP:
        chunk = st.mono_chunk(b, ghost, want)
        ws = st.mono_workspace(ops, n, chunk, ghost)
        sweep[chunk] = dict(
            n_chunks=-(-b // chunk), workspace_bytes=4 * sum(v for v in ws.values() if v),
            kernel_ms=cuda_ms(lambda: st.mono_backward(x, dz, ops, ghost, chunk), iters=5,
                              warmup=1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    grads = st.mono_backward(x, dz, ops, ghost)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del grads
    default = sweep[st.mono_chunk(b, ghost)]
    return dict(kernel_ms=min(runs["kernel"]), plain_ms=min(runs["plain"]),
                split_ms=min(runs["split"]), k2_ms=min(runs["k2"]),
                runs_ms=runs, chunk_sweep=sweep, kernel_workspace_bytes=default["workspace_bytes"],
                kernel_peak_bytes=peak)


def mono_path(card):
    """MONO_STEPS steps of fused_stse_apply(bwd_mode="mono") + Adam at the
    flagship width, B=2048, ghost 64, against as many split steps from the
    same weights (bench_fused.py's `tm:` job, with Adam); step times in
    turns; peak memory and saved-for-backward bytes of one step of each."""
    import copy

    import torch
    from coskad_tpu_torch.kernels import stse_train as st

    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(1357)
    model0 = seeded_train_stse(gen, dev, **FULL)
    center = torch.randn(FULL["latent_dim"], generator=gen).to(dev)
    dgen = torch.Generator(device=dev).manual_seed(9)
    xs = [torch.randn(TRAIN_BATCH, FULL["input_dim"], FULL["n_frames"], FULL["n_joints"],
                      generator=dgen, device=dev) for _ in range(MONO_STEPS)]

    def steps(mode, model, opt, count, saved=None):
        """`count` train steps; `saved` (a dict) collects the bytes of every
        tensor the step keeps for its backward, once per storage."""

        def pack(t):
            if saved is not None:
                saved[(t.data_ptr(), t.numel())] = t.numel() * t.element_size()
            return t

        losses = []
        for i in range(count):
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                z = st.fused_stse_apply(model, xs[i % MONO_STEPS], ghost_size=64, bwd_mode=mode)
                loss = torch.mean((z - center) ** 2)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        return losses

    runs = {}
    counters = dict(stse_train_forward=st.forward_launches,
                    stse_train_layer_backward=st.layer_backward_launches,
                    stse_train_top_backward=st.top_backward_launches,
                    stse_train_mono_backward=st.mono_backward_launches)
    for mode in ("mono", "split"):
        model = copy.deepcopy(model0)
        opt = torch.optim.Adam(model.parameters(), lr=1e-4)
        if mode == "mono":  # --- the mono path, counted ---
            for c in counters.values():
                c.value = 0
        losses = torch.stack(steps(mode, model, opt, MONO_STEPS)).cpu().numpy()
        torch.cuda.synchronize()
        if mode == "mono":
            launches = {k: c.value for k, c in counters.items()}
            # --- end of the counted run ---
        runs[mode] = dict(model=model, opt=opt, losses=losses)
    want = dict(stse_train_forward=MONO_STEPS, stse_train_layer_backward=0,
                stse_train_top_backward=0, stse_train_mono_backward=MONO_STEPS)
    check(launches == want, f"mono path launches {launches}, expected {want}")
    mono, split = runs["mono"]["losses"], runs["split"]["losses"]
    rel = float(np.max(np.abs(mono - split) / np.abs(split)))
    check(bool(np.isfinite(mono).all()) and np.allclose(mono, split, rtol=LOSS_RTOL, atol=0.0),
          f"mono vs split per-step losses: {mono} vs {split}")
    bn = {k: (a, b) for (k, a), b in zip(runs["mono"]["model"].named_buffers(),
                                          runs["split"]["model"].buffers())}
    bad = [k for k, (a, b) in bn.items() if not within(a, b, **TRAIN_TOL)]
    check(not bad, f"running statistics after {MONO_STEPS} mono vs split steps: {bad}")

    def step_ms(mode, count=10):
        r = runs[mode]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps(mode, r["model"], r["opt"], count)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / count

    times = {"split": [], "mono": []}
    for mode in ("split", "mono", "mono", "split"):
        times[mode].append(step_ms(mode))
    memory = {}
    default_chunk = st.MONO_CHUNK_WINDOWS
    # One step of each; mono also at larger K5 chunks, to show whether K5's
    # workspace or K2's forward sets the mono step's peak.
    for key, mode, chunk in (("split", "split", None), ("mono", "mono", None),
                             *((f"mono_chunk{c}", "mono", c) for c in MONO_PEAK_CHUNKS)):
        r, saved = runs[mode], {}
        st.MONO_CHUNK_WINDOWS = chunk or default_chunk
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            steps(mode, r["model"], r["opt"], 1, saved)
            torch.cuda.synchronize()
        finally:
            st.MONO_CHUNK_WINDOWS = default_chunk
        memory[key] = dict(peak_bytes_above_resident=torch.cuda.max_memory_allocated() - base,
                           resident_bytes=base, saved_for_backward_bytes=sum(saved.values()),
                           saved_tensors=len(saved))
    summary = dict(steps=MONO_STEPS, batch=TRAIN_BATCH, ghost=64, launches=launches,
                   losses_mono=mono.tolist(), losses_split=split.tolist(),
                   loss_max_rel_err=rel, step_ms=times, memory=memory, card=card)
    print(f"mono path: {MONO_STEPS} steps of fused_stse_apply(bwd_mode='mono') + Adam at B="
          f"{TRAIN_BATCH}, ghost 64 on {card}: launches {launches}; losses vs split max rel err "
          f"{rel:.2e}; step ms (host clock, 10 steps, in turns) mono {times['mono']} split "
          f"{times['split']}; memory " + json.dumps(memory))
    return summary


def phase_probe(card):
    """P: each probe job's kernel against its plain version (elementwise
    exactly, sums within PROBE_SUM_TOL), launched once each in a counted
    run; kernel and plain times. Returns the kernel records."""
    import torch
    from coskad_tpu_torch.kernels import probe

    a, b = probe.inputs(DEVICE)
    for c in probe.launches.values():  # --- the probe run, counted ---
        c.value = 0
    outs = {job: probe.run(job, a, b) for job in probe.JOBS}
    torch.cuda.synchronize()
    launches = {job: c.value for job, c in probe.launches.items()}  # --- end ---
    records, errs = [], {}
    for job, out in outs.items():
        want = probe.plain(job, a, b)
        errs[job] = float((out - want).abs().max())
        sums = job.startswith(("dot0", "dotg", "min"))
        ok = within(out, want, **PROBE_SUM_TOL) if sums else torch.equal(out, want)
        check(ok and launches[job] == 1, f"probe {job}: max abs err {errs[job]:.3e} "
                                         f"(launches {launches[job]})")
        runs = dict(kernel=[], plain=[])
        for _ in range(2):
            runs["kernel"].append(cuda_ms(lambda: probe.run(job, a, b)))
            runs["plain"].append(cuda_ms(lambda: probe.plain(job, a, b)))
        ops, nbytes = probe.work(job)
        bound_ms, bound_by = bound_of(ops, nbytes, PEAK_BF16_FLOPS)
        replaces, what = probe.JOBS[job]
        records.append(dict(
            name=f"probe_bf16.{job}", route="cuda", source=probe.SOURCE, replaces=replaces,
            launches=launches[job], max_abs_err=errs[job],
            tolerance=PROBE_SUM_TOL if sums else "exact", ms=min(runs["kernel"]),
            kernel_ms=min(runs["kernel"]), plain_ms=min(runs["plain"]), bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None, probes=what, flops=ops, bytes=nbytes,
            timing_runs_ms=runs))
    print("probe check: " + json.dumps(dict(card=card, jobs={
        r["name"]: {k: r[k] for k in ("max_abs_err", "kernel_ms", "plain_ms", "bound_ms")}
        for r in records})))
    return records


def train_config(fused: str, batch: int = None):
    from coskad_tpu_torch.config import Config, DataConfig, ModelConfig, OptConfig, RunConfig

    return Config(
        model=ModelConfig(variant="euclidean_dynamic", channels=(32, 16, 32), h_dim=64,
                          latent_dim=16, projector="linear"),
        data=DataConfig(seg_len=12, kp18_format=True, num_transform=5,
                        batch_size=batch or TRAIN_BATCH),
        opt=OptConfig(lr=1e-4, epochs=TRAIN_EPOCHS, validation=True),
        run=RunConfig(seed=0, fused_train=fused, ghost_size=64),
    )


class QuietLogger:
    """A MetricLogger that keeps the per-step losses instead of printing."""

    every_n_steps = 1

    def __init__(self):
        self.losses = []

    def log(self, metrics, step, force=False):
        if "loss" in metrics:
            self.losses.append(float(metrics["loss"]))


def phase_train(card):
    import copy

    import torch
    from coskad_tpu_torch.data.windows import SegmentDataset
    from coskad_tpu_torch.kernels import stse_fused
    from coskad_tpu_torch.kernels import stse_train as st
    from coskad_tpu_torch.train.loop import Trainer

    rng = np.random.default_rng(1)
    t0 = time.perf_counter()
    data, meta, fids, _ = synthetic_windows(rng, TRAIN_CLIPS, 2, 200, 12, 18)
    train_ds = SegmentDataset(data, meta, fids, num_transform=5)
    vdata, vmeta, vfids, gts = synthetic_windows(rng, VAL_CLIPS, 2, 200, 12, 18,
                                                 anomalous=(80, 130))
    val_ds = SegmentDataset(vdata, vmeta, vfids, num_transform=5)
    cfg = train_config("on")
    log = QuietLogger()
    trainer = Trainer(cfg, train_ds, val_ds=val_ds, ground_truths=gts, device=DEVICE, logger=log)
    gen = torch.Generator().manual_seed(11)
    jitter_affine(trainer.model, gen)
    init_weights = copy.deepcopy(trainer.model.state_dict())
    epoch_s = []
    inner = trainer.train_epoch

    def timed_epoch(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(*args, **kwargs)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t)
        return out

    trainer.train_epoch = timed_epoch
    bn_before = {k: b.clone() for k, b in trainer.model.named_buffers()}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # --- the training path, counted ---
    counters = dict(stse_fused=stse_fused.launches, stse_train_forward=st.forward_launches,
                    stse_train_layer_backward=st.layer_backward_launches,
                    stse_train_top_backward=st.top_backward_launches)
    for c in counters.values():
        c.value = 0
    t0 = time.perf_counter()
    state = trainer.initialize_center(trainer.init_state())
    history = {"loss": [], "validation_auc": []}
    for _ in range(TRAIN_EPOCHS):
        state, hist = trainer.fit(state, epochs=1)
        for k in history:
            history[k] += hist[k]
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {k: c.value for k, c in counters.items()}
    # --- end of the counted run ---

    n_items = len(train_ds)
    steps = n_items // cfg.data.batch_size
    want = dict(stse_train_forward=steps * TRAIN_EPOCHS,
                stse_train_layer_backward=3 * steps * TRAIN_EPOCHS,
                stse_train_top_backward=steps * TRAIN_EPOCHS)
    for k, v in want.items():
        check(launches[k] == v, f"{k} launched {launches[k]} times in {TRAIN_EPOCHS} epochs, "
                                f"expected {v} ({steps} steps an epoch)")
    check(launches["stse_fused"] > 0, "K1 was not launched by initialize_center / validate")
    check(len(log.losses) == steps * TRAIN_EPOCHS and all(np.isfinite(log.losses)),
          "every train step logs a finite loss")
    check(len(history["validation_auc"]) == TRAIN_EPOCHS
          and all(0.0 <= a <= 1.0 for a in history["validation_auc"]),
          f"validation AUC each epoch in [0, 1]: {history['validation_auc']}")
    changed = [k for k, b in trainer.model.named_buffers() if not torch.equal(b, bn_before[k])]
    check(all(bool(torch.isfinite(b).all()) for b in trainer.model.buffers()),
          "running statistics are finite")
    check(len(changed) == len(bn_before), f"every BN buffer changed: {len(changed)} of "
                                          f"{len(bn_before)}")
    check(bool(torch.isfinite(state.center).all()), "center is finite")
    items_per_epoch = steps * cfg.data.batch_size
    steady_s = min(epoch_s[1:])
    train_wps = items_per_epoch / steady_s

    # Three steps of a 256-window subset on the card and on the CPU (not counted).
    sub_err = cpu_subset_check(Trainer, SegmentDataset, data, meta, fids, init_weights)

    breakdown = train_breakdown(trainer, state)
    breakdown["train_step_host_clock"] = steady_s * 1e3 / steps
    off_ms = live_bn_step_ms(Trainer, cfg, train_ds, init_weights)
    idx = torch.arange(steps * cfg.data.batch_size, device=trainer.device).reshape(steps, -1)
    trainer.model.train()
    trace = device_profile(lambda: inner(state, trainer.train_data, idx))
    trainer.model.eval()
    # The trace's time in K2-K4's kernels against the same epoch from their
    # CUDA-event times (K2, K3 a layer, K4 in the breakdown: back-to-back
    # launches, so no host gap inside them): a trace that lost events (one
    # held half the device time) is flagged.
    events_ms = steps * sum(v for k, v in breakdown.items() if k.startswith(("K2", "K3", "K4")))
    trace["train_kernels_cuda_event_epoch_ms"] = events_ms
    trace["train_kernels_over_cuda_events"] = trace["train_kernels_ms"] / events_ms
    trace["flagged"] = abs(trace["train_kernels_over_cuda_events"] - 1.0) > 0.10
    if trace["flagged"]:
        print(f"train trace FLAGGED: K2-K4's kernels {trace['train_kernels_ms']:.1f} ms against "
              f"{events_ms:.1f} ms from their CUDA-event times: read it with care")
    summary = dict(
        windows=train_ds.num_windows, items=n_items, batch=cfg.data.batch_size, ghost=64,
        steps_per_epoch=steps, epochs=TRAIN_EPOCHS, setup_s=setup_s, fit_s=fit_s,
        train_epoch_s=epoch_s, train_windows_per_s=train_wps, losses_per_epoch=history["loss"],
        validation_auc=history["validation_auc"], launches=launches,
        cpu_subset_loss_max_rel_err=sub_err, breakdown_ms=breakdown,
        live_bn_step_ms=off_ms, trace=trace, card=card)
    print(f"train: fit {TRAIN_EPOCHS} epochs x {steps} steps of {cfg.data.batch_size} "
          f"(ghost 64, fused_train='on'): {train_wps:.0f} train windows/s (steady, best of "
          f"epochs 2-{TRAIN_EPOCHS}; train_epoch {[round(t, 4) for t in epoch_s]} s) on {card}; "
          f"losses {[round(v, 6) for v in history['loss']]}; validation AUC "
          f"{[round(a, 4) for a in history['validation_auc']]}; launches {launches}; "
          f"CPU-subset loss max rel err {sub_err:.2e}")
    print("train breakdown per 2048-window step (ms; stages by CUDA events, step by host "
          "clock): " + json.dumps(breakdown) + f"; live-BN (fused_train='off') step "
          f"{off_ms:.3f} ms host clock")
    print("train trace of one epoch (torch.profiler): " + json.dumps(trace))
    return summary


def cpu_subset_check(Trainer, SegmentDataset, data, meta, fids, weights, n_win=256, steps=3):
    """The fused train step on the card and the plain one on the CPU, from
    the same weights over the same index batches: per-step losses agree."""
    import torch

    sub = (data[:n_win], meta[:n_win], fids[:n_win])
    cfg = train_config("on", batch=n_win)
    losses = {}
    idx = np.random.default_rng(5).permutation(n_win * 5)[:steps * n_win].reshape(steps, n_win)
    for dev in (DEVICE, "cpu"):
        tr = Trainer(cfg, SegmentDataset(*sub, num_transform=5), device=dev)
        tr.model.load_state_dict({k: v.to(dev) for k, v in weights.items()})
        state = tr.initialize_center(tr.init_state())
        tr.model.train()
        out = []
        for i in range(steps):
            state, m = tr.train_step(state, tr.train_data, torch.as_tensor(idx[i], device=dev))
            out.append(float(m["loss"]))
        losses[dev] = np.asarray(out)
    err = float(np.max(np.abs(losses[DEVICE] - losses["cpu"]) / np.abs(losses["cpu"])))
    check(np.allclose(losses[DEVICE], losses["cpu"], rtol=LOSS_RTOL, atol=0.0),
          f"fused train steps on the card vs the plain CPU path: losses {losses[DEVICE]} vs "
          f"{losses['cpu']}")
    return err


def train_breakdown(trainer, state):
    """Device time of each stage of one 2048-window train step (CUDA events):
    gather, K2, K3 per layer, K4, and loss + backward into the weights + Adam
    (on a copy of the model, so the trainer's weights stay as they are)."""
    import copy

    import torch
    from coskad_tpu_torch.kernels import stse_train as st
    from coskad_tpu_torch.train import objectives

    cfg = trainer.cfg
    idx = torch.arange(cfg.data.batch_size, device=trainer.device)
    model = copy.deepcopy(trainer.model)
    opt = torch.optim.Adam(model.parameters(), lr=cfg.opt.lr)
    batch = trainer._gather(trainer.train_data, idx)
    b, c, t, v = batch.shape
    x = batch.permute(0, 2, 3, 1).reshape(b, t * v, c).contiguous()
    ops = st.encoder_ops(model)
    det = st.EncoderOps(tuple(st.LayerOps(*(None if a is None else a.detach() for a in lay))
                              for lay in ops.layers), ops.wp.detach(), ops.bp.detach())
    g = cfg.run.ghost_size
    z, _, acts, stats = st.ghost_forward(x, det, g)
    dz = torch.randn_like(z)
    top = len(det.layers) - 1
    x_of = [x] + list(acts[:-1])
    out = dict(gather=cuda_ms(lambda: trainer._gather(trainer.train_data, idx), iters=10),
               K2=cuda_ms(lambda: st.ghost_forward(x, det, g), iters=10))
    for l in range(top):
        out[f"K3_layer{l}"] = cuda_ms(lambda l=l: st.layer_backward(
            x_of[l], acts[l], acts[l], det.layers[l], stats[l], g, need_dx=l > 0), iters=10)
    out["K4"] = cuda_ms(lambda: st.top_backward(x_of[top], acts[top], dz, det.layers[top],
                                                stats[top], det.wp, det.bp, g), iters=10)

    def loss_adam():
        zl = z.detach().requires_grad_(True)
        loss, _ = objectives.compute_loss(cfg, zl, batch, model, state.center, state.inv_cov)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()

    out["loss_backward_adam"] = cuda_ms(loss_adam, iters=10)
    return out


def live_bn_step_ms(Trainer, cfg, train_ds, weights, steps=10):
    """Host-clock time of one train step of the fused_train='off' path (live
    BatchNorm through the plain module path), for context."""
    import dataclasses

    import torch

    off = dataclasses.replace(cfg, run=dataclasses.replace(cfg.run, fused_train="off"))
    tr = Trainer(off, train_ds, device=DEVICE)
    tr.model.load_state_dict(weights)
    state = tr.init_state()
    idx = torch.arange(cfg.data.batch_size * (steps + 2), device=tr.device).reshape(steps + 2, -1)
    tr.model.train()
    for i in range(2):
        state, _ = tr.train_step(state, tr.train_data, idx[i])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(2, steps + 2):
        state, _ = tr.train_step(state, tr.train_data, idx[i])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("kernels", "products"), default=None,
                    help="run only the environment and kernel phases, or only the product "
                         "check (no result line)")
    args = ap.parse_args(argv)
    card, build_s = phase_environment()
    import torch

    if args.only == "products":
        from coskad_tpu_torch.kernels import stse_train as st

        model = seeded_train_stse(torch.Generator().manual_seed(4321), DEVICE, **FULL)
        phase_products(card, st.detached(st.encoder_ops(model)))
        return 0

    kernel = phase_kernel(card)
    train_kernels, products = phase_train_kernels(card)
    mono_kernel, mono = phase_mono(card, checks_only=args.only == "kernels")
    probes = phase_probe(card)
    if args.only == "kernels":
        return 0
    summary = phase_slice(card)
    train = phase_train(card)
    kernel["launches"] = summary["launches"]["stse_fused"] + train["launches"]["stse_fused"]
    kernel["launches_by_path"] = dict(serving=summary["launches"]["stse_fused"],
                                      training=train["launches"]["stse_fused"], mono=0)
    for rec in train_kernels + [mono_kernel]:
        by_path = dict(serving=0, training=train["launches"].get(rec["name"], 0),
                       mono=mono["launches"][rec["name"]])
        rec["launches"] = by_path["training"] + by_path["mono"]
        rec["launches_by_path"] = by_path
    kernels = [kernel, *train_kernels, mono_kernel, *probes]
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, build_s=build_s, kernels=kernels, products=products,
                       slice=summary, train=train, mono=mono), f, indent=1)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "tolerance",
            "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "product_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r} for r in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
