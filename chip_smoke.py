#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (coskad_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing a line before the last:
  1. environment: the card's name and power limit (nvidia-smi), torch and
     CUDA versions; builds every kernel of the port from csrc/ with nvcc.
  2. kernel: each kernel against its plain PyTorch version on the card, at
     the serving path's shapes (full width, B=2048 and a ragged B=2047), on
     a one-layer identity-residual stack and on a stack whose last layer
     narrows (16 -> 8 channels, 35 nodes); times kernel and plain version.
  3. slice: the serving path at the flagship width (sts_gcn 2->32->16->32->64,
     latent 16, windows [2, 12, 18], 5 transforms, batch 2048, fp32) with
     random weights from a seed: Trainer.initialize_center and score_all over
     40,000 resident windows x 5 transforms, validate's frame AUC on synthetic
     ground truth, AnomalyScorer.score_clip_json on an AlphaPose clip. Checks
     the kernels' launch counts rose during this phase, and the scores
     against the plain CPU path on a subset.
  4. a JSON line of every kernel (launches on the slice, error, times, bound),
     then the last line {"ok": true, "device": {...}}.

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
PEAK_BYTES_PER_S = 3.35e12
TOL = dict(rtol=2e-4, atol=2e-5)  # kernel vs plain: fp32 reassociation
SCORE_TOL = dict(rtol=1e-3, atol=1e-6)  # scores square latent differences
DEVICE = "cuda"
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


def phase_kernel(card):
    """K1 against its plain version on the card; returns its kernel record."""
    import torch
    from coskad_tpu_torch.kernels import stse_fused

    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(1234)
    full = dict(input_dim=2, layer_channels=(32, 16, 32), hidden_dimension=64,
                latent_dim=16, n_frames=12, n_joints=18)
    model = seeded_stse(gen, dev, **full)
    folded, packed = model.folded()
    cases = []
    x_main = None
    for label, kw, batch in (("full_B2048", full, 2048), ("full_B2047", full, 2047),
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
            h_r = stse_fused.fused_stse_hidden_reference(x, f)
            z_k = stse_fused.fused_stse_forward(x, f, p)
            z_r = stse_fused.fused_stse_forward_reference(x, f)
        torch.cuda.synchronize()
        err_h = float((h_k - h_r).abs().max())
        err_z = float((z_k - z_r).abs().max())
        ok = (within(h_k, h_r, **TOL) and within(z_k, z_r, **TOL)
              and bool(torch.isfinite(h_k).all()))
        cases.append(dict(case=label, batch=batch, max_abs_err_hidden=err_h,
                          max_abs_err_latent=err_z, ok=ok))
        check(ok, f"stse_fused {label}: kernel vs plain max abs err hidden {err_h:.3e}, "
                  f"latent {err_z:.3e} outside rtol {TOL['rtol']} atol {TOL['atol']}")
        if label == "full_B2048":
            x_main = x

    with torch.no_grad():
        kernel_ms = cuda_ms(lambda: stse_fused.fused_stse_hidden(x_main, folded, packed))
        plain_ms = cuda_ms(lambda: stse_fused.fused_stse_hidden_reference(x_main, folded))
        kernel_ms_2 = cuda_ms(lambda: stse_fused.fused_stse_hidden(x_main, folded, packed))
        plain_ms_2 = cuda_ms(lambda: stse_fused.fused_stse_hidden_reference(x_main, folded))
        per_layer_ms = {}
        for lay in folded.layers:  # each layer alone, as a one-layer stack
            one = folded._replace(layers=[lay])
            one_packed = stse_fused.pack_folded(one)
            x1 = torch.randn(2048, lay.w.shape[0], 12, 18, generator=gen).to(dev)
            per_layer_ms["{}->{}".format(*lay.w.shape)] = cuda_ms(
                lambda: stse_fused.fused_stse_hidden(x1, one, one_packed))
    flops, nbytes = stse_fused.work(folded, 2048)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    rec = dict(
        name="stse_fused", route="cuda", source=stse_fused.SOURCE,
        replaces=stse_fused.REPLACES, launches=None,
        max_abs_err=max(c["max_abs_err_hidden"] for c in cases),
        tolerance=TOL, ms=min(kernel_ms, kernel_ms_2), kernel_ms=min(kernel_ms, kernel_ms_2),
        plain_ms=min(plain_ms, plain_ms_2), bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes", library_ms=None,
        batch=2048, flops=flops, bytes=nbytes, cases=cases, per_layer_ms=per_layer_ms,
        timing_runs_ms=dict(kernel=[kernel_ms, kernel_ms_2], plain=[plain_ms, plain_ms_2]),
    )
    print("kernel check: " + json.dumps(dict(
        name="stse_fused", cases=cases, kernel_ms=rec["kernel_ms"], plain_ms=rec["plain_ms"],
        bound_ms=rec["bound_ms"], bound_by=rec["bound_by"], per_layer_ms=per_layer_ms,
        card=card)))
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
    return dict(device_busy_ms=busy / 1e3, device_span_ms=span / 1e3,
                idle_share=1.0 - busy / span, stse_fused_share_of_busy=k1 / busy,
                device_events=len(events))


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


def main() -> int:
    card, build_s = phase_environment()
    import torch

    kernel = phase_kernel(card)
    summary = phase_slice(card)
    kernel["launches"] = summary["launches"]["stse_fused"]
    kernels = [kernel]
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, build_s=build_s, kernels=kernels, slice=summary), f,
                  indent=1)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "tolerance",
            "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
