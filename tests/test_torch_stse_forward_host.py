"""K2's bfloat16 forms on the host emulation: csrc/stse_train.cu compiled
with g++ against tests/cuda_host_emu.h (see test_torch_stse_train_host.py)
and held against the plain versions in the same form, float64 between the
rounding points.

Under both bf16 forms K2's per-window passes (fwd_pre, projector_z) run on
the bf16 mma, as bwd_pre does, so the backward's recompute of g, t and r is
the forward's arithmetic; under "bfloat16" the windows, every activation,
dy and dx are bf16 tensors. The band is the bf16 forms' own
(test_torch_stse_train_host.py): a value the kernel sums in fp32 and the
plain version in float64 can land on the other side of a bf16 rounding
boundary, 1 ulp, <= 2^-7 of it, so every output and gradient is held to
err <= 2^-7 * max(scale, 1)."""

import ctypes

import numpy as np
import pytest
import torch

from coskad_tpu_torch.kernels import stse_train
from test_torch_stse_train_host import CASES, _close_bf16, _model, host_lib  # noqa: F401

torch.set_num_threads(1)

BF16_FORMS = ("bfloat16", "bfloat16_f32store")
TF32, BF16 = 0, 1  # the emulator's mma kinds (emu_mma_count)


def _mma_counts(lib) -> tuple:
    """(TF32, bf16) warp-level mma calls since the last read, and clear them."""
    fn = lib.emu_mma_count
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_longlong
    return fn(TF32), fn(BF16)


def _setup(case, compute_dtype, seed, batch=None):
    """(ops, float64 ops, windows in the form's activation dtype, ghost) of a
    CASES model; the windows bf16 values, as fused_stse_apply hands them over."""
    kw = CASES[case]
    model = _model(kw["input_dim"], kw["channels"], kw["hidden"], kw["t"], kw["v"],
                   kw["latent"], seed=seed)
    ops = stse_train.detached(stse_train.encoder_ops(model))
    b, n = batch or kw["batch"], kw["t"] * kw["v"]
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(b, n, kw["input_dim"])).astype(np.float32))
    x = x.to(torch.bfloat16).to(stse_train.activation_dtype(compute_dtype))
    return ops, stse_train.detached(ops, torch.float64), x, kw["ghost"]


# 35 nodes with an identity residual, 215 nodes (a ragged last node tile),
# and 10 windows of a 2-channel layer (a ragged last 4-window block)
@pytest.mark.parametrize("case", ["identity", "tiled", "ragged_windows"])
@pytest.mark.parametrize("compute_dtype", BF16_FORMS)
def test_forward_bf16_forms_run_the_bf16_mma_and_match_plain(host_lib, case, compute_dtype):
    """K2 in a bf16 form takes the bf16 mma in every product (fwd_pre's g, t
    and r, projector_z's z) and none of the TF32 ones, and stays within the
    band of its plain version in the same form; its activations come back
    in the form's activation dtype."""
    ops, ops64, x, ghost = _setup(case, compute_dtype, seed=len(case) + 3)
    _mma_counts(host_lib)
    z, sums, acts, stats = stse_train.launch_forward(host_lib, x, ops, ghost, compute_dtype)
    tf32, bf16 = _mma_counts(host_lib)
    assert tf32 == 0 and bf16 > 0, (tf32, bf16)
    ref = stse_train.ghost_forward_reference(x.double(), ops64, ghost, compute_dtype)
    _close_bf16(z, ref[0], "z")
    for name, got, want in zip(("sums", "acts", "stats"), (sums, acts, stats), ref[1:]):
        for l, (a, e) in enumerate(zip(got, want)):
            _close_bf16(a, e, f"{name}{l}")
    act = stse_train.activation_dtype(compute_dtype)
    assert all(a.dtype == act for a in acts)
    assert z.dtype == torch.float32 and all(s.dtype == torch.float32 for s in sums + stats)


def test_forward_float32_stays_on_3xtf32(host_lib):
    """The float32 form keeps its 3xTF32 products: no bf16 mma."""
    ops, _, x, ghost = _setup("ragged_windows", "float32", seed=2)
    _mma_counts(host_lib)
    stse_train.launch_forward(host_lib, x, ops, ghost)
    tf32, bf16 = _mma_counts(host_lib)
    assert tf32 > 0 and bf16 == 0, (tf32, bf16)


@pytest.mark.parametrize("case", ["narrow", "ragged_windows"])
def test_bf16_activations_feed_k4_and_k3(host_lib, case):
    """Under "bfloat16" K2's activations are torch.bfloat16; K4 from them
    hands back a bf16 dx, and K3 fed that dx (and K2's bf16 input and
    output) hands back a bf16 dx in turn. Each kernel stays within the band
    of its plain version given the same tensors, PReLU's branches taken from
    K2's output."""
    form = "bfloat16"
    ops, ops64, x, ghost = _setup(case, form, seed=11)
    _, _, acts, stats = stse_train.launch_forward(host_lib, x, ops, ghost, form)
    assert all(a.dtype == torch.bfloat16 for a in acts)
    latent = ops.wp.shape[1]
    dz = torch.from_numpy(np.random.default_rng(12).normal(size=(x.shape[0], latent))
                          .astype(np.float32))
    top = len(ops.layers) - 1
    x_of = [x, *acts[:-1]]
    grads, dwp, dbp, dy = stse_train.launch_backward(
        host_lib, x_of[top], acts[top], stats[top], ops.layers[top], ghost, need_dx=True,
        dz=dz, wp=ops.wp, compute_dtype=form)
    want, dwp_r, dbp_r, dy_r = stse_train.top_backward_reference(
        x_of[top].double(), dz.double(), ops64.layers[top], ops64.wp, ops64.bp, ghost,
        need_dx=True, positive=acts[top] >= 0, compute_dtype=form)
    assert dy.dtype == torch.bfloat16
    pairs = [("dwp", dwp, dwp_r), ("dbp", dbp, dbp_r), (f"layer{top}.dx", dy, dy_r)]
    pairs += [(f"layer{top}.d{f}", getattr(grads, f), getattr(want, f))
              for f in stse_train.LayerOps._fields if getattr(want, f) is not None]
    for l in reversed(range(top)):
        grads, _, _, dx = stse_train.launch_backward(
            host_lib, x_of[l], acts[l], stats[l], ops.layers[l], ghost, need_dx=True, dy=dy,
            compute_dtype=form)
        want, dx_r = stse_train.layer_backward_reference(
            x_of[l].double(), dy.double(), ops64.layers[l], ghost, need_dx=True,
            positive=acts[l] >= 0, compute_dtype=form)
        assert dx.dtype == torch.bfloat16
        pairs.append((f"layer{l}.dx", dx, dx_r))
        pairs += [(f"layer{l}.d{f}", getattr(grads, f), getattr(want, f))
                  for f in stse_train.LayerOps._fields if getattr(want, f) is not None]
        dy = dx
    for name, got, want in pairs:
        _close_bf16(got.double(), want, name)


@pytest.mark.parametrize("compute_dtype", BF16_FORMS)
def test_forward_bf16_repeats_bit_for_bit(host_lib, compute_dtype):
    """Two K2 launches in a bf16 form give the same bits (the projector over
    9 row splits, 72 windows)."""
    ops, _, x, ghost = _setup("projector_split", compute_dtype, seed=5)
    first, second = (stse_train.launch_forward(host_lib, x, ops, ghost, compute_dtype)
                     for _ in range(2))
    flat = lambda out: [out[0], *out[1], *out[2], *out[3]]
    assert all(torch.equal(a, b) for a, b in zip(flat(first), flat(second)))


@pytest.mark.parametrize("ci, co, windows", [(2, 32, 4), (32, 16, 1), (16, 32, 2), (32, 64, 1)])
def test_fwd_pre_shared_memory_at_flagship_layers(host_lib, ci, co, windows):
    """fwd_pre's windows a block and shared bytes at the flagship's layers
    (216 nodes) are the same in every form (x and g are staged in fp32 as
    bwd_pre stages them, whichever mma reads them), so the bf16 forms fit as
    many blocks an SM as float32, and two blocks fit an SM's 228 KB (each
    also reserves 1 KB); fwd_apply keeps its 8 constants a channel."""
    rows, pad = 224, lambda v: -(-v // 8) * 8
    floats = (2 * rows * (pad(windows * ci) + 4) + 2 * ci * (pad(co) + 8) + 5 * max(64, pad(co))
              + 8 * 32 * 2 * 5 + 256)
    for form in stse_train.COMPUTE_DTYPES:
        occ = stse_train.pass_occupancy(host_lib, 216, ci, co, form)
        assert occ["fwd_pre_windows_per_block"] == windows, form
        assert occ["fwd_pre_smem_bytes"] == 4 * floats, form
        assert 2 * (occ["fwd_pre_smem_bytes"] + 1024) <= 228 * 1024, form
        assert occ["fwd_apply_smem_bytes"] == 4 * 8 * co, form


def test_wrappers_hand_back_bf16_on_the_cpu_route():
    """On a CPU tensor under "bfloat16" the wrappers take and hand back bf16
    windows, activations and dx, as on the card (the plain versions run on
    the widened values), and refuse float32 windows; float32 stays float32."""
    ops, _, x, ghost = _setup("narrow", "bfloat16", seed=3)
    z, sums, acts, stats = stse_train.ghost_forward(x, ops, ghost, "bfloat16")
    assert all(a.dtype == torch.bfloat16 for a in acts) and z.dtype == torch.float32
    dz = torch.ones(x.shape[0], ops.wp.shape[1])
    top = len(ops.layers) - 1
    *_, dy = stse_train.top_backward(acts[top - 1], acts[top], dz, ops.layers[top], stats[top],
                                     ops.wp, ops.bp, ghost, compute_dtype="bfloat16")
    _, dx = stse_train.layer_backward(acts[top - 2], acts[top - 1], dy, ops.layers[top - 1],
                                      stats[top - 1], ghost, compute_dtype="bfloat16")
    assert dy.dtype == dx.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="bfloat16"):
        stse_train.ghost_forward(x.float(), ops, ghost, "bfloat16")
    _, _, acts32, _ = stse_train.ghost_forward(x.float(), ops, ghost)
    assert all(a.dtype == torch.float32 for a in acts32)
