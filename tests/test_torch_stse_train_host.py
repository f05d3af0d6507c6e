"""K2-K5's CUDA source, run on the host: csrc/stse_train.cu compiled
with g++ against tests/cuda_host_emu.h (one std::thread per CUDA thread, a
barrier for __syncthreads, NaN-filled shared memory) and held against the
plain PyTorch versions, through the same descriptor-building wrappers the
card uses. This checks the kernels' indexing, passes and synchronisation on
a machine without a GPU; their speed is measured only on the card
(chip_smoke.py). The plain versions run in float64, as on the card: the
kernels are held to the exact function, not to another fp32 rounding of it.

Tolerances: forward outputs rtol=2e-4, atol=2e-4 and gradients
err < 1e-3 * max(scale, 1) + 1e-6, as tests/test_fused_train_kernel.py (fp32
reassociation through the BN backward's 1/cnt cancellations). The bf16
forms (`test_host_run_of_bf16_forms_matches_plain`) round at the same points
as their plain versions, but a value the kernel sums in fp32 and the plain
version in float64 can land on the other side of a bf16 rounding boundary:
one such flip moves a value by 1 ulp, <= 2^-7 of it, so every output and
gradient is held to err <= 2^-7 * max(scale, 1)."""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from coskad_tpu_torch.kernels import build, stse_train
from coskad_tpu_torch.models import STSE

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
FWD_TOL = dict(rtol=2e-4, atol=2e-4)


def _host_source(cu: str) -> str:
    """The kernel source with its shared-memory declarations and launches
    rewritten for the host emulation."""
    out, n_smem = re.subn(r"extern __shared__[^;]*float (\w+)\[\];", r"float* \1 = g_smem;", cu)
    out, n_launch = re.subn(r"(\w+)<<<([^,]+),\s*([^,]+),\s*([^,]+),[^>]*>>>\(",
                            r"emu_launch(\1, \2, \3, \4, ", out)
    assert n_smem >= 5 and n_launch >= 9, "kernel source no longer matches the host rewrite"
    return out.replace("#include <cuda_runtime.h>", '#include "cuda_host_emu.h"')


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to run the CUDA source on the host")
    d = tmp_path_factory.mktemp("stse_train_host")
    with open(os.path.join(build.CSRC, "stse_train.cu")) as f:
        (d / "stse_train_host.cpp").write_text(_host_source(f.read()))
    lib = str(d / "libstse_train_host.so")
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-I", HERE,
                    "-I", build.CSRC, "-o", lib, str(d / "stse_train_host.cpp")],
                   check=True, capture_output=True, timeout=300)
    so = ctypes.CDLL(lib)
    for fn in stse_train.REPLACES:
        getattr(so, fn).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        getattr(so, fn).restype = ctypes.c_int
    so.stse_train_error_string.argtypes = [ctypes.c_int]
    so.stse_train_error_string.restype = ctypes.c_char_p
    return so


def _model(input_dim, channels, hidden, t, v, latent, seed):
    gen = torch.Generator().manual_seed(seed)
    model = STSE(input_dim=input_dim, layer_channels=channels, hidden_dimension=hidden,
                 latent_dim=latent, n_frames=t, n_joints=v)
    model.reset_parameters(gen)
    with torch.no_grad():  # BN affines away from (1, 0), a PReLU slope per layer
        for name, p in model.named_parameters():
            if name.endswith("_bn.scale"):
                p.copy_(torch.empty(p.shape).uniform_(0.5, 1.5, generator=gen))
            elif name.endswith("_bn.bias"):
                p.copy_(torch.empty(p.shape).uniform_(-0.3, 0.3, generator=gen))
            elif name.endswith("alpha"):
                p.fill_(float(torch.empty(()).uniform_(0.1, 0.4, generator=gen)))
    return model


def _close_grad(got, want, name):
    scale = max(float(want.abs().max()), 1e-6)
    err = float((got - want).abs().max())
    assert err < 1e-3 * max(scale, 1.0) + 1e-6, (name, err, scale)


CASES = {
    # channels 2 -> 8 -> 4 -> 8: a widening, a narrowing and a widening layer
    "narrow": dict(input_dim=2, channels=(8, 4), hidden=8, t=6, v=5, latent=4, batch=16,
                   ghost=8),
    # an identity residual (8 -> 8) under the projector, 35 nodes, ghost == batch
    "identity": dict(input_dim=8, channels=(), hidden=8, t=5, v=7, latent=3, batch=8, ghost=8),
    # 215 nodes and 16 channels: the graph contraction's 4-node tiles, the
    # last one ragged; 1,720 rows, so dW's reduction is split over 3 blocks
    "tiled": dict(input_dim=2, channels=(16,), hidden=16, t=5, v=43, latent=4, batch=8,
                  ghost=4),
    # bwd_pre packs 4 windows of a 2-channel layer (2 of a 16-channel one) a
    # block: 10 windows leave a last block of 2; 35 nodes, 3 16-node tiles
    "ragged_windows": dict(input_dim=2, channels=(16,), hidden=8, t=5, v=7, latent=4,
                           batch=10, ghost=5),
    # C_in 3 (4 windows, 12 of 16 padded columns), C_in 40 > 32 (bwd_dx's
    # second column chunk reads dt and dr back), C_out 48 (6 channel tiles:
    # two warps idle), latent 20 > 16 (K4's dy over 3 k-steps, 5 row blocks)
    "wide": dict(input_dim=3, channels=(40,), hidden=48, t=3, v=4, latent=20, batch=8,
                 ghost=4),
    # K2's projector: wp's 288 rows in 9 splits of 32, 72 windows in one
    # 128-window tile (a warp's 16 ragged, three warps idle), latent 20 in a
    # 16-column and a ragged tile
    "projector_split": dict(input_dim=2, channels=(), hidden=8, t=4, v=9, latent=20, batch=72,
                            ghost=24),
}


BF16_BAND = 2.0 ** -7


def _close_bf16(got, want, name):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert bool(torch.isfinite(got).all()) and err <= BF16_BAND * max(scale, 1.0), (
        name, err, scale)


def _close_cosine(got, want, name):
    a, b = got.double().flatten(), want.double().flatten()
    denom = float(a.norm() * b.norm())
    assert bool(torch.isfinite(got).all()), name
    assert denom <= 1e-10 or float(a @ b) / denom > 0.98, (name, float(a @ b) / denom)


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_run_of_cuda_source_matches_plain(host_lib, case):
    kw = CASES[case]
    model = _model(kw["input_dim"], kw["channels"], kw["hidden"], kw["t"], kw["v"],
                   kw["latent"], seed=len(case))
    ops = stse_train.detached(stse_train.encoder_ops(model))
    ops64 = stse_train.detached(ops, torch.float64)
    b, n, ghost = kw["batch"], kw["t"] * kw["v"], kw["ghost"]
    if case == "projector_split":
        assert stse_train.projector_splits(n * kw["hidden"], b, kw["latent"]) == 9
        assert b % 16 and kw["latent"] > 16
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(b, n, kw["input_dim"])).astype(np.float32))

    z, sums, acts, stats = stse_train.launch_forward(host_lib, x, ops, ghost)
    z_r, sums_r, acts_r, stats_r = stse_train.ghost_forward_reference(x.double(), ops64, ghost)
    torch.testing.assert_close(z, z_r.float(), **FWD_TOL)
    for got, want in zip(sums + acts + stats, sums_r + acts_r + stats_r):
        torch.testing.assert_close(got, want.float(), **FWD_TOL)

    dz = torch.from_numpy(rng.normal(size=(b, kw["latent"])).astype(np.float32))
    top = len(ops.layers) - 1
    x_top = x if top == 0 else acts[top - 1]
    grads, dwp, dbp, dy = stse_train.launch_backward(
        host_lib, x_top, acts[top], stats[top], ops.layers[top], ghost, need_dx=top > 0, dz=dz,
        wp=ops.wp)
    want, dwp_r, dbp_r, dy_r = stse_train.top_backward_reference(
        x_top.double(), dz.double(), ops64.layers[top], ops64.wp, ops64.bp, ghost,
        need_dx=top > 0)
    _close_grad(dwp, dwp_r.float(), "dwp")
    _close_grad(dbp, dbp_r.float(), "dbp")
    layer_grads = [(top, grads, want)]
    if top > 0:
        _close_grad(dy, dy_r.float(), "dx of the top layer")
    for l in reversed(range(top)):
        x_l = x if l == 0 else acts[l - 1]
        g, _, _, dx = stse_train.launch_backward(host_lib, x_l, acts[l], stats[l],
                                                 ops.layers[l], ghost, need_dx=l > 0,
                                                 dy=dy_r.float())
        w, dx_r = stse_train.layer_backward_reference(x_l.double(), dy_r, ops64.layers[l],
                                                      ghost, need_dx=l > 0)
        layer_grads.append((l, g, w))
        if l > 0:
            _close_grad(dx, dx_r.float(), f"dx of layer {l}")
            dy_r = dx_r
        else:
            assert dx is None
    for l, g, w in layer_grads:
        for f in stse_train.LayerOps._fields:
            a, e = getattr(g, f), getattr(w, f)
            assert (a is None) == (e is None), (l, f)
            if a is not None:
                _close_grad(a, e.float(), f"layer {l} d{f}")


@pytest.mark.parametrize("case,compute_dtype", [
    ("narrow", "bfloat16"), ("narrow", "bfloat16_f32store"), ("wide", "bfloat16"),
    ("wide", "bfloat16_f32store")])
def test_host_run_of_bf16_forms_matches_plain(host_lib, case, compute_dtype):
    """K2, K4 and K3 in a bf16 form against their plain versions in the same
    form (float64 between the rounding points), PReLU's branches taken from
    K2's output; the windows bf16 already, as fused_stse_apply hands them
    over (a bf16 tensor under "bfloat16", whose activations, dy and dx are
    bf16 tensors too). "wide" takes bwd_dx's second column chunk (C_in 40)
    and K4's dy over 3 k-steps."""
    kw = CASES[case]
    model = _model(kw["input_dim"], kw["channels"], kw["hidden"], kw["t"], kw["v"],
                   kw["latent"], seed=len(case) + 1)
    ops = stse_train.detached(stse_train.encoder_ops(model))
    ops64 = stse_train.detached(ops, torch.float64)
    b, n, ghost = kw["batch"], kw["t"] * kw["v"], kw["ghost"]
    rng = np.random.default_rng(7)
    act = stse_train.activation_dtype(compute_dtype)
    x = torch.from_numpy(rng.normal(size=(b, n, kw["input_dim"])).astype(np.float32))
    x = x.to(torch.bfloat16).to(act)
    out = stse_train.launch_forward(host_lib, x, ops, ghost, compute_dtype)
    ref = stse_train.ghost_forward_reference(x.double(), ops64, ghost, compute_dtype)
    z, sums, acts, stats = out
    _close_bf16(z, ref[0], "z")
    for name, got, want in zip(("sums", "acts", "stats"), out[1:], ref[1:]):
        for l, (a, e) in enumerate(zip(got, want)):
            _close_bf16(a, e, f"{name}{l}")
    assert all(a.dtype == act for a in acts)  # bf16 tensors under "bfloat16"
    dz = torch.from_numpy(rng.normal(size=(b, kw["latent"])).astype(np.float32))
    top = len(ops.layers) - 1
    x_of = [x, *acts[:-1]]
    grads, dwp, dbp, dy = stse_train.launch_backward(
        host_lib, x_of[top], acts[top], stats[top], ops.layers[top], ghost, need_dx=top > 0,
        dz=dz, wp=ops.wp, compute_dtype=compute_dtype)
    want, dwp_r, dbp_r, dy_r = stse_train.top_backward_reference(
        x_of[top].double(), dz.double(), ops64.layers[top], ops64.wp, ops64.bp, ghost,
        need_dx=top > 0, positive=acts[top] >= 0, compute_dtype=compute_dtype)
    _close_bf16(dwp, dwp_r, "dwp")
    _close_bf16(dbp, dbp_r, "dbp")
    pairs = [(top, grads, want)]
    if top > 0:
        assert dy.dtype == act
        _close_bf16(dy, dy_r, "dx of the top layer")
    for l in reversed(range(top)):
        g, _, _, dx = stse_train.launch_backward(
            host_lib, x_of[l], acts[l], stats[l], ops.layers[l], ghost, need_dx=l > 0,
            dy=dy_r.to(act), compute_dtype=compute_dtype)
        w, dx_r = stse_train.layer_backward_reference(
            x_of[l].double(), dy_r, ops64.layers[l], ghost, need_dx=l > 0,
            positive=acts[l] >= 0, compute_dtype=compute_dtype)
        pairs.append((l, g, w))
        if l > 0:
            assert dx.dtype == act
            _close_bf16(dx, dx_r, f"dx of layer {l}")
            dy_r = dx_r
    for l, g, w in pairs:
        for f in stse_train.LayerOps._fields:
            if getattr(w, f) is not None:
                _close_bf16(getattr(g, f), getattr(w, f), f"layer {l} d{f}")


MONO_CASES = {
    # chunks of 8, 8 and 4 windows: the last one ragged
    "ragged": dict(model="narrow", batch=20, ghost=4, chunk=8, n_chunks=3),
    # one identity-residual layer; the whole batch in one chunk
    "single": dict(model="identity", batch=16, ghost=8, chunk=64, n_chunks=1),
    # each chunk one ghost block
    "one_block": dict(model="narrow", batch=12, ghost=4, chunk=4, n_chunks=3),
}


@pytest.mark.parametrize("case", sorted(MONO_CASES))
def test_host_run_of_mono_backward_matches_plain(host_lib, case):
    """K5 against its plain version in float64, PReLU's branches taken from
    K2's output (as on the card)."""
    mc = MONO_CASES[case]
    kw = CASES[mc["model"]]
    model = _model(kw["input_dim"], kw["channels"], kw["hidden"], kw["t"], kw["v"],
                   kw["latent"], seed=len(case))
    ops = stse_train.detached(stse_train.encoder_ops(model))
    b, n, ghost = mc["batch"], kw["t"] * kw["v"], mc["ghost"]
    chunk = stse_train.mono_chunk(ops, b, ghost, chunk_windows=mc["chunk"])
    assert -(-b // chunk) == mc["n_chunks"]
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(b, n, kw["input_dim"])).astype(np.float32))
    dz = torch.from_numpy(rng.normal(size=(b, kw["latent"])).astype(np.float32))
    _, _, acts, _ = stse_train.launch_forward(host_lib, x, ops, ghost)
    got = stse_train.launch_mono_backward(host_lib, x, dz, ops, ghost, mc["chunk"])
    want = stse_train.mono_backward_reference(x.double(), dz.double(),
                                              stse_train.detached(ops, torch.float64), ghost,
                                              positive=[a >= 0 for a in acts])
    _close_grad(got.wp, want.wp.float(), "dwp")
    _close_grad(got.bp, want.bp.float(), "dbp")
    for l, (g, w) in enumerate(zip(got.layers, want.layers)):
        for f in stse_train.LayerOps._fields:
            a, e = getattr(g, f), getattr(w, f)
            assert (a is None) == (e is None), (l, f)
            if a is not None:
                _close_grad(a, e.float(), f"layer {l} d{f}")


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "bfloat16_f32store"])
def test_host_run_of_mono_backward_bf16_forms_matches_plain(host_lib, compute_dtype):
    """K5 in a bf16 form (its passes are K2's, K4's and K3's in that form)
    against its plain version, chunks of 8, 8 and 4 windows."""
    kw = CASES["narrow"]
    model = _model(kw["input_dim"], kw["channels"], kw["hidden"], kw["t"], kw["v"],
                   kw["latent"], seed=9)
    ops = stse_train.detached(stse_train.encoder_ops(model))
    b, n, ghost = 20, kw["t"] * kw["v"], 4
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(b, n, kw["input_dim"])).astype(np.float32))
    x = x.to(torch.bfloat16).to(stse_train.activation_dtype(compute_dtype))
    dz = torch.from_numpy(rng.normal(size=(b, kw["latent"])).astype(np.float32))
    _, _, acts, _ = stse_train.launch_forward(host_lib, x, ops, ghost, compute_dtype)
    got = stse_train.launch_mono_backward(host_lib, x, dz, ops, ghost, 8, compute_dtype)
    want = stse_train.mono_backward_reference(x.double(), dz.double(),
                                              stse_train.detached(ops, torch.float64), ghost,
                                              positive=[a >= 0 for a in acts],
                                              compute_dtype=compute_dtype)
    names = [f"layer{l}.d{f}" for l in range(len(ops.layers)) for f in stse_train.LayerOps._fields]
    for name, a, w in zip(names + ["dwp", "dbp"], stse_train._flatten(got),
                          stse_train._flatten(want)):
        assert (a is None) == (w is None), name
        if a is not None:
            _close_bf16(a, w, name)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_host_run_of_mono_backward_in_flight_same_bits(host_lib, compute_dtype):
    """K5 with two chunks in flight, chunks of 8, 8 and 4 windows: slot 0
    takes chunks 0 and 2 (the ragged last one), slot 1 chunk 1, at the
    slot offset the descriptor gives, in float32's workspace layout and in
    "bfloat16"'s (bf16 scratch and activations; "bfloat16_f32store" has
    float32's layout). Each chunk writes only its own slot
    and its own shares of the batch reductions, so the result is the bits
    of one chunk in flight. Against the plain version: float32 within the
    gradient band; a bf16 form by each leaf's cosine above 0.98, the JAX
    package's bf16 gradient check (tests/test_fused_train_kernel.py:226-233)
    and the card's for K5 (chip_smoke.py), since a value on the other side
    of a bf16 rounding boundary in one chain moves every layer below it and
    a sum with cancellation (dalpha) by more than 2^-7 of its size."""
    kw = CASES["narrow"]
    model = _model(kw["input_dim"], kw["channels"], kw["hidden"], kw["t"], kw["v"],
                   kw["latent"], seed=11)
    ops = stse_train.detached(stse_train.encoder_ops(model))
    b, n, ghost = 20, kw["t"] * kw["v"], 4
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(size=(b, n, kw["input_dim"])).astype(np.float32))
    if compute_dtype != "float32":
        x = x.to(torch.bfloat16).to(stse_train.activation_dtype(compute_dtype))
    dz = torch.from_numpy(rng.normal(size=(b, kw["latent"])).astype(np.float32))
    _, _, acts, _ = stse_train.launch_forward(host_lib, x, ops, ghost, compute_dtype)
    one, two = (stse_train.launch_mono_backward(host_lib, x, dz, ops, ghost, 8, compute_dtype,
                                                in_flight=k) for k in (1, 2))
    want = stse_train.mono_backward_reference(x.double(), dz.double(),
                                              stse_train.detached(ops, torch.float64), ghost,
                                              positive=[a >= 0 for a in acts],
                                              compute_dtype=compute_dtype)
    close = _close_grad if compute_dtype == "float32" else _close_cosine
    names = [f"layer{l}.d{f}" for l in range(len(ops.layers)) for f in stse_train.LayerOps._fields]
    for name, a, c, w in zip(names + ["dwp", "dbp"], *map(stse_train._flatten, (one, two, want))):
        assert (a is None) == (c is None) == (w is None), name
        if a is not None:
            assert torch.equal(a, c), name
            close(c, w.float(), name)


def test_forward_repeats_bit_for_bit(host_lib):
    """Two K2 launches on the same inputs give the same bits: every sum
    (window moments, ghost statistics, the projector's splits) is taken in
    a fixed order, and nothing depends on what the scratch held before."""
    kw = CASES["projector_split"]
    model = _model(kw["input_dim"], kw["channels"], kw["hidden"], kw["t"], kw["v"],
                   kw["latent"], seed=5)
    ops = stse_train.detached(stse_train.encoder_ops(model))
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(kw["batch"], kw["t"] * kw["v"], kw["input_dim"]))
                         .astype(np.float32))
    first, second = (stse_train.launch_forward(host_lib, x, ops, kw["ghost"]) for _ in range(2))
    flat = lambda out: [out[0], *out[1], *out[2], *out[3]]
    assert all(torch.equal(a, b) for a, b in zip(flat(first), flat(second)))


@pytest.mark.parametrize("ci, co, windows", [(2, 32, 4), (32, 16, 1), (16, 32, 2), (32, 64, 1)])
def test_pass_shared_memory_at_flagship_layers(host_lib, ci, co, windows):
    """fwd_pre's and bwd_pre's windows a block and every per-window pass's
    shared bytes at the flagship's layers (216 nodes): bwd_dx keeps only dg,
    W^T and W_res^T and the constants, so two blocks of the top
    layer fit an SM's 228 KB (each block also reserves 1 KB), and so do two
    fwd_pre blocks of any layer; fwd_apply keeps its ghost block's 8
    constants a channel. The bf16 forms' bwd_dx keeps dg^T, W and W_res as
    bf16 pairs (rows of 4 mod 8 words) and needs no more bytes than the
    float32 form's at any flagship layer, nor does any other pass, so it fits
    at least as many blocks an SM. The blocks an SM come from the card; the
    host emulation says 1."""
    rows, pad = 224, lambda v: -(-v // 8) * 8
    ldx = pad(windows * ci) + 4
    dx = {"float32": 4 * (rows * (pad(ci) + 4) + 2 * co * (pad(ci) + 8) + 6 * co)}
    for form, consts in (("bfloat16", 8), ("bfloat16_f32store", 6)):
        # dg^T [ci8][224 + 8], W and W_res [ci8][co16 + 8] in bf16; the constants
        # (and under "bfloat16", whose scratch holds t and r, the block's means)
        dx[form] = 2 * pad(ci) * (rows + 8 + 2 * (-(-co // 16) * 16 + 8)) + 4 * consts * co
    occ = {form: stse_train.pass_occupancy(host_lib, 216, ci, co, form)
           for form in stse_train.COMPUTE_DTYPES}
    for form, o in occ.items():
        assert o["bwd_pre_windows_per_block"] == o["fwd_pre_windows_per_block"] == windows
        for name, q in (("bwd_pre", 3), ("fwd_pre", 5)):
            floats = (2 * rows * ldx + 2 * ci * (pad(co) + 8) + q * max(64, pad(co))
                      + 8 * 32 * 2 * q + 256)
            assert o[f"{name}_smem_bytes"] == 4 * floats, (form, name)
        assert o["bwd_dx_smem_bytes"] == dx[form], form
        assert o["fwd_apply_smem_bytes"] == 4 * 8 * co
        for name in ("bwd_dx", "fwd_pre"):
            assert 2 * (o[f"{name}_smem_bytes"] + 1024) <= 228 * 1024, (form, name)
        for name in ("bwd_pre", "bwd_dx", "fwd_pre", "fwd_apply"):
            assert o[f"{name}_smem_bytes"] <= occ["float32"][f"{name}_smem_bytes"], (form, name)
        assert all(o[k] == 1 for k in o if k.endswith("_blocks_per_sm"))
    assert occ["bfloat16"]["bwd_dx_smem_bytes"] < occ["float32"]["bwd_dx_smem_bytes"]


def test_launch_refuses_mismatched_inputs(host_lib):
    model = _model(2, (4,), 4, 3, 4, 2, seed=0)
    ops = stse_train.encoder_ops(model)
    x = torch.zeros(8, 12, 2)
    with pytest.raises(ValueError, match="multiple of ghost_size"):
        stse_train.launch_forward(host_lib, x[:6], ops, 4)
    with pytest.raises(ValueError, match="channels"):
        stse_train.launch_forward(host_lib, torch.zeros(8, 12, 3), ops, 4)
    with pytest.raises(ValueError, match="compute_dtype"):
        stse_train.launch_forward(host_lib, x, ops, 4, "float16")
