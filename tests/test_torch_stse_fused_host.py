"""K1's CUDA source, run on the host: csrc/stse_fused.cu compiled with g++
against tests/cuda_host_emu.h (one std::thread per CUDA thread, a barrier
for __syncthreads and one per warp for __syncwarp and the emulated mma,
NaN-filled shared memory) and held against the plain PyTorch version. This
checks the kernel's indexing, tiling, padding, windows a block and
synchronisation on a machine without a GPU; its speed is measured only on
the card (chip_smoke.py). Tolerance rtol=2e-4, atol=2e-5: fp32
reassociation (the products run as 3xTF32, ~fp32 accuracy).

The bf16 form (stse_fused_bf16_kernel) is held against the bf16 model's
module path itself, in the band of tests/test_torch_bf16.py: err <=
2^-5 * max(scale, 1). Both round at the same points, but the kernel sums
each product in another order (the emulated mma sums a step exactly, then
rounds), so a value can land on the other side of a bf16 rounding
boundary: one such flip is 1 ulp, <= 2^-7 of the value, and a few of them
through the layers stay within 4 ulps. Most values agree to the bit."""

import contextlib
import ctypes
import os
import re
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from coskad_tpu_torch.kernels import build, stse_fused
from coskad_tpu_torch.models import STSAE, STSE
from coskad_tpu_torch.models.stse import eval_uses_kernel

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = dict(rtol=2e-4, atol=2e-5)
FLAGSHIP = (2, (32, 16, 32), 64, 12, 18)  # input_dim, channels, hidden, t, v


def _host_source(cu: str) -> str:
    """The kernel source with its shared-memory declaration and its launch
    rewritten for the host emulation."""
    out, n_smem = re.subn(r"extern __shared__[^;]*float (\w+)\[\];", r"float* \1 = g_smem;", cu)
    out, n_launch = re.subn(r"(\w+)<<<([^,]+),\s*([^,]+),\s*([^,]+),[^>]*>>>\(",
                            r"emu_launch(\1, \2, \3, \4, ", out)
    # the float32 form's and the bf16 form's
    assert (n_smem, n_launch) == (2, 2), "kernel source no longer matches the host rewrite"
    return out.replace("#include <cuda_runtime.h>", '#include "cuda_host_emu.h"')


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to run the CUDA source on the host")
    d = tmp_path_factory.mktemp("stse_host")
    with open(os.path.join(build.CSRC, "stse_fused.cu")) as f:
        (d / "stse_fused_host.cpp").write_text(_host_source(f.read()))
    lib = str(d / "libstse_fused_host.so")
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-I", HERE,
                    "-I", build.CSRC, "-o", lib, str(d / "stse_fused_host.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = stse_fused.bind(ctypes.CDLL(lib))
    lib.emu_mma_count.argtypes = [ctypes.c_int]
    lib.emu_mma_count.restype = ctypes.c_longlong
    return lib


def _model(input_dim, channels, hidden, t, v, seed=0, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    model = STSE(input_dim=input_dim, layer_channels=channels, hidden_dimension=hidden,
                 latent_dim=4, n_frames=t, n_joints=v, dtype=dtype)
    model.reset_parameters(gen)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            lo, hi = (-0.5, 0.5) if name.endswith(".mean") else (0.5, 2.0)
            buf.copy_(torch.empty(buf.shape).uniform_(lo, hi, generator=gen))
    return model.eval()


def _run(host_kernel, x, packed, hidden):
    batch = x.shape[0]
    out = torch.full((batch, packed.n_nodes, hidden), float("nan"))
    layout = np.ascontiguousarray(packed.layout, np.int64)
    rc = stse_fused._entry(host_kernel, packed.dtype == torch.bfloat16, "forward")(
        x.data_ptr(), packed.weights.data_ptr(), layout.ctypes.data, len(layout), batch,
        packed.n_nodes, packed.n_pad, out.data_ptr(), None)
    assert rc == 0
    return out


@pytest.mark.parametrize("input_dim,channels,hidden,t,v,batch", [
    (*FLAGSHIP, 2),  # flagship widths: one block of 2 windows
    (8, (8,), 8, 6, 5, 3),  # identity residuals, 30 nodes padded to 32
    (2, (16,), 8, 5, 7, 2),  # the last layer narrows, 35 nodes padded to 48
    (3, (24, 6), 12, 4, 7, 2),  # a narrowing middle layer, odd channel counts
    (*FLAGSHIP, 3),  # flagship widths, a ragged last block of one window
    (*FLAGSHIP, 1),  # one window
    (2, (16, 8), 8, 5, 7, 5),  # 35 nodes, no whole 16-node tile, 2 windows a block, ragged
    # the paper's configs: flagship channels at 17 joints, 204 nodes in 13
    # tiles (the last of 12 nodes), a ragged last block of one window
    (2, (32, 16, 32), 64, 12, 17, 3),
])
def test_host_run_of_cuda_source_matches_plain(host_kernel, input_dim, channels, hidden, t, v,
                                                batch):
    model = _model(input_dim, channels, hidden, t, v)
    x = torch.randn(batch, input_dim, t, v, generator=torch.Generator().manual_seed(1))
    folded, packed = model.folded()
    out = _run(host_kernel, x, packed, hidden)
    with torch.no_grad():
        ref = stse_fused.fused_stse_hidden_reference(x, folded)
    torch.testing.assert_close(out, ref, **TOL)


@pytest.mark.parametrize("input_dim,channels,hidden,t,v,batch", [
    # the HR-STC widths at 17 joints: 204 nodes in 13 tiles, 4 windows a
    # block, a ragged last block of one window
    (2, (32, 16, 32), 64, 12, 17, 5),
    # identity residuals around a narrowing layer (8 -> 4), 35 nodes in 3
    # tiles, 3 windows of a block's 4
    (8, (8, 4), 4, 5, 7, 3),
])
def test_host_run_of_bf16_form_matches_module_path(host_kernel, input_dim, channels, hidden,
                                                   t, v, batch):
    """The bf16 form against the bf16 model's eval hidden state on the
    module path (`STSE.encode`), in the band of bf16 rounding; it issues
    bf16 mma and no TF32 mma (the emulator counts them by kind)."""
    model = _model(input_dim, channels, hidden, t, v, dtype=torch.bfloat16)
    x = torch.randn(batch, input_dim, t, v, generator=torch.Generator().manual_seed(4))
    _, packed = model.folded()
    assert packed.dtype == torch.bfloat16
    host_kernel.emu_mma_count(0), host_kernel.emu_mma_count(1)
    out = _run(host_kernel, x, packed, hidden)
    tf32, bf16 = host_kernel.emu_mma_count(0), host_kernel.emu_mma_count(1)
    assert tf32 == 0 and bf16 > 0, (tf32, bf16)
    with torch.no_grad():
        ref = model.encode(x)[1].reshape(batch, t * v, hidden)
    err = float((out - ref).abs().max())
    assert bool(torch.isfinite(out).all())
    assert err <= 2.0 ** -5 * max(float(ref.abs().max()), 1.0), err
    assert float((out == ref).float().mean()) > 0.9


def _autoencoder(dtype):
    """The UBnormal autoencoder's widths (encoder 2 -> 32 -> 16 -> 32 -> 64,
    decoder 64 -> 32 -> 16 -> 32 -> 2, latent 16, 12 frames x 17 joints) on
    seeded weights and BatchNorm statistics."""
    gen = torch.Generator().manual_seed(6)
    model = STSAE(input_dim=2, layer_channels=(32, 16, 32), hidden_dimension=64,
                  latent_dim=16, n_frames=12, n_joints=17, projector="mlp", dtype=dtype)
    model.reset_parameters(gen)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            lo, hi = (-0.5, 0.5) if name.endswith(".mean") else (0.5, 2.0)
            buf.copy_(torch.empty(buf.shape).uniform_(lo, hi, generator=gen))
    return model.eval()


def _on_the_host(monkeypatch, lib):
    """`_launch` on the host emulation: `lib` for the kernel's library, a
    CPU tensor's device taken as the current one, no stream."""
    monkeypatch.setattr(stse_fused, "_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=None))


@pytest.mark.parametrize("dtype,windows", [(torch.float32, 1), (torch.bfloat16, 2)])
def test_host_run_of_the_decoder_stack_matches_the_module_decoder(host_kernel, dtype,
                                                                  windows):
    """The autoencoder's decoder stack at 204 nodes, packed by
    `STSAE.decoder_folded` and fed the reverse projector's channel-major
    hidden state, against the module decoder in this file's bands. Both
    planners take it: the float32 form one window a block (its first layer
    takes 64 channels in, so two windows' activations pass a block's shared
    memory), the bf16 form two (64 channels in fill a warp's 16 tiles of G
    at two windows); 3 windows leave a ragged last block."""
    model = _autoencoder(dtype)
    z = torch.randn(3, 16, generator=torch.Generator().manual_seed(8))
    folded, packed = model.decoder_folded()
    assert stse_fused.takes(packed, host_kernel)
    assert stse_fused.occupancy(packed, host_kernel)["windows_per_block"] == windows
    with torch.no_grad():
        x = model.rev_btlnk.channel_major(z)
        ref = model.decoder(model.rev_btlnk(z)).reshape(3, 204, 2)
    host_kernel.emu_mma_count(0), host_kernel.emu_mma_count(1)
    out = _run(host_kernel, x, packed, 2)
    tf32, bf16 = host_kernel.emu_mma_count(0), host_kernel.emu_mma_count(1)
    assert bool(torch.isfinite(out).all())
    if dtype == torch.float32:
        assert tf32 > 0 and bf16 == 0, (tf32, bf16)
        torch.testing.assert_close(out, ref, **TOL)
        with torch.no_grad():
            torch.testing.assert_close(out, stse_fused.fused_stse_hidden_reference(x, folded),
                                       **TOL)
    else:
        assert tf32 == 0 and bf16 > 0, (tf32, bf16)
        err = float((out - ref).abs().max())
        assert err <= 2.0 ** -5 * max(float(ref.abs().max()), 1.0), err
        assert float((out == ref).float().mean()) > 0.9


def test_bf16_route_plan_and_launch_counters(host_kernel, monkeypatch):
    """At bf16 the eval route asks the bf16 form's planner (the CUDA
    source's, on the host): at the HR-STC widths it takes 4 windows a block
    and 13 warps, in two activation buffers [4 x 32 channels][216] of bf16
    and 13 rings of 4 slices [16][24]. A launch through the wrapper (here on
    the host emulation) counts `launches` and `bf16_launches`; a float32
    launch counts `launches` alone."""
    _on_the_host(monkeypatch, host_kernel)
    hrstc = _model(2, (32, 16, 32), 64, 12, 17, dtype=torch.bfloat16)
    assert hrstc.kernel_takes()
    assert stse_fused.occupancy(hrstc.folded()[1]) == dict(
        windows_per_block=4, smem_bytes=2 * 2 * 4 * 32 * 216 + 2 * 13 * 4 * 16 * 24,
        blocks_per_sm=1, threads=416)
    x = torch.randn(2, 8, 5, 7, generator=torch.Generator().manual_seed(5))
    for dtype in (torch.float32, torch.bfloat16):
        model = _model(8, (8, 4), 4, 5, 7, dtype=dtype)
        folded, packed = model.folded()
        before = stse_fused.launches.value, stse_fused.bf16_launches.value
        out = stse_fused._launch(x, *packed.op_args, dtype == torch.bfloat16)
        after = stse_fused.launches.value, stse_fused.bf16_launches.value
        assert (after[0] - before[0], after[1] - before[1]) == (1, int(dtype == torch.bfloat16))
        with torch.no_grad():
            ref = model.encode(x)[1].reshape(2, 35, 4)
        tol = TOL if dtype == torch.float32 else dict(rtol=0, atol=2.0 ** -5 * max(
            float(ref.abs().max()), 1.0))
        torch.testing.assert_close(out, ref, **tol)


def test_host_run_repeats_bit_for_bit(host_kernel):
    """Two launches on the same inputs give the same bits: every sum is
    taken in a fixed order and nothing reads what shared memory held
    before (the emulator fills it with NaN for each block)."""
    model = _model(3, (24, 6), 12, 4, 7)
    x = torch.randn(3, 3, 4, 7, generator=torch.Generator().manual_seed(2))
    _, packed = model.folded()
    first, second = (_run(host_kernel, x, packed, 12) for _ in range(2))
    assert torch.equal(first, second)


@pytest.mark.parametrize("channels,windows", [
    ((2, 32), 2), ((32, 16), 2), ((16, 32), 2), ((32, 64), 2), (None, 2), ((64, 64), 1),
])
def test_shared_memory_at_flagship_layers(host_kernel, channels, windows):
    """Windows a block and shared bytes at the flagship's layers (216 nodes,
    each alone and the whole stack, None): two activation buffers [224][ldx]
    (ldx the block's columns rounded up to 8 mod 16), W^T and W_res^T
    [C_out8][ldwt], the bias and each of 16 warps' ring of 2 slices [16][24]
    of M. Two windows fit one block an SM; a layer contracting 64 channels
    takes one. The blocks an SM come from the card; the host emulation
    says 1."""
    if channels is None:
        model = _model(*FLAGSHIP)
        widths = [(2, 32), (32, 16), (16, 32), (32, 64)]
    else:
        model = _model(channels[0], (), channels[1], 12, 18)
        widths = [channels]
    _, packed = model.folded()
    occ = stse_fused.occupancy(packed, host_kernel)
    assert occ["windows_per_block"] == windows
    pad8, stride = (lambda v: -(-v // 8) * 8), (lambda v: (v + 7) // 16 * 16 + 8)
    act = max([pad8(ci) for ci, _ in widths] + [pad8(co) for _, co in widths[:-1]])
    co8 = max(pad8(co) for _, co in widths)
    ldwt = stride(max(pad8(ci) for ci, _ in widths))
    floats = 2 * 224 * stride(windows * act) + 2 * co8 * ldwt + co8 + 16 * 2 * 16 * 24
    assert occ["smem_bytes"] == 4 * floats
    assert occ["smem_bytes"] + 1024 <= 228 * 1024
    assert occ["blocks_per_sm"] == 1


# Layouts K1's planner refuses (each with a layout it takes beside it): an
# inner layer of 80 channels (64 the most), 9 layers (8), 28 frames at 18
# joints (27: the activations no longer fit a block's shared memory).
REFUSED = {
    "wider_than_64": ((2, (80,), 16, 6, 5), (2, (64,), 16, 6, 5)),
    "nine_layers": ((2, (8,) * 8, 8, 6, 5), (2, (8,) * 7, 8, 6, 5)),
    "28_frames_at_18_joints": ((2, (32, 16, 32), 64, 28, 18), (2, (32, 16, 32), 64, 27, 18)),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_eval_route_takes_the_module_path_where_the_planner_refuses(host_kernel, monkeypatch,
                                                                   case):
    """STSE.forward(train=False) on the card asks K1's planner
    (`stse_fused.takes`, the `plan_layout` every launch runs) before it
    launches: a layout the planner refuses takes the model's own layers on
    the card, as JAX scores any layout its Config takes, and does not raise,
    grad mode on or off; a layout it takes still runs K1. The planner here
    is the CUDA source's, run on the host."""
    monkeypatch.setattr(stse_fused, "_library", lambda: host_kernel)
    refused, taken = (_model(*kw) for kw in REFUSED[case])
    assert not refused.kernel_takes() and taken.kernel_takes()
    assert not stse_fused.takes(refused.folded()[1], host_kernel)
    x = torch.randn(2, *REFUSED[case][0][:1], *REFUSED[case][0][3:],
                    generator=torch.Generator().manual_seed(3), requires_grad=True)
    assert not eval_uses_kernel(refused.kernel_takes(), [x, *refused.parameters()])
    with torch.no_grad():
        assert eval_uses_kernel(taken.kernel_takes(), [x, *taken.parameters()])
    z = refused(x)  # the module route: differentiable, as flax apply(train=False)
    torch.testing.assert_close(z, refused.encode(x)[0], rtol=0, atol=0)
    z.sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["nine_layers", "wider_than_64"])
def test_launch_leaves_the_layout_limits_to_the_planner(host_kernel, monkeypatch, case, dtype):
    """`_launch` checks no layout limit of its own: a layout past them (9
    layers; a layer of 80 channels) reaches the C entry, whose planner
    refuses it before any launch, and raises with the planner's message;
    nothing is counted. The planner is the CUDA source's, on the host."""
    _on_the_host(monkeypatch, host_kernel)
    _, packed = _model(*REFUSED[case][0], dtype=dtype).folded()
    x = torch.randn(2, 2, 6, 5, generator=torch.Generator().manual_seed(3))
    refusal = host_kernel.stse_fused_error_string(1).decode()  # cudaErrorInvalidValue
    before = stse_fused.launches.value
    with pytest.raises(RuntimeError, match=f"launch failed: {re.escape(refusal)}"):
        stse_fused._launch(x, *packed.op_args, dtype == torch.bfloat16)
    assert stse_fused.launches.value == before


def _callers_fault(fault, x, weights):
    """(x, weights) with one fault a caller can make."""
    if fault == "x_dtype":
        return x.double(), weights
    if fault == "x_not_contiguous":
        return x.transpose(2, 3).contiguous().transpose(2, 3), weights
    if fault == "x_channels":
        return x[:, :3].contiguous(), weights
    if fault == "x_nodes":
        return x[..., :6].contiguous(), weights
    if fault == "weights_device":
        return x, weights.to("meta")
    if fault == "weights_dtype":
        return x, weights.double()
    return x, torch.cat([weights.new_zeros(1), weights])[1:]  # 4 bytes past an alignment


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fault", ["x_dtype", "x_not_contiguous", "x_channels", "x_nodes",
                                   "weights_device", "weights_dtype", "weights_unaligned"])
def test_launch_refuses_a_callers_fault_before_the_library(monkeypatch, fault, dtype):
    """What a caller can get wrong (x's dtype, contiguity and shape, the
    weights' device, dtype and alignment) raises ValueError in `_launch`
    before the kernel's library is reached."""

    def no_library():
        raise AssertionError("the library was reached")

    monkeypatch.setattr(stse_fused, "_library", no_library)
    _, packed = _model(8, (8, 4), 4, 5, 7, dtype=dtype).folded()
    weights, layout, n_nodes, n_pad = packed.op_args
    x, weights = _callers_fault(fault, torch.randn(2, 8, 5, 7), weights)
    with pytest.raises(ValueError):
        stse_fused._launch(x, weights, layout, n_nodes, n_pad, dtype == torch.bfloat16)
