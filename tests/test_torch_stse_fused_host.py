"""K1's CUDA source, run on the host: csrc/stse_fused.cu compiled with g++
against tests/cuda_host_emu.h (one std::thread per CUDA thread, a barrier
for __syncthreads, NaN-filled shared memory) and held against the plain
PyTorch version. This checks the kernel's indexing, tiling, padding and
synchronisation on a machine without a GPU; its speed is measured only on
the card (chip_smoke.py). Tolerance rtol=2e-4, atol=2e-5: fp32
reassociation."""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from coskad_tpu_torch.kernels import build, stse_fused
from coskad_tpu_torch.models import STSE

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = dict(rtol=2e-4, atol=2e-5)


def _host_source(cu: str) -> str:
    """The kernel source with its shared-memory declaration and its launch
    rewritten for the host emulation."""
    out, n_smem = re.subn(r"extern __shared__[^;]*float (\w+)\[\];", r"float* \1 = g_smem;", cu)
    out, n_launch = re.subn(r"(\w+)<<<([^,]+),\s*([^,]+),\s*([^,]+),[^>]*>>>\(",
                            r"emu_launch(\1, \2, \3, \4, ", out)
    assert (n_smem, n_launch) == (1, 1), "kernel source no longer matches the host rewrite"
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
                    "-o", lib, str(d / "stse_fused_host.cpp")],
                   check=True, capture_output=True, timeout=300)
    so = ctypes.CDLL(lib)
    so.stse_fused_forward.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p] * 2
    so.stse_fused_forward.restype = ctypes.c_int
    return so


@pytest.mark.parametrize("input_dim,channels,hidden,t,v,batch", [
    (2, (32, 16, 32), 64, 12, 18, 2),  # flagship widths: 4-, 8- and 1-channel tiles
    (8, (8,), 8, 6, 5, 3),  # identity residuals, 30 nodes padded to 32
    (2, (16,), 8, 5, 7, 2),  # the last layer narrows, 35 nodes padded to 36
    (3, (24, 6), 12, 4, 7, 2),  # a narrowing middle layer, odd channel counts
])
def test_host_run_of_cuda_source_matches_plain(host_kernel, input_dim, channels, hidden, t, v,
                                                batch):
    gen = torch.Generator().manual_seed(0)
    model = STSE(input_dim=input_dim, layer_channels=channels, hidden_dimension=hidden,
                 latent_dim=4, n_frames=t, n_joints=v)
    model.reset_parameters(gen)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            lo, hi = (-0.5, 0.5) if name.endswith(".mean") else (0.5, 2.0)
            buf.copy_(torch.empty(buf.shape).uniform_(lo, hi, generator=gen))
    x = torch.randn(batch, input_dim, t, v, generator=gen)
    folded, packed = model.eval().folded()
    out = torch.full((batch, t * v, hidden), float("nan"))
    layout = np.ascontiguousarray(packed.layout, np.int64)
    rc = host_kernel.stse_fused_forward(
        x.data_ptr(), packed.weights.data_ptr(), layout.ctypes.data, len(layout), batch,
        packed.n_nodes, packed.n_pad, out.data_ptr(), None)
    assert rc == 0
    with torch.no_grad():
        ref = stse_fused.fused_stse_hidden_reference(x, folded)
    torch.testing.assert_close(out, ref, **TOL)
