"""bf16 operand probes: the port of `scripts/probe_mosaic.py` (P).

Each job of the probe (`run` :27, job bodies :56-97 and :107-138) is one
small function on two [32, 64, 256] f32 inputs that rounds them to bf16 and
exercises one operand form: a lhsT dot, mixed-dtype selects, a bf16 min,
transposes, a 2D x 3D dot. On the TPU each job compiled one Mosaic op class;
here each is a CUDA kernel of `csrc/probe_bf16.cu` on `__nv_bfloat16`
operands with f32 accumulation, beside its plain PyTorch version (`plain`).
They probe the bf16 forms the bf16 `compute_dtype` of K2-K5 will need on
Hopper. Nothing of the system's paths calls them.

Dispatch as for the other kernels: `run` launches the job's kernel on CUDA
tensors (or raises) and takes the plain version on CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..utils.profiling import LaunchCounter

SOURCE = "coskad_tpu_torch/kernels/csrc/probe_bf16.cu"
SHAPE = (32, 64, 256)  # (C, BB, N) of the probe
# In the order of the Job enum of csrc/probe_bf16.cu: (the job body, what
# it probes).
JOBS = {
    "dot0_bf16": ("scripts/probe_mosaic.py:56", "bf16 lhsT dot (contracting dim 0), f32 sums"),
    "dot0_small_bf16": ("scripts/probe_mosaic.py:65", "the same lhsT dot, without the eye"),
    "where_mixed": ("scripts/probe_mosaic.py:71", "bf16 select, bf16 predicate, 0.25 * b"),
    "min_bf16": ("scripts/probe_mosaic.py:78", "bf16 min(a, 0) times b, f32 sums"),
    "transpose_bf16": ("scripts/probe_mosaic.py:86", "bf16 (0, 2, 1) transpose, reshaped"),
    "dotg_bf16": ("scripts/probe_mosaic.py:91", "2D x 3D dot, bf16 operands, f32 sums"),
    "where_clean": ("scripts/probe_mosaic.py:107", "PReLU backward select, bf16 alpha * b"),
    "where_f32pred": ("scripts/probe_mosaic.py:115", "the same select, f32 predicate"),
    "where_const_scalar": ("scripts/probe_mosaic.py:121", "bf16 select, constant scalar"),
    "transpose_pure": ("scripts/probe_mosaic.py:127", "bf16 (0, 2, 1) transpose"),
    "transpose_merge": ("scripts/probe_mosaic.py:132", "transpose, then [C*N, BB] rows"),
}
_INDEX = {job: i for i, job in enumerate(JOBS)}
launches: Dict[str, LaunchCounter] = {job: LaunchCounter() for job in JOBS}


def inputs(device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """The probe's inputs: a, b = RandomState(0 and 1).randn(32, 64, 256), f32,
    on `device` (raises where CUDA is asked for and missing)."""
    dev = resolve_device(device)
    return tuple(torch.from_numpy(np.random.RandomState(i).randn(*SHAPE).astype(np.float32))
                 .to(dev) for i in range(2))


def _bf(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16)


def _where(pred: torch.Tensor, alpha: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    bv = _bf(b)
    return torch.where(pred < 0, alpha * bv, bv).float()


def plain(job: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The job's function in plain PyTorch (bf16 products are exact in f32,
    so every dot sums exact terms in f32)."""
    c, bb, n = SHAPE
    quarter = torch.tensor(0.25, dtype=torch.bfloat16, device=a.device)
    if job in ("dot0_bf16", "dot0_small_bf16"):
        m = _bf(a).float().reshape(c * bb, n)
        return (m.T @ m)[:c, :bb, None].expand(c, bb, n).contiguous()
    if job in ("where_mixed", "where_const_scalar"):
        return _where(_bf(a), quarter, b)
    if job == "where_clean":
        return _where(_bf(a), _bf(a[0, 0, 0]), b)
    if job == "where_f32pred":
        return _where(a, _bf(a[0, 0, 0]), b)
    if job == "min_bf16":
        zero = torch.zeros((), dtype=torch.bfloat16, device=a.device)
        r = (_bf(b).float() * torch.minimum(_bf(a), zero).float()).sum((1, 2))
        return r[:, None, None].expand(c, bb, n).contiguous()
    if job == "transpose_bf16":
        return _bf(a).transpose(1, 2).reshape(c, bb, n).float()
    if job == "transpose_pure":
        return _bf(a).transpose(1, 2).float().contiguous()
    if job == "dotg_bf16":
        w = torch.ones((c, c), dtype=torch.bfloat16, device=a.device)
        return (w.float() @ _bf(a).float().reshape(c, bb * n)).reshape(c, bb, n)
    if job == "transpose_merge":
        h = _bf(a).transpose(1, 2).reshape(c * n, bb)
        return h[:c, :bb, None].expand(c, bb, n).float().contiguous()
    raise ValueError(f"unknown probe job {job!r}")


def work(job: str) -> Tuple[float, float]:
    """(operations, bytes) the job needs: the input elements its output
    depends on, read once, and the output written once; a dot's
    multiply-adds as 2 operations. dot0's output [:C, :BB] needs only the
    first BB columns of a's [C*BB, N] rows; transpose_merge's needs only
    a[0, :, :C]."""
    c, bb, n = SHAPE
    count = c * bb * n
    reads = {"dot0_bf16": c * bb * bb, "dot0_small_bf16": c * bb * bb,
             "transpose_merge": bb * c, "transpose_bf16": count, "transpose_pure": count,
             "dotg_bf16": count}.get(job, 2 * count)
    ops = {"dot0_bf16": 2 * c * bb * c * bb, "dot0_small_bf16": 2 * c * bb * c * bb,
           "dotg_bf16": 2 * c * c * bb * n, "min_bf16": 2 * count}.get(job, count)
    return float(ops), 4.0 * (reads + count)


def bind(lib):
    """Set the argument and return types of the kernel library's C entries
    (the built library, a variant of it, or the host emulation's) and read
    each job's workspace size; returns `lib`."""
    lib.probe_bf16_run.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5
    lib.probe_bf16_run.restype = ctypes.c_int
    lib.probe_bf16_workspace.argtypes = [ctypes.c_int]
    lib.probe_bf16_workspace.restype = ctypes.c_int
    lib.probe_bf16_error_string.argtypes = [ctypes.c_int]
    lib.probe_bf16_error_string.restype = ctypes.c_char_p
    lib.workspace_floats = [lib.probe_bf16_workspace(i) for i in range(len(JOBS))]
    return lib


def _library():
    from . import build

    return build.load("probe_bf16", bind)


def _launch(lib, job: str, a, b, out) -> int:
    """Launch the job on the current device's current stream, its
    partials' workspace (dot0, min_bf16) from PyTorch's allocator."""
    i = _INDEX[job]
    floats = lib.workspace_floats[i]
    work = torch.empty((floats,), dtype=torch.float32, device=a.device) if floats else None
    return lib.probe_bf16_run(i, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                              None if work is None else work.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)


def run(job: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The job on a, b [32, 64, 256] f32: its kernel for CUDA tensors, its
    plain version for CPU tensors."""
    if job not in JOBS:
        raise ValueError(f"unknown probe job {job!r}")
    if not a.is_cuda:
        if a.device.type != "cpu":
            raise ValueError(f"the probe runs on CUDA or CPU tensors, not {a.device}")
        return plain(job, a, b)
    for t in (a, b):
        if t.dtype != torch.float32 or tuple(t.shape) != SHAPE or t.device != a.device:
            raise ValueError(f"probe inputs must be float32 {SHAPE} on {a.device}")
    a, b = a.contiguous(), b.contiguous()
    c, bb, n = SHAPE
    out = torch.empty((c, n, bb) if job == "transpose_pure" else SHAPE, dtype=torch.float32,
                      device=a.device)
    lib = _library()
    if a.device.index == torch.cuda.current_device():
        err = _launch(lib, job, a, b, out)
    else:
        with torch.cuda.device(a.device):
            err = _launch(lib, job, a, b, out)
    if err != 0:
        raise RuntimeError(f"probe_bf16 {job} launch failed: "
                           f"{lib.probe_bf16_error_string(err).decode()}")
    launches[job].value += 1
    return out
