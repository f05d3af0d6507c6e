"""P, the bf16 operand probes: the port's plain versions
(`coskad_tpu_torch/kernels/probe.py::plain`) against the jnp expressions of
the job bodies of scripts/probe_mosaic.py, on the probe's own inputs.

The job bodies are nested in `main` / `extra_jobs` and read Pallas refs, so
they are restated here on arrays, line for line. Elementwise jobs must agree
exactly (bf16 rounding is round to nearest even in both, and a product of
two bf16 values is exact in f32 before it is rounded). The sums (dots, min)
agree to f32 reassociation over up to 16,384 terms. The CUDA source also
runs on host threads (tests/cuda_host_emu.h) for the jobs that are quick
there: every job, each in seconds."""

import ctypes
import os
import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coskad_tpu_torch.kernels import probe

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
C, BB, N = probe.SHAPE
bf = jnp.bfloat16
SUM_TOL = dict(rtol=1e-5, atol=2e-3)


def _dot0(a, b):
    a = a.astype(bf).reshape(C * BB, N)
    r = jax.lax.dot_general(a, a, (((0,), (0,)), ((), ())), preferred_element_type=jnp.float32)
    return jnp.broadcast_to(r[:C, :BB][:, :, None], (C, BB, N))


def _where_const(a, b):
    a, b = a.astype(bf), b.astype(bf)
    return jnp.where(a < 0, jnp.float32(0.25).astype(bf) * b, b).astype(jnp.float32)


def _min_bf16(a, b):
    a, b = a.astype(bf), b.astype(bf)
    r = jnp.sum(jnp.sum(b.astype(jnp.float32) * jnp.minimum(a, 0).astype(jnp.float32), axis=2),
                axis=1)
    return jnp.broadcast_to(r[:, None, None], (C, BB, N))


def _transpose_bf16(a, b):
    return jnp.transpose(a.astype(bf), (0, 2, 1)).reshape(C, BB, N).astype(jnp.float32)


def _dotg_bf16(a, b):
    w = jnp.ones((C, C), bf)
    return jax.lax.dot_general(w, a.astype(bf), (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.float32)


def _where_clean(a, b):
    alpha = a[0, 0, 0].astype(bf)
    a, b = a.astype(bf), b.astype(bf)
    return jnp.where(a < 0, alpha * b, b).astype(jnp.float32)


def _where_f32pred(a, b):
    alpha = a[0, 0, 0].astype(bf)
    return jnp.where(a < 0, alpha * b.astype(bf), b.astype(bf)).astype(jnp.float32)


def _transpose_pure(a, b):
    return jnp.transpose(a.astype(bf), (0, 2, 1)).astype(jnp.float32)


def _transpose_merge(a, b):
    h = jnp.transpose(a.astype(bf), (0, 2, 1)).reshape(C * N, BB)
    return jnp.broadcast_to(h[:C, :BB][:, :, None], (C, BB, N)).astype(jnp.float32)


JAX_JOBS = {
    "dot0_bf16": _dot0, "dot0_small_bf16": _dot0, "where_mixed": _where_const,
    "min_bf16": _min_bf16, "transpose_bf16": _transpose_bf16, "dotg_bf16": _dotg_bf16,
    "where_clean": _where_clean, "where_f32pred": _where_f32pred,
    "where_const_scalar": _where_const, "transpose_pure": _transpose_pure,
    "transpose_merge": _transpose_merge,
}
SUMS = ("dot0_bf16", "dot0_small_bf16", "min_bf16", "dotg_bf16")


@pytest.mark.parametrize("job", sorted(probe.JOBS))
def test_plain_matches_probe_job_body(job):
    a, b = probe.inputs("cpu")
    before = probe.launches[job].value
    got = probe.run(job, a, b).numpy()  # a CPU tensor: the plain version, no launch
    assert probe.launches[job].value == before
    want = np.asarray(JAX_JOBS[job](jnp.asarray(a.numpy()), jnp.asarray(b.numpy())))
    assert got.shape == want.shape and got.dtype == np.float32
    if job in SUMS:
        np.testing.assert_allclose(got, want, **SUM_TOL)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/probe_bf16.cu compiled with g++ against tests/cuda_host_emu.h."""
    from coskad_tpu_torch.kernels import build

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to run the CUDA source on the host")
    with open(os.path.join(build.CSRC, "probe_bf16.cu")) as f:
        src = f.read().replace("#include <cuda_bf16.h>\n", "")
    src, n_launch = re.subn(r"(\w+)<<<([^,]+),\s*([^,]+),\s*([^,]+),[^>]*>>>\(",
                            r"emu_launch(\1, \2, \3, \4, ", src)
    assert n_launch == 10, "kernel source no longer matches the host rewrite"
    d = tmp_path_factory.mktemp("probe_host")
    (d / "probe_host.cpp").write_text(
        src.replace("#include <cuda_runtime.h>", '#include "cuda_host_emu.h"'))
    lib = str(d / "libprobe_host.so")
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-I", HERE, "-I",
                    build.CSRC, "-o", lib, str(d / "probe_host.cpp")], check=True,
                   capture_output=True, timeout=300)
    so = probe.bind(ctypes.CDLL(lib))
    so.emu_mma_count.argtypes = [ctypes.c_int]
    so.emu_mma_count.restype = ctypes.c_longlong
    return so


_FIRST_HOST_RUN = {}  # job -> the output of its first host run


def host_run(lib, job, a, b):
    """The job's CUDA source run on host threads (its workspace NaN at the
    start): (output, bf16 mma calls)."""
    out = torch.empty(a.numel())
    work = torch.full((max(lib.workspace_floats[probe._INDEX[job]], 1),), float("nan"))
    lib.emu_mma_count(1)
    assert lib.probe_bf16_run(probe._INDEX[job], a.data_ptr(), b.data_ptr(), out.data_ptr(),
                              work.data_ptr(), None) == 0
    _FIRST_HOST_RUN.setdefault(job, out)
    return out, lib.emu_mma_count(1)


@pytest.mark.parametrize("job", list(probe.JOBS))
def test_host_run_of_cuda_source_matches_plain(host_lib, job):
    a, b = probe.inputs("cpu")
    out, mma = host_run(host_lib, job, a, b)
    want = probe.plain(job, a, b).reshape(-1)
    if job in SUMS:
        np.testing.assert_allclose(out.numpy(), want.numpy(), **SUM_TOL)
    else:
        np.testing.assert_array_equal(out.numpy(), want.numpy())
    # dot0 runs on the bf16 mma: 128 blocks x 4 warps x 4 m16n8k16 tiles
    assert mma == (2048 if job.startswith("dot0") else 0)


@pytest.mark.parametrize("job", SUMS)
def test_host_runs_of_sum_jobs_give_the_same_bits(host_lib, job):
    """The sums' partials are summed in a fixed order: two runs, one result."""
    a, b = probe.inputs("cpu")
    first = _FIRST_HOST_RUN.get(job)
    if first is None:
        first, _ = host_run(host_lib, job, a, b)
    second, _ = host_run(host_lib, job, a, b)
    assert torch.equal(first, second)


def test_inputs_default_to_cuda():
    """`inputs()` is an entry point: it runs on the card unless asked for the
    CPU, and raises where there is no CUDA."""
    if torch.cuda.is_available():
        assert probe.inputs()[0].is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            probe.inputs()
    a, b = probe.inputs("cpu")
    assert a.device.type == b.device.type == "cpu" and not torch.equal(a, b)


def test_jobs_follow_the_kernel_enum_and_work():
    """probe.JOBS is in the order of csrc/probe_bf16.cu's Job enum; every
    job reads at most two inputs and writes one [32, 64, 256] output; dot0
    and transpose_merge read only the part of `a` their output needs."""
    from coskad_tpu_torch.kernels import build

    with open(f"{build.CSRC}/probe_bf16.cu") as f:
        src = f.read()
    body = src[src.index("enum Job {") + len("enum Job {"):src.index("JOB_COUNT")]
    assert [s.strip().lower() for s in body.split(",") if s.strip()] == list(probe.JOBS)
    assert sorted(JAX_JOBS) == sorted(probe.JOBS)
    out = 4 * C * BB * N
    part = {"dot0_bf16": 4 * C * BB * BB, "dot0_small_bf16": 4 * C * BB * BB,
            "transpose_merge": 4 * BB * C}
    for job in probe.JOBS:
        ops, nbytes = probe.work(job)
        assert 0 < ops
        if job in part:
            assert nbytes == out + part[job]
        else:
            assert 2 * out <= nbytes <= 3 * out
    with pytest.raises(ValueError, match="unknown probe job"):
        probe.run("nope", *probe.inputs("cpu"))
