"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` into its own shared library with a
plain C interface and loaded with `ctypes`. Builds go to
`build/coskad_tpu_torch/` at the repository root (listed in `.gitignore`), at
first use, and are keyed by a hash of the source so an edited kernel is never
served from a stale library. Several sources build in parallel
(`build_all`), one `nvcc` process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List, Tuple

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "coskad_tpu_torch",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
KERNELS = ("stse_fused",)

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc or
    the one on PATH."""
    candidates = [
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc") or "",
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the port's CUDA kernels are compiled at first use"
    )


def _target(name: str) -> Tuple[str, str]:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _start(name: str):
    """Start nvcc for one source unless its library is already built.
    Returns (lib_path, process or None, tmp_path)."""
    src, lib = _target(name)
    if os.path.exists(lib):
        return lib, None, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return lib, proc, tmp


def build_all(names: Iterable[str] = KERNELS) -> List[str]:
    """Compile every named kernel (all nvcc processes run at once) and
    return the library paths. Raises with nvcc's output if one fails."""
    started = [(name, *_start(name)) for name in names]
    failures = []
    for name, lib, proc, tmp in started:
        if proc is None:
            continue
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: concurrent builders never see a partial file
        with open(lib + ".log", "w") as f:
            f.write(log)
    if failures:
        raise RuntimeError("\n".join(failures))
    return [lib for _, lib, _, _ in started]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel `name`, building it first if needed."""
    with _lock:
        if name not in _loaded:
            (lib,) = build_all([name])
            _loaded[name] = ctypes.CDLL(lib)
        return _loaded[name]


def ptxas_report(name: str) -> str:
    """nvcc's -Xptxas -v report (registers, shared memory, spills) from the
    build of `name`, or '' when the library was built by another process."""
    _, lib = _target(name)
    try:
        with open(lib + ".log") as f:
            return f.read()
    except FileNotFoundError:
        return ""
