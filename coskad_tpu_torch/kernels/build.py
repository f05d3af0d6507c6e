"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` into its own shared library with a
plain C interface and loaded with `ctypes`. Builds go to
`build/coskad_tpu_torch/` at the repository root (listed in `.gitignore`), at
first use, and are keyed by a hash of the source and the headers under
`csrc/`, so an edited kernel or header is never served from a stale
library. Several sources build in parallel (`build_all`), one `nvcc`
process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Dict, Iterable, List, Tuple

from ..utils.profiling import span

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "coskad_tpu_torch",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
KERNELS = ("stse_fused", "stse_train", "probe_bf16")

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
    """The source of kernel `name` and its library path, keyed by the source,
    every header under csrc/ (a source may include any of them) and the
    flags."""
    src = os.path.join(CSRC, f"{name}.cu")
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith((".cuh", ".h")))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (src, *(os.path.join(CSRC, h) for h in headers)):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


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
    with span("kernels.build"):
        started = [(name, *_start(name)) for name in names]
        failures = []
        for name, lib, proc, tmp in started:
            if proc is None:
                continue
            log = proc.communicate()[0].decode(errors="replace")
            if proc.returncode != 0:
                failures.append(f"nvcc failed for {name}.cu:\n{log}")
                continue
            os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file
            with open(lib + ".log", "w") as f:
                f.write(log)
        if failures:
            raise RuntimeError("\n".join(failures))
        return [lib for _, lib, _, _ in started]


def load(name: str, bind: Callable[[ctypes.CDLL], ctypes.CDLL]) -> ctypes.CDLL:
    """The loaded library for kernel `name`, building it first if needed;
    `bind` sets its entries' types once, when it is loaded."""
    with _lock:
        if name not in _loaded:
            with span("kernels.load"):
                (lib,) = build_all([name])
                _loaded[name] = bind(ctypes.CDLL(lib))
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
