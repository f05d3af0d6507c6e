"""The native (C++) clip and CSV parser: build-on-demand loader + shim.

Counterpart of `coskad_tpu/data/native.py`, with its own copy of the source
(`csrc/coskad_native.cpp`, built as the CPython extension
`_coskad_torch_native`). `parse_clip_json_native` is a drop-in replacement
for the `json.load` path of `data/alphapose.py`: the extension single-passes
the clip JSON into per-person flat keypoint buffers, and this shim keeps the
pure-Python path's ordering and merging: lexicographic frame-key row order,
numeric frame-key window order, a duplicate top-level person key replaced
whole by the last one, the list-of-dicts person form merged with later frame
keys winning, zero-detection persons skipped, `kp_threshold` masking.
`load_csv_native` / `load_csv_files_native` read Morais trajectory CSVs
(the batched one on a C++ thread pool, off the GIL).

The extension is compiled with g++ on first use into
`build/coskad_tpu_torch/` at the repository root (listed in `.gitignore`)
and rebuilt when the source is newer than the library. Several processes
may build at once (pytest-xdist workers): each compiles to a name of its
own in that directory and `os.replace`s it into place, so a process loads
either the old library or a whole new one. Without a toolchain every
function returns None and the callers fall back to `json.load` / numpy.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
import sysconfig
import threading
import uuid
from typing import List, Optional

import numpy as np

from .windows import PersonTrajectory

MODULE = "_coskad_torch_native"
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "coskad_native.cpp")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "coskad_tpu_torch",
)
SO = os.path.join(BUILD_DIR, MODULE + (sysconfig.get_config_var("EXT_SUFFIX") or ".so"))

_lock = threading.Lock()
_module = None
_build_failed = False


def _build() -> None:
    """Compile SRC to a unique temporary name beside SO, then move it into
    place in one step."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{SO}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp"
    include = sysconfig.get_paths()["include"]
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", f"-I{include}",
                        SRC, "-o", tmp], check=True, capture_output=True, text=True)
        os.replace(tmp, SO)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load_native():
    global _module, _build_failed
    if _module is not None or _build_failed:
        return _module
    with _lock:
        if _module is not None or _build_failed:
            return _module
        try:
            if not os.path.exists(SO) or os.path.getmtime(SRC) > os.path.getmtime(SO):
                _build()
            spec = importlib.util.spec_from_file_location(MODULE, SO)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _module = mod
        except Exception as e:  # no toolchain, or a build error
            detail = getattr(e, "stderr", "") or ""
            print(f"[coskad] native parser unavailable ({e}{': ' + detail if detail else ''}); "
                  "falling back to json.load", file=sys.stderr)
            _build_failed = True
    return _module


def native_available() -> bool:
    return _load_native() is not None


def parse_clip_json_native(path: str, kp_threshold: float = 0.0
                           ) -> Optional[List[PersonTrajectory]]:
    """Parse a clip JSON with the C++ extension; None if unavailable."""
    mod = _load_native()
    if mod is None:
        return None
    with open(path, "rb") as f:
        raw = f.read()
    persons = mod.parse_clip(raw)

    # A duplicate TOP-LEVEL person key follows json.load (the last one wins
    # whole); the list-of-dicts form, concatenated in file order by the
    # parser, merges frames with later duplicates winning (dict.update).
    by_id = {}
    for pid, keys, kp_bytes, off_bytes, cnt_bytes in persons:
        kps = np.frombuffer(kp_bytes, dtype=np.float64)
        offsets = np.frombuffer(off_bytes, dtype=np.uint64)
        counts = np.frombuffer(cnt_bytes, dtype=np.uint64)
        entry = {}
        for key, off, cnt in zip(keys, offsets, counts):
            entry[key] = kps[int(off):int(off) + int(cnt)]
        by_id[pid] = entry

    trajectories = []
    for pid in sorted(by_id.keys(), key=lambda x: int(x)):
        entry = by_id[pid]
        if not entry:  # zero-detection person: no windows
            continue
        lex_keys = sorted(entry.keys())  # lexicographic row order
        rows = []
        for key in lex_keys:
            kp = entry[key].reshape(-1, 3).copy()
            if kp_threshold > 0:
                low = kp[:, 2] < kp_threshold
                kp[low, :2] = 0.0
            rows.append(kp)
        trajectories.append(PersonTrajectory(
            person_id=int(pid), frame_keys=sorted(int(k) for k in lex_keys),
            keypoints=np.stack(rows, axis=0)))
    return trajectories


def load_csv_native(path: str) -> Optional[np.ndarray]:
    """A Morais trajectory CSV as [rows, cols] float64; None when the
    extension is unavailable."""
    mod = _load_native()
    if mod is None:
        return None
    with open(path, "rb") as f:
        raw = f.read()
    n_rows, n_cols, buf = mod.parse_csv(raw)
    if n_rows == 0:
        return np.empty((0, 0))
    return np.frombuffer(buf, dtype=np.float64).reshape(n_rows, n_cols)


def load_csv_files_native(paths: List[str], n_threads: int = 0
                          ) -> Optional[List[np.ndarray]]:
    """Read and parse many Morais CSVs on a C++ thread pool: [rows, cols]
    float64 arrays aligned with `paths`, or None when the extension is
    unavailable. n_threads <= 0 means the hardware's concurrency. An error
    names the file."""
    mod = _load_native()
    if mod is None:
        return None
    out = []
    for n_rows, n_cols, buf in mod.parse_csv_files(list(paths), n_threads):
        out.append(np.empty((0, 0)) if n_rows == 0 else
                   np.frombuffer(buf, dtype=np.float64).reshape(n_rows, n_cols))
    return out
