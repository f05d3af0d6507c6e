"""Timing, tracing, NaN detection and device memory (counterpart of
`coskad_tpu/utils/profiling.py`).

- `Timer` / `throughput`: wall timing that waits for the result's CUDA
  devices (PyTorch returns before the card finishes), in windows/s;
- `trace`: a `torch.profiler` trace of the CPU and, where there is one, the
  card, written as a Chrome trace (chrome://tracing, Perfetto), with a
  warning where the card's side of it was lost;
- `debug_nans` / `enable_nan_checks`: raise at the first NaN an operation
  produces, in a forward or in a backward (JAX's `jax_debug_nans`);
- `device_memory_stats`: `torch.cuda.memory_stats` of each card.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from dataclasses import dataclass, field
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

TRACE_FILE = "trace.json"


def synchronize(result) -> None:
    """Wait for every CUDA device that holds a tensor of `result` (a tensor
    or a nest of them; others are ignored)."""
    devices = {t.device for t in tree_leaves(result)
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)


@dataclass
class Timer:
    """Accumulating wall timer that waits for the timed result's device."""

    name: str = "step"
    times: List[float] = field(default_factory=list)

    @contextlib.contextmanager
    def measure(self, result=None):
        t0 = time.perf_counter()
        yield
        if result is not None:
            synchronize(result)
        self.times.append(time.perf_counter() - t0)

    def stats(self) -> Dict[str, float]:
        if not self.times:
            return {}
        ts = sorted(self.times)
        return {
            f"{self.name}/mean_s": sum(ts) / len(ts),
            f"{self.name}/p50_s": ts[len(ts) // 2],
            f"{self.name}/min_s": ts[0],
            f"{self.name}/max_s": ts[-1],
            f"{self.name}/count": float(len(ts)),
        }


def throughput(fn, *args, items_per_call: int, warmup: int = 1, iters: int = 10) -> float:
    """items/s of fn(*args) over `iters` calls after `warmup` calls (kernel
    builds and caches), waiting for the results' devices."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    synchronize(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    synchronize(out)
    return items_per_call * iters / (time.perf_counter() - t0)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed code with `torch.profiler` (the CPU, and the card
    where CUDA is available) and write the Chrome trace to
    log_dir/trace.json; yields the profiler (`key_averages()` sums by
    kernel). The card's work is waited for before the trace stops. A trace
    of the card that holds no device event (CUPTI now and then loses a
    whole session's device activity) warns with a RuntimeWarning: the file
    then shows the host's side only, and the code should be traced again."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, TRACE_FILE)
    prof = profile(activities=activities)
    with prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    if cuda and device_event_count(prof) == 0:
        warnings.warn(f"torch.profiler recorded no device event while it traced the card: "
                      f"{path} holds the host's side only", RuntimeWarning, stacklevel=3)


def device_event_count(prof) -> int:
    """The device events (kernels, copies, sets) of a finished profiler."""
    return sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())


# operations whose output is uninitialized memory, which may hold NaN bits
_UNINITIALIZED = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
                  "resize_")


class NaNCheck(TorchDispatchMode):
    """Raises FloatingPointError at the first floating-point tensor with a
    NaN that an operation returns. It sees every ATen operation of the
    forward and, as the autograd engine carries the mode into its threads,
    of the backward (both checked on the CPU and on an H100). Each check
    reads a value back, so every operation waits for the card."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ not in _UNINITIALIZED:
            for t in tree_leaves(out):
                if (isinstance(t, torch.Tensor) and t.is_floating_point()
                        and bool(torch.isnan(t).any())):
                    raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Within the scope any NaN an operation produces raises: `NaNCheck` (a
    `TorchDispatchMode` that checks every operation's outputs) raises
    FloatingPointError in the forward and in the backward, and
    `torch.autograd.set_detect_anomaly` (which alone checks only the
    backward) adds the forward call's traceback to a backward error. A
    disabled scope changes nothing."""
    if not enable:
        yield
        return
    with torch.autograd.set_detect_anomaly(True), NaNCheck():
        yield


_GLOBAL_CHECK: List[NaNCheck] = []


def enable_nan_checks() -> None:
    """`debug_nans` for the rest of the process (on this thread)."""
    if _GLOBAL_CHECK:
        return
    torch.autograd.set_detect_anomaly(True)
    mode = NaNCheck()
    mode.__enter__()
    _GLOBAL_CHECK.append(mode)


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """{'cuda:<i>': torch.cuda.memory_stats(i)} for each card (bytes and
    counts of PyTorch's caching allocator); {} without CUDA."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": dict(torch.cuda.memory_stats(i))
            for i in range(torch.cuda.device_count())}
