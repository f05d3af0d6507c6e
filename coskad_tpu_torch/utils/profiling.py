"""Timing, tracing, NaN detection and device memory (counterpart of
`coskad_tpu/utils/profiling.py`).

- `span` / `span_stats` / `reset_spans`: the program's own spans, opened
  at the boundaries of the scoring path and of set-up, and their
  per-name aggregates (count, total and self time, median and p95);
- `LaunchCounter`: the kernels' launch counters;
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
import math
import os
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

TRACE_FILE = "trace.json"


class LaunchCounter:
    """Counts kernel launches, so a run can show its path went through the
    kernel. Only a wrapper's CUDA branch adds to it."""

    def __init__(self):
        self.value = 0


# A span's durations are kept in log buckets: 32 a power of two above 64 ns
# (each value below exact), so a bucket's middle is within 1/64 of any
# duration in it. Bucket of d ns: d below 64, else (shift << 5) + (d >> shift)
# with shift = d.bit_length() - 6 (inlined in `span.__exit__`).
_EXACT_BITS = 6


def _bucket_middle(index: int) -> float:
    """The middle of the durations (ns) that fall in bucket `index`."""
    shift = max((index >> (_EXACT_BITS - 1)) - 1, 0)
    low = (index - (shift << (_EXACT_BITS - 1))) << shift
    return low + ((1 << shift) - 1) / 2


class _SpanAggregate:
    """One span name's count, total and self time, extremes and duration
    buckets, in fixed memory."""

    __slots__ = ("count", "total_ns", "self_ns", "min_ns", "max_ns", "buckets")

    def __init__(self):
        self.count = self.total_ns = self.self_ns = self.max_ns = 0
        self.min_ns = 1 << 62
        self.buckets: Dict[int, int] = {}

    def quantile_ns(self, q: float) -> float:
        """The nearest-rank q-quantile of the durations, to a bucket's middle
        (clipped to the extremes, which are exact)."""
        rank = max(1, math.ceil(q * self.count))
        seen = 0
        for b in sorted(self.buckets):
            seen += self.buckets[b]
            if seen >= rank:
                return min(max(_bucket_middle(b), self.min_ns), self.max_ns)
        return float(self.max_ns)

    def summary(self) -> Dict[str, float]:
        return {"count": self.count, "total_s": self.total_ns / 1e9,
                "self_s": self.self_ns / 1e9, "min_s": self.min_ns / 1e9,
                "median_s": self.quantile_ns(0.5) / 1e9, "p95_s": self.quantile_ns(0.95) / 1e9,
                "max_s": self.max_ns / 1e9}


class _OpenSpans(threading.local):
    top: Optional["span"] = None  # the innermost open span of this thread


_open = _OpenSpans()
_aggregates: Dict[str, _SpanAggregate] = {}
_aggregates_lock = threading.Lock()
_clock_ns = time.perf_counter_ns


class span:
    """A named stretch of the program's host time:

        with span("eval.batch"):
            ...

    It records its host start and end (`time.perf_counter_ns`) and the
    span that encloses it on this thread (`parent`), and on exit adds its
    duration and self time (the duration minus its child spans') to its
    name's aggregates (`span_stats`). While a `torch.profiler` records, it
    also opens a `record_function`, so it sits in the trace on the
    device's clock, and it adds nothing to the aggregates: the profiler's
    cost never enters them. `args` (a string, such as a request's number)
    labels one instance in the trace: its event is named "<name>:<args>",
    as the profiler keeps no other label of a `record_function`. A hot
    loop's spans pass `profiled=False` and stay out of the trace too: a
    `record_function` a batch slows the loop being traced (on an H100's
    host, three a batch of a host-bound scoring pass idled the card ~9
    points more under the profiler). With no profiler a span does two
    clock reads and the update, nothing else.

    Open spans only outside any `nn.Module.forward`, autograd `Function`
    or code `torch.export` traces."""

    __slots__ = ("name", "args", "profiled", "parent", "start_ns", "end_ns", "child_ns",
                 "_recorded")

    def __init__(self, name: str, args: Optional[str] = None, profiled: bool = True):
        self.name = name
        self.args = args
        self.profiled = profiled

    def __enter__(self) -> "span":
        self.parent = _open.top
        _open.top = self
        self.child_ns = 0
        if self.profiled and _autograd_profiler._is_profiler_enabled:
            self._recorded = _autograd_profiler.record_function(
                self.name if self.args is None else f"{self.name}:{self.args}")
            self._recorded.__enter__()
        else:
            self._recorded = None
        self.start_ns = _clock_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = end = _clock_ns()
        if self._recorded is not None:
            self._recorded.__exit__(*exc)
        _open.top = parent = self.parent
        d = end - self.start_ns
        if parent is not None:
            parent.child_ns += d
        if self._recorded is not None or _autograd_profiler._is_profiler_enabled:
            return
        shift = d.bit_length() - _EXACT_BITS
        bucket = (shift << (_EXACT_BITS - 1)) + (d >> shift) if shift > 0 else d
        _aggregates_lock.acquire()
        try:
            agg = _aggregates.get(self.name)
            if agg is None:
                agg = _aggregates[self.name] = _SpanAggregate()
            agg.count += 1
            agg.total_ns += d
            agg.self_ns += d - self.child_ns
            if d < agg.min_ns:
                agg.min_ns = d
            if d > agg.max_ns:
                agg.max_ns = d
            agg.buckets[bucket] = agg.buckets.get(bucket, 0) + 1
        finally:
            _aggregates_lock.release()

    @property
    def seconds(self) -> float:
        """The closed span's duration."""
        return (self.end_ns - self.start_ns) / 1e9


def span_stats() -> Dict[str, Dict[str, float]]:
    """{name: {count, total_s, self_s, min_s, median_s, p95_s, max_s}} of
    every span closed in this process since the last `reset_spans`, bar
    those a profiler recorded. The median and p95 are within 2% of the
    durations' own."""
    with _aggregates_lock:
        return {name: agg.summary() for name, agg in _aggregates.items()}


def reset_spans() -> None:
    """Forget every span's aggregates."""
    with _aggregates_lock:
        _aggregates.clear()


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
