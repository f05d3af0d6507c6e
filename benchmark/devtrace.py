"""One torch.profiler window over steady-state work, reduced to what the
per-layer readers need: the device's operations as (name, start, end) in
microseconds, the host's operations beside them, and the window's bounds.

`kernel_name` and the retry of a trace that lost its device events are
copied from the port's chip check (`chip_smoke.py::kernel_name`,
`device_events`); the benchmark imports nothing of that script.
"""

from __future__ import annotations

import sys
from typing import Callable, List, NamedTuple, Optional, Tuple

TRACE_TRIES = 3
WINDOW_LABEL = "bench.window"
NOT_KERNELS = ("Memcpy", "Memset")  # device operations that are copies, not kernels


class Op(NamedTuple):
    name: str
    start: float  # us, the profiler's clock
    end: float


class Trace(NamedTuple):
    device: List[Op]  # every device operation, kernels and copies, by start
    host: List[Op]  # every host operation but the window's own label
    start: float  # the traced window, us
    end: float

    @property
    def kernels(self) -> List[Op]:
        return [op for op in self.device if not op.name.startswith(NOT_KERNELS)]

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6


def kernel_name(name: str) -> str:
    """A kernel's name with its namespace, template and arguments cut off."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
    return name[len("void "):] if name.startswith("void ") else name


def capture(fn: Callable[[], None], host: bool) -> Trace:
    """Trace one call of fn (which launches device work), ended by a
    synchronize. With `host`, the host's operations too, under a labelled
    window: that names what the host did in each idle gap, but recording
    every host operation slows a host-bound loop by up to 2x, so the
    device's own numbers come from a trace without it, whose window runs
    from its first device operation to its last. A trace with no device
    operation is one the profiler lost: fn is called and traced again, up
    to TRACE_TRIES times, and then the run fails; it is never read as
    zero."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU] if host else []
    for attempt in range(TRACE_TRIES):
        with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW_LABEL):
                fn()
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
        events = prof.events()
        device, hosted, window = [], [], None
        for e in events:
            op = Op(e.name, float(e.time_range.start), float(e.time_range.end))
            on_device = e.device_type == torch.autograd.DeviceType.CUDA
            if on_device and not e.is_user_annotation:
                device.append(Op(kernel_name(e.name), op.start, op.end))
            elif on_device:
                continue  # a labelled range's shadow on the device's timeline, not work
            elif e.name == WINDOW_LABEL:
                window = op
            else:
                hosted.append(op)
        if device and not host:
            device.sort(key=lambda o: o.start)
            return Trace(device, [], device[0].start, max(op.end for op in device))
        if device and window is not None:
            device.sort(key=lambda o: o.start)
            return Trace(device, hosted, window.start, window.end)
        print(f"torch.profiler recorded no device operation in trace {attempt + 1} of "
              f"{TRACE_TRIES}", file=sys.stderr)
    raise RuntimeError(f"torch.profiler recorded no device operation in {TRACE_TRIES} traces")


def busy_intervals(trace: Trace) -> List[Tuple[float, float]]:
    """The union of the device operations' intervals, clipped to the window."""
    merged: List[List[float]] = []
    for op in trace.device:
        s, e = max(op.start, trace.start), min(op.end, trace.end)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_s(trace: Trace) -> float:
    return sum(e - s for s, e in busy_intervals(trace)) / 1e6


def idle_gaps(trace: Trace) -> List[Tuple[float, float]]:
    """The window's stretches with no device operation running."""
    gaps, at = [], trace.start
    for s, e in busy_intervals(trace):
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if trace.end > at:
        gaps.append((at, trace.end))
    return gaps


def host_at(trace: Trace, t: float) -> Optional[str]:
    """The innermost host operation running at time t."""
    best = None
    for op in trace.host:
        if op.start <= t <= op.end and (best is None or op.start >= best.start):
            best = op
    return None if best is None else best.name


def device_seconds_by_name(trace: Trace) -> dict:
    out: dict = {}
    for op in trace.device:
        out[op.name] = out.get(op.name, 0.0) + (op.end - op.start) / 1e6
    return out


def breakdown(device_trace: Trace, host_trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time (from the trace without
    the host), and the longest idle gaps, each named by the innermost host
    operation in its middle (from the trace with the host, where the
    gaps are longer by the profiler's cost on the host)."""
    ops = sorted(device_seconds_by_name(device_trace).items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(host_trace), key=lambda g: g[0] - g[1])[:top]
    named = [[host_at(host_trace, (s + e) / 2) or "no host operation", (e - s) / 1e6]
             for s, e in gaps]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}
