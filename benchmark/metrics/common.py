"""Arithmetic the per-layer readers share."""

from __future__ import annotations

from benchmark import devtrace


def device_s(trace, prefixes) -> float:
    """Device seconds of the kernels whose names start with one of `prefixes`."""
    return sum(op.end - op.start for op in trace.kernels if op.name.startswith(prefixes)) / 1e6


def count(trace, prefixes) -> int:
    return sum(1 for op in trace.kernels if op.name.startswith(prefixes))


def idle_percent(ctx) -> float:
    """100 x (1 - the union of the device's operations over the traced window)."""
    trace = ctx["trace"]
    return 100.0 * (1.0 - devtrace.busy_s(trace) / trace.window_s)


def mfu_percent(ctx, kind: str) -> float:
    """The model's FLOPs over the untraced window's items, over its time, over
    the peak of the config's compute dtype."""
    window, config = ctx["window"], ctx["config"]
    flops = ctx["work"].model_flops(config, kind) * window["items"]
    peak = ctx["peaks"]["flops_per_s"][config["reference"]["compute_dtype"]]
    return 100.0 * flops / window["seconds"] / peak
