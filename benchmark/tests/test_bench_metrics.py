"""The metric arithmetic on synthetic traces and windows."""

from __future__ import annotations

import math
import os

import numpy as np
import pytest
import torch

from benchmark import devtrace, harness
from benchmark.tests.small import SMALL

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _trace():
    # window 0-1000 us; kernels overlap at 100-300 and 250-400, a copy at 600-650
    dev = [devtrace.Op("fwd_pre_kernel", 100, 300), devtrace.Op("bwd_dx_kernel", 250, 400),
           devtrace.Op("Memcpy HtoD (Pageable -> Device)", 600, 650),
           devtrace.Op("stse_fused_kernel", 800, 900), devtrace.Op("late", 950, 1200)]
    host = [devtrace.Op("aten::index_select", 400, 620), devtrace.Op("aten::item", 420, 480),
            devtrace.Op("cudaStreamSynchronize", 650, 800)]
    return devtrace.Trace(dev, host, 0.0, 1000.0)


def test_busy_union_and_idle_gaps():
    t = _trace()
    assert devtrace.busy_intervals(t) == [(100, 400), (600, 650), (800, 900), (950, 1000)]
    assert devtrace.busy_s(t) == pytest.approx(500e-6)
    assert devtrace.idle_gaps(t) == [(0, 100), (400, 600), (650, 800), (900, 950)]
    assert t.window_s == pytest.approx(1e-3)
    assert [op.name for op in t.kernels] == ["fwd_pre_kernel", "bwd_dx_kernel",
                                              "stse_fused_kernel", "late"]


def test_breakdown_names_the_host_in_each_gap():
    b = devtrace.breakdown(_trace(), _trace())
    assert b["idle_gaps"][0] == ["aten::index_select", pytest.approx(200e-6)]
    assert b["idle_gaps"][1] == ["cudaStreamSynchronize", pytest.approx(150e-6)]
    assert b["idle_gaps"][2] == ["no host operation", pytest.approx(100e-6)]
    assert b["device_ops"][0] == ["late", pytest.approx(250e-6)]


def test_kernel_name():
    raw = ("void (anonymous namespace)::fwd_pre_kernel<(Dtype)0, 16>(float const*, int)")
    assert devtrace.kernel_name(raw) == "fwd_pre_kernel"


def _reader(name):
    return harness.load_module(os.path.join(BENCH, "metrics", f"{name}.py"), name)


def test_readers_on_a_synthetic_trace():
    flag = harness.Cell("flagship-train")
    ctx = dict(trace=_trace(), units=2, window={"items": 4096.0, "seconds": 0.5},
               config=flag.config, work=flag.work, peaks=flag.peaks)
    idle = _reader("idle_share.train").read(ctx)
    assert idle == pytest.approx(50.0)
    assert _reader("launches_per_step.train").read(ctx) == 2.0
    bound = flag.work.train_kernels_bound_s(flag.config, 2048, 64, flag.peaks)
    assert _reader("train_kernels_roofline").read(ctx) == pytest.approx(
        100 * 2 * bound / 350e-6)
    k1 = flag.work.k1_bound_s(flag.config, 2048, flag.peaks)
    assert _reader("k1_roofline").read(ctx) == pytest.approx(100 * k1 / 100e-6)
    per_item = flag.work.model_flops(flag.config, "train")
    assert _reader("mfu.train").read(ctx) == pytest.approx(
        100 * per_item * 4096 / 0.5 / 1.65e14)
    # no kernel of its own in the trace: the reader returns nothing, never 0
    empty = dict(ctx, trace=devtrace.Trace([devtrace.Op("x", 0, 1)], [], 0.0, 10.0))
    assert _reader("k1_roofline").read(empty) is None
    assert _reader("train_kernels_roofline").read(empty) is None
    hr = harness.Cell("hrstc-train")
    assert _reader("train_kernels_roofline").read(dict(ctx, work=hr.work, config=hr.config)) is None


def test_request_rate_and_p95_are_over_every_request(monkeypatch):
    cell = harness.Cell("hrstc-requests", SMALL)
    run = cell.kind.Run(cell, 5, torch.device("cpu"))
    run.setup()
    took = iter(np.linspace(0.001, 0.1, 100))
    clock = {"t": 0.0}

    def fake_send():
        i = int(run.order[run.next % len(run.order)])
        run.next += 1
        dt = next(took)
        clock["t"] += dt
        return i, np.zeros(run.sizes[i], np.float32), dt

    monkeypatch.setattr(run, "_send", fake_send)
    monkeypatch.setattr(cell.kind.time, "perf_counter", lambda: clock["t"])
    stats = run.window(seconds=sum(np.linspace(0.001, 0.1, 100)) - 1e-9)
    assert stats["attempted"] == 100
    lat = np.linspace(0.001, 0.1, 100)
    assert stats["end_to_end"]["request_ms_p95"] == pytest.approx(np.percentile(lat, 95) * 1e3)
    windows = sum(run.sizes[int(run.order[j % len(run.order)])] for j in range(100))
    assert stats["end_to_end"]["score_windows_per_s"] == pytest.approx(windows / lat.sum())


def test_train_rate_is_whole_epochs_over_the_window(monkeypatch):
    cell = harness.Cell("flagship-train", SMALL)
    run = cell.kind.Run(cell, 5, torch.device("cpu"))
    run.setup()
    clock = {"t": 0.0}

    def fake_epoch():
        clock["t"] += 0.4
        return 1.0

    monkeypatch.setattr(run, "_epoch", fake_epoch)
    monkeypatch.setattr(cell.kind.time, "perf_counter", lambda: clock["t"])
    stats = run.window(seconds=1.0)  # three epochs: 0.4, 0.8, 1.2 s
    items = 3 * run.steps_per_epoch * run.batch
    assert stats["items"] == items
    assert stats["end_to_end"]["train_windows_per_s"] == pytest.approx(items / 1.2)
    assert not math.isnan(stats["seconds"])
