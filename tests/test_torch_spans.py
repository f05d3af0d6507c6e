"""The port's spans and counters (`coskad_tpu_torch/utils/profiling.py`), on
the CPU: nesting and self time against a hand-made nest, the quantiles'
buckets, one stack a thread, nothing aggregated while a `torch.profiler`
records and every span in its trace around the operations it wrapped, the
spans a scoring request opens, K1's fold counted only when it rebuilds,
the launch counters the benchmark reads, and a `torch.export` of the
scoring program that no span reaches."""

import math
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from coskad_tpu_torch import config as tconfig
from coskad_tpu_torch.data.windows import SegmentDataset
from coskad_tpu_torch.export_hlo import scoring_program
from coskad_tpu_torch.kernels import probe, stse_fused, stse_train
from coskad_tpu_torch.serve import AnomalyScorer
from coskad_tpu_torch.train.loop import Trainer
from coskad_tpu_torch.utils import profiling
from coskad_tpu_torch.utils.profiling import span

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def no_spans():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


class FakeClock:
    """perf_counter_ns from a list of readings."""

    def __init__(self, readings):
        self.readings = iter(readings)

    def __call__(self):
        return next(self.readings)


def test_nesting_and_self_time_against_a_hand_made_nest(monkeypatch):
    # outer [0, 100] holds a [10, 30] and b [40, 70], b holds c [50, 60]
    monkeypatch.setattr(profiling, "_clock_ns", FakeClock([0, 10, 30, 40, 50, 60, 70, 100]))
    with span("outer") as outer:
        with span("a") as a:
            pass
        with span("b") as b:
            with span("c") as c:
                pass
    assert outer.parent is None and a.parent is outer and b.parent is outer
    assert c.parent is b
    assert (outer.start_ns, outer.end_ns, c.start_ns, c.end_ns) == (0, 100, 50, 60)
    assert b.seconds == pytest.approx(30e-9)
    stats = profiling.span_stats()
    assert {k: v["count"] for k, v in stats.items()} == {"outer": 1, "a": 1, "b": 1, "c": 1}
    assert {k: round(v["total_s"] * 1e9) for k, v in stats.items()} == {
        "outer": 100, "a": 20, "b": 30, "c": 10}
    assert {k: round(v["self_s"] * 1e9) for k, v in stats.items()} == {
        "outer": 50, "a": 20, "b": 20, "c": 10}
    assert profiling._open.top is None


def test_self_time_after_an_error_and_reset(monkeypatch):
    monkeypatch.setattr(profiling, "_clock_ns", FakeClock([0, 5, 25, 40]))
    with pytest.raises(ValueError):
        with span("outer"):
            with span("inner"):
                raise ValueError("x")
    stats = profiling.span_stats()
    assert round(stats["outer"]["self_s"] * 1e9) == 20 and stats["inner"]["count"] == 1
    assert profiling._open.top is None
    profiling.reset_spans()
    assert profiling.span_stats() == {}


@pytest.mark.parametrize("sigma", [0.05, 1.0, 3.0])
def test_median_and_p95_within_two_percent(monkeypatch, sigma):
    durations = np.random.default_rng(0).lognormal(np.log(2e5), sigma, 3001).astype(np.int64)
    readings = [int(v) for d in durations for v in (0, d)]
    monkeypatch.setattr(profiling, "_clock_ns", FakeClock(readings))
    for _ in durations:
        with span("x"):
            pass
    got = profiling.span_stats()["x"]
    ranked = np.sort(durations)
    for key, q in (("median_s", 0.5), ("p95_s", 0.95)):
        want = ranked[math.ceil(q * len(ranked)) - 1] / 1e9
        assert got[key] == pytest.approx(want, rel=0.02)
    assert got["count"] == len(durations)
    assert got["total_s"] == pytest.approx(durations.sum() / 1e9, rel=1e-12)
    assert (got["min_s"], got["max_s"]) == (ranked[0] / 1e9, ranked[-1] / 1e9)


def test_bucket_middle_is_within_a_sixty_fourth():
    values = list(range(4096)) + [int(v) for v in
                                  np.random.default_rng(1).integers(1, 1 << 45, 5000)]
    for d in values:
        shift = d.bit_length() - profiling._EXACT_BITS
        bucket = (shift << (profiling._EXACT_BITS - 1)) + (d >> shift) if shift > 0 else d
        assert abs(profiling._bucket_middle(bucket) - d) <= max(d, 1) / 64


def test_each_thread_has_its_own_stack():
    """Two threads open spans in turns: each span's parent is its own
    thread's open span, never the other thread's."""
    turn = [threading.Event() for _ in range(4)]
    seen = {}

    def worker(name, first, second):
        with span(f"{name}.outer") as outer:
            turn[first].wait(10)
            with span(f"{name}.inner") as inner:
                turn[second].set()
                turn[first + 2].wait(10)
            seen[name] = (outer, inner)
            turn[second + 2].set()

    threads = [threading.Thread(target=worker, args=("t0", 0, 1)),
               threading.Thread(target=worker, args=("t1", 1, 0))]
    for t in threads:
        t.start()
    turn[0].set()
    for t in threads:
        t.join(20)
    assert not any(t.is_alive() for t in threads)
    for name, (outer, inner) in seen.items():
        assert inner.parent is outer and outer.parent is None
    assert profiling._open.top is None
    assert {k: v["count"] for k, v in profiling.span_stats().items()} == {
        "t0.outer": 1, "t0.inner": 1, "t1.outer": 1, "t1.inner": 1}


def test_concurrent_spans_lose_no_update():
    """More threads than cores, switching as often as the interpreter lets
    them: every span of every thread is counted, and each outer span's self
    time is its duration less its one child's."""
    threads, per_thread = 24, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker():
            for _ in range(per_thread):
                with span("outer"):
                    with span("inner"):
                        pass

        pool = [threading.Thread(target=worker) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    stats = profiling.span_stats()
    assert stats["outer"]["count"] == stats["inner"]["count"] == threads * per_thread
    assert stats["outer"]["self_s"] == pytest.approx(
        stats["outer"]["total_s"] - stats["inner"]["total_s"], abs=1e-12)


def test_a_span_under_a_profiler_stays_out_of_the_aggregates():
    with span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("profiled"):
            with span("profiled.child"):
                with span("quiet", profiled=False):
                    torch.ones(4).sum()
    with span("after"):
        pass
    assert set(profiling.span_stats()) == {"before", "after"}
    names = {e.name for e in prof.events()}
    assert {"profiled", "profiled.child", "aten::sum"} <= names and "quiet" not in names


def _config(batch_size=32):
    return tconfig.Config(
        model=tconfig.ModelConfig(variant="euclidean_static", num_coords=2, channels=(8,),
                                  h_dim=8, latent_dim=4, projector="linear"),
        data=tconfig.DataConfig(seg_len=6, kp18_format=False, batch_size=batch_size,
                                num_transform=1, n_joints_override=5),
        opt=tconfig.OptConfig(lr=1e-3, epochs=1), eval=tconfig.EvalConfig(),
        run=tconfig.RunConfig(seed=0))


def _scorer():
    cfg = _config()
    scorer = AnomalyScorer(cfg, None, device="cpu")
    scorer.state = scorer.trainer.init_state()
    return scorer


def _windows(n):
    return np.random.default_rng(3).normal(size=(n, 3, 6, 5)).astype(np.float32)


@pytest.mark.parametrize("n", [1, 32, 70])
def test_a_request_records_its_spans(n):
    scorer = _scorer()
    profiling.reset_spans()
    scores = scorer.score_windows(_windows(n))
    assert scores.shape == (n,)
    counts = {k: v["count"] for k, v in profiling.span_stats().items()}
    batches = math.ceil(n / scorer.trainer.batch_size)
    assert counts == {"request": 1, "request.prepare": 1, "request.upload": 1, "eval.pass": 1,
                      "eval.batch": batches, "eval.gather": batches, "eval.forward": batches,
                      "eval.fetch": 1}
    stats = profiling.span_stats()
    inside = sum(stats[k]["total_s"] for k in ("request.prepare", "request.upload", "eval.pass"))
    assert stats["request"]["self_s"] == pytest.approx(stats["request"]["total_s"] - inside,
                                                       abs=1e-12)


def test_trainer_init_is_a_set_up_span():
    cfg = _config()
    ds = SegmentDataset(data=_windows(4), meta=np.zeros((4, 4), np.int64),
                        frame_ids=np.zeros((4, 6), np.int32), num_transform=1)
    Trainer(cfg, ds, device="cpu")
    assert profiling.span_stats()["trainer.init"]["count"] == 1


def _within(outer, inner):
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def test_under_a_cpu_profiler_each_span_encloses_its_ops():
    scorer = _scorer()
    scorer.score_windows(_windows(40))  # first call's lazy set-up outside the trace
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        scorer.score_windows(_windows(40))
    events = prof.events()
    by_name = {}
    for e in events:
        by_name.setdefault(e.name, []).append(e)
    requests = [e for e in events if e.name.startswith("request:")]
    assert len(requests) == 1 and requests[0].name.split(":")[1].isdigit()
    request = requests[0]
    for name in ("request.prepare", "request.upload", "eval.pass", "eval.fetch"):
        assert len(by_name[name]) == 1, name
        assert _within(request, by_name[name][0])
    (whole,) = by_name["eval.pass"]
    assert _within(whole, by_name["eval.fetch"][0])
    # the batch loop's spans stay out of the trace
    assert not set(by_name) & {"eval.batch", "eval.gather", "eval.forward"}
    # each operation a span wrapped is its child in the trace
    for name, op in (("eval.pass", "aten::"), ("eval.fetch", "aten::cat"),
                     ("request.upload", "aten::")):
        for e in by_name[name]:
            ops = [c for c in e.cpu_children if c.name.startswith(op)]
            assert ops and all(_within(e, c) for c in ops), name
    assert profiling.span_stats() == {}


def test_k1_fold_counts_only_a_rebuild():
    model = _scorer().trainer.model
    profiling.reset_spans()
    first = model.folded()
    assert model.folded()[1] is first[1]
    assert profiling.span_stats()["k1.fold"]["count"] == 1
    with torch.no_grad():
        next(p for n, p in model.named_parameters() if n.startswith("encoder")).mul_(1.5)
    assert model.folded()[1] is not first[1]
    assert profiling.span_stats()["k1.fold"]["count"] == 2


def test_launch_counters_are_the_objects_the_benchmark_reads():
    from benchmark import program

    counters = {"K1": stse_fused.launches, "K2": stse_train.forward_launches,
                "K3": stse_train.layer_backward_launches,
                "K4": stse_train.top_backward_launches,
                "K5": stse_train.mono_backward_launches}
    assert stse_fused.LaunchCounter is profiling.LaunchCounter
    assert all(isinstance(c, profiling.LaunchCounter) for c in counters.values())
    assert all(isinstance(c, profiling.LaunchCounter) for c in probe.launches.values())
    before = program.route()
    for c in counters.values():
        c.value += 1
    try:
        assert program.route() == {k: v + 1 for k, v in before.items()}
    finally:
        for c in counters.values():
            c.value -= 1


def test_export_of_the_scoring_program_reaches_no_span():
    """The scoring program exports to the same graph under a profiler and
    inside an open span as without, with no profiler operation in it, and
    opens no span while it is traced."""
    scorer = _scorer()
    x = torch.from_numpy(_windows(8))

    def export():
        with torch.no_grad():
            return torch.export.export(scoring_program(scorer.trainer, scorer.state), (x,))

    plain = export()
    with profile(activities=[ProfilerActivity.CPU]), span("outer"):
        traced = export()
    assert str(traced.graph) == str(plain.graph)
    assert not [n for n in plain.graph.nodes if "profiler" in str(n.target)]
    profiling.reset_spans()
    export()
    assert profiling.span_stats() == {}
