"""The readers of the program's own spans: each value from a synthetic
`span_stats()`, None where the spans are absent or the program records
none, and finite values after a whole small run on the CPU."""

from __future__ import annotations

import math
import os
import time

import pytest

from benchmark import harness
from benchmark.tests.small import SMALL
from coskad_tpu_torch.utils import profiling

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READERS = ("host_batch_us.score", "fetch_wait_share.score", "request_upload_ms",
           "setup_program_s")


def _reader(name):
    return harness.load_module(os.path.join(BENCH, "metrics", f"{name}.py"), name)


def _agg(count, total_s, self_s=None, median_s=0.0):
    return {"count": count, "total_s": total_s, "self_s": total_s if self_s is None else self_s,
            "min_s": 0.0, "median_s": median_s, "p95_s": median_s, "max_s": median_s}


SYNTHETIC = {
    "eval.pass": _agg(10, 2.0, 0.1),
    "eval.batch": _agg(980, 1.5, 0.2, median_s=812e-6),
    "eval.fetch": _agg(10, 0.3),
    "request.upload": _agg(48, 0.05, median_s=0.9e-3),
    "kernels.build": _agg(2, 0.4, 0.3),
    "kernels.load": _agg(1, 0.2, 0.1),
    "trainer.init": _agg(1, 2.5, 2.5),
    "k1.fold": _agg(1, 0.05),
    "request": _agg(48, 0.5, 0.01),
}


@pytest.fixture
def stats(monkeypatch):
    table = dict(SYNTHETIC)
    monkeypatch.setattr(profiling, "span_stats", lambda: table)
    return table


def test_each_reader_on_synthetic_spans(stats):
    assert _reader("host_batch_us.score").read({}) == pytest.approx(812.0)
    assert _reader("fetch_wait_share.score").read({}) == pytest.approx(15.0)
    assert _reader("request_upload_ms").read({}) == pytest.approx(0.9)
    # self times: each second once, however the set-up spans nest
    assert _reader("setup_program_s").read({}) == pytest.approx(0.3 + 0.1 + 2.5 + 0.05)


def test_setup_reads_the_spans_it_finds(stats):
    for name in ("kernels.build", "kernels.load", "k1.fold"):
        del stats[name]
    assert _reader("setup_program_s").read({}) == pytest.approx(2.5)


@pytest.mark.parametrize("name,absent", [
    ("host_batch_us.score", ("eval.batch",)),
    ("fetch_wait_share.score", ("eval.fetch",)),
    ("fetch_wait_share.score", ("eval.pass",)),
    ("request_upload_ms", ("request.upload",)),
    ("setup_program_s", ("kernels.build", "kernels.load", "trainer.init", "k1.fold")),
])
def test_a_reader_without_its_spans_reads_none(stats, name, absent):
    for span in absent:
        del stats[span]
    assert _reader(name).read({}) is None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_spans_reads_none(monkeypatch, name):
    """A program that records no spans, as before they were added: nothing,
    and no error."""
    monkeypatch.delattr(profiling, "span_stats")
    assert _reader(name).read({}) is None


@pytest.mark.parametrize("cell,names", [
    ("flagship-score", ("host_batch_us.score", "fetch_wait_share.score", "setup_program_s")),
    ("hrstc-requests", READERS),
])
def test_readers_after_a_small_run(cell, names):
    """A whole small run on the CPU leaves spans that every reader its cell
    reports reads as a finite number."""
    profiling.reset_spans()
    result = harness.run_cell(cell, 13, 0.5, False, time.monotonic(), device="cpu",
                              patch=SMALL)
    assert result["correct"], result["checks"]
    listed = {m["name"] for m in harness.Cell(cell).metrics("per_layer")}
    assert set(names) <= listed
    for name in names:
        value = _reader(name).read({})
        assert value is not None and math.isfinite(value) and value >= 0, name
    assert 0 < _reader("fetch_wait_share.score").read({}) < 100
