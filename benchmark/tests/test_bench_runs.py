"""Whole runs on the CPU at a small size: the port agrees with the plain
reference in every cell, and the control and each fault a cell can have
make `correct` come out false. Every step of a run but the look for a card
is driven."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import faults, harness
from benchmark.tests.small import SMALL

CELLS = ("flagship-train", "flagship-score", "hrstc-train", "hrstc-requests")


def _run(cell, seed=11, limits=None):
    """One whole run. A request cell's window is long enough to serve its
    whole small pool many times over, so that what is compared does not
    hang on the pace of a loaded host."""
    seconds = 3.0 if harness.Cell(cell).mix["kind"] == "clip_requests" else 0.2
    return harness.run_cell(cell, seed, seconds, False, time.monotonic(), device="cpu",
                            patch=SMALL, limits=limits)


def _small_limits(cell: str) -> dict:
    """The cell's limits, but a bf16 loss's: the mean over a batch of 256
    holds the rounding of bf16 less well than one of 2048, by about the root
    of their ratio."""
    c = harness.Cell(cell)
    limits = dict(c.spec["limits"])
    if c.config["reference"]["compute_dtype"] == "bfloat16" and "loss_gap" in limits:
        batch = c.config["reference"]["dataset_batch_size"]
        limits["loss_gap"] *= (batch / SMALL["config"]["reference"]["dataset_batch_size"]) ** 0.5
    return limits


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", (11, 12))
def test_port_agrees_with_the_reference(cell, seed):
    result = _run(cell, seed, _small_limits(cell))
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(harness.Cell(cell).spec["limits"])


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in harness.Cell(c).faults()])
def test_each_fault_makes_correct_false(cell, fault):
    with faults.FAULTS[fault]():
        result = _run(cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(cell):
    """The reference in the precision below the config's, put in the
    program's place, fails one of the cell's numbers."""
    c = harness.Cell(cell, SMALL)
    run = c.kind.Run(c, 11, torch.device("cpu"))
    run.setup()
    if c.kind.ENTRY != "Trainer.fit":
        run.window(0.2)
    run.free()
    reference = run.reference_readings("exact")
    numbers = run.compare(run.control_readings(c.config["control"]), reference)
    limits = c.spec["limits"]
    assert any(numbers[k] > limits[k] for k in limits), numbers


def test_the_checked_steps_are_fits_own(monkeypatch):
    """The checked steps are the ones `fit` runs: a fit that feeds its epoch
    in another order, or trains it with frozen BatchNorm, reads apart."""
    from coskad_tpu_torch.train.loop import Trainer

    original = Trainer.train_epoch
    monkeypatch.setattr(Trainer, "train_epoch", lambda self, state, data, idx, frozen_bn=False:
                        original(self, state, data, idx.flip(0), frozen_bn))
    assert not _run("hrstc-train", limits=_small_limits("hrstc-train"))["correct"]
    monkeypatch.setattr(Trainer, "train_epoch", lambda self, state, data, idx, frozen_bn=False:
                        original(self, state, data, idx, True))
    assert not _run("hrstc-train", limits=_small_limits("hrstc-train"))["correct"]
