"""The `ubnormal-ae-score` cell on the CPU at a small size: the port agrees
with the plain reference at the configuration's casts (bf16) on both
compared numbers (`score_gap` on the latent distances, `rec_gap` on the
reconstruction errors); the control (the reference at fp8) fails both,
the decoder alone one precision down fails `rec_gap`, each score fault
the kind lists and a reconstruction fault planted here make `correct`
come out false; and the config builds the port's Config the shipped YAML
builds, but for its cuts.

Run: python -m pytest benchmark/tests/test_bench_ae.py -q
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

from benchmark import devtrace, faults, harness
from benchmark.tests.small import SMALL

CELL = "ubnormal-ae-score"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# SMALL's sizes, and one warm-up and one traced pass for this cell's kind
PATCH = dict(SMALL, mix=dict(SMALL["mix"], recon_passes={"trace_passes": 1,
                                                          "warmup_passes": 1}))


def _run(seed=11, trace=False):
    return harness.run_cell(CELL, seed, 0.2, trace, time.monotonic(), device="cpu",
                            patch=PATCH)


@contextlib.contextmanager
def half_batch_reconstruction():
    """Each scoring batch's second half of reconstruction errors is left
    out: its rows get the mean of the first half's."""
    from coskad_tpu_torch.train.loop import Trainer

    original = Trainer._embed_step

    def step(self, *args, **kwargs):
        z, rec = original(self, *args, **kwargs)
        rec = rec.clone()
        h = len(rec) // 2
        if h:
            rec[h:] = rec[:h].mean()
        return z, rec

    Trainer._embed_step = step
    try:
        yield
    finally:
        Trainer._embed_step = original


@pytest.mark.parametrize("seed", (11, 12))
def test_port_agrees_with_the_reference(seed):
    result = _run(seed)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["checks"]) == {"score_gap", "rec_gap"}
    assert set(result["metrics"]) == {"score_windows_per_s", "setup_s"}
    assert set(result["route"]) == {"K1", "K2", "K3", "K4", "K5", "K1_decoder"}


def _reader(name):
    return harness.load_module(os.path.join(ROOT, "benchmark", "metrics", f"{name}.py"), name)


def test_the_cells_readers_on_a_synthetic_trace(monkeypatch):
    """`k1_ae_roofline` holds both stacks' frozen work a batch times the
    traced batches to every `stse_fused*` kernel's time, and reads nothing
    while the decoder ran on no K1 launch; `decode_us.score` reads the
    median `eval.decode` span, nothing where the program opened none."""
    from coskad_tpu_torch.kernels import stse_fused
    from coskad_tpu_torch.utils import profiling

    cell = harness.Cell(CELL)
    dev = [devtrace.Op("stse_fused_bf16_kernel", 0, 400), devtrace.Op("gemm", 400, 500),
           devtrace.Op("stse_fused_bf16_kernel", 500, 1100)]
    ctx = dict(trace=devtrace.Trace(dev, [], 0.0, 1100.0), units=2, config=cell.config,
               work=cell.work, peaks=cell.peaks, window={"items": 4096.0, "seconds": 0.5})
    roofline = _reader("k1_ae_roofline")
    monkeypatch.setattr(stse_fused.decoder_launches, "value", 0)
    assert roofline.read(ctx) is None
    monkeypatch.setattr(stse_fused.decoder_launches, "value", 2)
    bound = cell.work.k1_bound_s(cell.config, 2048, cell.peaks)
    assert roofline.read(ctx) == pytest.approx(100.0 * bound * 2 / 1000e-6)
    profiling.reset_spans()
    assert _reader("decode_us.score").read(ctx) is None
    readings = iter([0, 100_000, 0, 300_000, 0, 200_000])
    monkeypatch.setattr(profiling, "_clock_ns", lambda: next(readings))
    for _ in range(3):
        with profiling.span("eval.decode"):
            pass
    assert _reader("decode_us.score").read(ctx) == pytest.approx(200.0, rel=1 / 64)
    profiling.reset_spans()


@pytest.mark.parametrize("fault", harness.Cell(CELL).faults())
def test_each_score_fault_makes_correct_false(fault):
    with faults.FAULTS[fault]():
        result = _run()
    assert not result["correct"], result["checks"]
    assert result["checks"]["score_gap"]["value"] > result["checks"]["score_gap"]["limit"]


def test_a_reconstruction_fault_fails_rec_gap():
    with half_batch_reconstruction():
        result = _run()
    assert not result["correct"], result["checks"]
    assert result["checks"]["rec_gap"]["value"] > result["checks"]["rec_gap"]["limit"]
    assert result["checks"]["score_gap"]["value"] <= result["checks"]["score_gap"]["limit"]


def _readings(patch=PATCH):
    """A run set up and its window read, the program freed: (run, limits)."""
    c = harness.Cell(CELL, patch)
    run = c.kind.Run(c, 11, torch.device("cpu"))
    run.setup()
    run.window(0.2)
    run.free()
    return run, c.spec["limits"]


def test_the_control_fails():
    """The reference at fp8, put in the program's place, fails both of the
    cell's numbers."""
    run, limits = _readings()
    reference = run.reference_readings("exact")
    numbers = run.compare(run.control_readings(run.cell.config["control"]), reference)
    assert all(numbers[k] > limits[k] for k in limits), numbers


def test_a_decoder_one_precision_down_fails_rec_gap():
    """The reference with its encoder at the configuration's bf16 and its
    decoder at fp8, put in the program's place: the scores pass, the
    reconstruction errors fail."""
    from benchmark.reference import stse as ref, stsae

    run, limits = _readings()
    table = torch.as_tensor(ref.transform_table(run.transforms))
    low = stsae.eval_outputs(run.params, run.arch, run.data, torch.arange(len(run.ds)), table,
                             run.center, precision="bf16", decoder_precision="fp8")
    numbers = run.compare([tuple(t.numpy() for t in low)], run.reference_readings("exact"))
    assert numbers["score_gap"] == 0.0 and numbers["rec_gap"] > limits["rec_gap"], numbers


@pytest.mark.parametrize("dtype,precision", [("bfloat16", "bf16"), ("float32", "exact")])
def test_correct_compares_with_the_reference_at_the_configurations_casts(dtype, precision):
    from benchmark.reference import stse as ref, stsae

    patch = harness.merged(PATCH, {"config": {"reference": {"compute_dtype": dtype}}})
    run, _ = _readings(patch)
    table = torch.as_tensor(ref.transform_table(run.transforms))
    want = stsae.eval_outputs(run.params, run.arch, run.data, torch.arange(len(run.ds)), table,
                              run.center, precision=precision)
    got = run.reference_readings("exact")
    assert all(np.array_equal(g, w.numpy()) for g, w in zip(got, want))


def test_the_work_counts_both_stacks():
    """The frozen counts at the shipped widths: the decoder about 14.5 MFLOP
    a window against the encoder's 9.4 in K1's bf16 terms, each launch of a
    2048 batch bound by its 107-111 MB at 3.35 TB/s (about 0.033 ms)."""
    cell = harness.Cell(CELL)
    work, arch = cell.work, harness.load_module(
        os.path.join(ROOT, "benchmark", "reference", "stse.py"), "r").arch_of(cell.config)
    n = arch["frames"] * arch["joints"]
    enc = work.k1_stack_work_bf16(n, [(2, 32), (32, 16), (16, 32), (32, 64)], 1)
    dec = work.k1_stack_work_bf16(n, work.decoder_layers(arch), 1)
    assert work.decoder_layers(arch) == [(64, 32), (32, 16), (16, 32), (32, 2)]
    assert enc[0] == pytest.approx(9.4e6, rel=0.01) and dec[0] == pytest.approx(14.5e6, rel=0.01)
    bound = work.k1_bound_s(cell.config, 2048, cell.peaks)
    assert bound == pytest.approx(2 * 0.033e-3, rel=0.02)
    assert work.model_flops(cell.config, "eval") > enc[0] + dec[0]


def test_ubnormal_ae_config_is_the_shipped_file_but_for_its_cuts():
    """The ubnormal-ae config builds the port's Config the shipped YAML
    builds, except for what `reduced` names."""
    from coskad_tpu_torch.config import from_reference_dict, from_reference_yaml

    with open(os.path.join(ROOT, "benchmark", "configs", "ubnormal-ae.json")) as f:
        conf = json.load(f)
    shipped = dataclasses.asdict(from_reference_yaml(
        os.path.join(ROOT, "config", "UBnormal", "euclidean_autoencoder.yaml")))
    ours = dataclasses.asdict(from_reference_dict(conf["reference"]))
    differ = {(s, k) for s in shipped for k in shipped[s] if shipped[s][k] != ours[s][k]}
    assert differ == {("data", "pose_dirs"), ("data", "path_to_robust"), ("data", "gt_dir"),
                      ("data", "val_gt_dir"), ("opt", "validation")}
    assert {"data_dir", "dataset_path_to_robust", "test_path", "validation"} <= set(conf["reduced"])
    assert ours["model"]["variant"] == "autoencoder" and ours["run"]["compute_dtype"] == "bfloat16"
    assert (ours["model"]["channels"], ours["model"]["h_dim"], ours["model"]["latent_dim"]) == (
        (32, 16, 32), 64, 16)
