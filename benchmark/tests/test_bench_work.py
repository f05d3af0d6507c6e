"""The frozen work counts equal the port's `work()` at the flagship shapes."""

from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.reference import stse as ref
from benchmark.work import stse_counts


def _flagship_model():
    from coskad_tpu_torch.config import from_reference_dict
    from coskad_tpu_torch.models import build_model
    from coskad_tpu_torch.train.loop import model_kwargs_from_config

    cell = harness.Cell("flagship-train")
    cfg = from_reference_dict(cell.config["reference"])
    return cell, build_model(**model_kwargs_from_config(cfg))


def test_k1_counts_match_the_port():
    from coskad_tpu_torch.kernels import stse_fused

    cell, model = _flagship_model()
    folded = stse_fused.fold_stse_params({k: v.detach() for k, v in model.state_dict().items()})
    for batch in (2048, 1000):
        assert stse_counts.k1_work(ref.arch_of(cell.config), batch) == pytest.approx(
            stse_fused.work(folded, batch), rel=0, abs=0)


def test_train_kernel_counts_match_the_port():
    from coskad_tpu_torch.kernels import stse_train

    cell, model = _flagship_model()
    ops = stse_train.encoder_ops(model)
    theirs = stse_train.work(ops, 2048, 64, "float32")
    ours = stse_counts.train_kernel_work(ref.arch_of(cell.config), 2048, 64)
    assert set(ours) == set(theirs) - {"K5"}
    for k, (flops, nbytes) in ours.items():
        assert (flops, nbytes) == (theirs[k][0], theirs[k][1])


def test_flagship_bounds_as_the_kernel_table_gives_them():
    cell = harness.Cell("flagship-train")
    peaks = cell.peaks
    # PERF.md's kernel table: K1 0.110 ms, K2 0.134, K4 0.188; K3's three
    # layers 34.0 GFLOP. The roofline takes each launch's own bound, so a
    # layer bound by its bytes counts as such.
    assert cell.work.k1_bound_s(cell.config, 2048, peaks) == pytest.approx(0.110e-3, rel=0.01)
    work = stse_counts.train_kernel_work(ref.arch_of(cell.config), 2048, 64)
    bound = {k: stse_counts.bound_s(f, b, peaks, "float32") for k, (f, b) in work.items()}
    assert bound["K2"] == pytest.approx(0.134e-3, rel=0.01)
    assert bound["K4"] == pytest.approx(0.188e-3, rel=0.01)
    assert sum(work[f"K3_layer{i}"][0] for i in range(3)) == pytest.approx(34.0e9, rel=0.01)
    assert cell.work.train_kernels_bound_s(cell.config, 2048, 64, peaks) == pytest.approx(
        sum(bound.values()))


def test_model_flops_count_the_products():
    arch = dict(in_dim=2, channels=[32], hidden=32, latent=4, frames=1, joints=2,
                projector="linear")
    n = 2
    fwd = (2 * n * n * 2 + 2 * 2 * n * 2 * 32) + (2 * n * n * 32 + 2 * n * 32 * 32) \
        + 2 * n * 32 * 4
    assert stse_counts.forward_flops(arch) == fwd
    assert stse_counts.model_flops(arch, "train") == 3 * (fwd + 12)
    assert stse_counts.model_flops(arch, "eval") == fwd + 12
