"""The command-line path: the port's cli.train and cli.eval against the JAX
package's, on the synthetic AlphaPose tree of tests/fixtures.py at narrow
widths, on the CPU.

Tolerances: frame AUCs of the two evals of one checkpoint within 1e-4
(PERF.md §2); a served window's score equals the eval's bit for bit (the
same model, batches and arithmetic on the CPU); the trained port's AUC
above 0.6, the plumbing band of tests/test_cli_e2e.py."""

import os

import numpy as np
import pytest
import torch
import yaml

from coskad_tpu.cli import eval as jeval_cli
from coskad_tpu.cli import train as jtrain_cli
from coskad_tpu_torch.cli import eval as eval_cli
from coskad_tpu_torch.cli import train as train_cli
from coskad_tpu_torch.cli.common import load_split
from coskad_tpu_torch.serve import AnomalyScorer
from coskad_tpu_torch.train import checkpoint
from fixtures import make_synthetic_dataset

torch.set_num_threads(1)

NARROW = dict(channels=[8, 4, 8], h_dim=16, latent_dim=4, dataset_batch_size=64)


def narrow_dataset(root, **overrides):
    """The fixture's tree and config, the model cut to narrow widths."""
    path = make_synthetic_dataset(root, n_frames=200)
    with open(path) as f:
        raw = yaml.safe_load(f)
    raw.update(NARROW, **overrides)
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path, os.path.join(root, "checkpoints", "Synthetic", "smoke")


def test_port_eval_of_a_jax_checkpoint_matches_jax_eval(tmp_path):
    cfg_path, ckpt_dir = narrow_dataset(str(tmp_path))
    jtrain_cli.main(["--config", cfg_path, "--epochs", "2"])
    want = jeval_cli.main(["--config", cfg_path])
    got = eval_cli.main(["--config", cfg_path, "--device", "cpu"])
    assert abs(got.result.auc - want.auc) <= 1e-4
    np.testing.assert_allclose(got.result.per_transform_auc, want.per_transform_auc, atol=1e-4)
    assert sorted(got.result.per_clip_auc) == sorted(want.per_clip_auc)
    assert set(got.wall_s) == {"ingest", "upload", "scoring", "aggregate"}


@pytest.mark.parametrize("fused_train", ["off", "on"])
def test_port_train_resume_eval_and_serve(tmp_path, fused_train):
    cfg_path, ckpt_dir = narrow_dataset(str(tmp_path), fused_train=fused_train, ghost_size=8)
    run = train_cli.main(["--config", cfg_path, "--epochs", "2", "--device", "cpu"])
    assert len(run.loss) == len(run.validation_auc) == 2 and np.isfinite(run.loss).all()
    resumed = train_cli.main(["--config", cfg_path, "--epochs", "3", "--resume",
                              "--device", "cpu"])
    assert len(resumed.loss) == 1 and resumed.state.step == 3 * run.state.step // 2
    for name in ("last.ckpt", "best.ckpt", "best.ckpt.config.json", "metrics.jsonl"):
        assert os.path.exists(os.path.join(ckpt_dir, name)), name
    extra = checkpoint.read_payload(os.path.join(ckpt_dir, "last.ckpt"))["extra"]
    assert extra["epochs_done"] == 3 and extra["epoch"] == 2

    ev = eval_cli.main(["--config", cfg_path, "--device", "cpu"])
    assert ev.result.auc > 0.6
    assert len(ev.result.per_transform_auc) == 5 and len(ev.result.per_clip_auc) == 2
    scorer = AnomalyScorer.from_checkpoint(os.path.join(ckpt_dir, "best.ckpt"), device="cpu")
    windows = load_split(scorer.cfg, "test", stride=1).data[:100]
    np.testing.assert_array_equal(scorer.score_windows(windows), ev.window_scores[:100])


def test_cli_and_from_checkpoint_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without CUDA")
    cfg_path, ckpt_dir = narrow_dataset(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--config", cfg_path, "--epochs", "1"])
    train_cli.main(["--config", cfg_path, "--epochs", "1", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_cli.main(["--config", cfg_path])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AnomalyScorer.from_checkpoint(os.path.join(ckpt_dir, "last.ckpt"))
