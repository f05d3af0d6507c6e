"""The command-line path: the port's cli.train and cli.eval against the JAX
package's, on the synthetic AlphaPose tree of tests/fixtures.py at narrow
widths, on the CPU.

Tolerances: frame AUCs of the two evals of one checkpoint within 1e-4
(PERF.md §2); a served window's score equals the eval's bit for bit (the
same model, batches and arithmetic on the CPU); the trained port's AUC
above 0.6, the plumbing band of tests/test_cli_e2e.py.

The paper's configurations (config/HR-STC/*.yaml) run as shipped, read by
the port's own YAML reader, with these lines edited: the four paths and the
widths and batch cut for the CPU. The port runs their compute_dtype,
bfloat16, as written; where the JAX package's CLI trains on the CPU the
file says float32, as XLA on the CPU has no bf16 dot (the bf16 paths are
held to JAX in tests/test_torch_bf16.py)."""

import os
import re

import numpy as np
import pytest
import torch
import yaml

from coskad_tpu.cli import eval as jeval_cli
from coskad_tpu.cli import train as jtrain_cli
from coskad_tpu_torch.cli import eval as eval_cli
from coskad_tpu_torch.cli import train as train_cli
from coskad_tpu_torch.cli.common import load_config, load_split
from coskad_tpu_torch.serve import AnomalyScorer
from coskad_tpu_torch.train import checkpoint
from coskad_tpu_torch.utils import profiling
from fixtures import make_synthetic_dataset

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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


def shipped_config(root, name, **edits):
    """config/HR-STC/<name>.yaml over the fixture's tree in `root`, with the
    four paths and `edits` replaced line by line, the rest as shipped."""
    make_synthetic_dataset(root, n_frames=120)
    with open(os.path.join(ROOT, "config", "HR-STC", f"{name}.yaml")) as f:
        text = f.read()
    edits = dict(data_dir=root, dataset_path_to_robust=root, test_path=os.path.join(root, "gt"),
                 exp_dir=os.path.join(root, "checkpoints"), **edits)
    for key, value in edits.items():
        text, n = re.subn(rf"^{key}:.*$", f"{key}: {value}", text, flags=re.M)
        assert n == 1, key
    path = os.path.join(root, f"{name}.yaml")
    with open(path, "w") as f:
        f.write(text)
    return path, os.path.join(root, "checkpoints", "HR-STC", f"stc_{name.split('_')[0]}")


CPU_CUT = dict(channels="[8, 4, 8]", h_dim=16, latent_dim=4, dataset_batch_size=128)


@pytest.mark.parametrize("name", ["hyperbolic_encoder", "euclidean_encoder"])
def test_shipped_hr_stc_config_trains_resumes_evaluates_and_serves(tmp_path, name):
    """The port's cli.train (2 epochs, then --resume to 3), cli.eval and
    from_checkpoint on a shipped HR-STC file: the MLP projector at 17
    joints, the hyperbolic or the dynamic euclidean center, validation on."""
    root = str(tmp_path)
    cfg_path, ckpt_dir = shipped_config(root, name, **CPU_CUT)
    cfg = load_config(cfg_path)
    assert (cfg.model.projector, cfg.data.n_joints, cfg.data.seg_stride) == ("mlp", 17, 1)
    assert cfg.run.compute_dtype == "bfloat16"  # as shipped
    assert cfg.model.variant == ("hyperbolic" if name.startswith("hyp") else "euclidean_dynamic")
    if not torch.cuda.is_available():  # the default device is the card, never a fallback
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_cli.main(["--config", cfg_path, "--epochs", "1"])
    run = train_cli.main(["--config", cfg_path, "--epochs", "2", "--device", "cpu"])
    resumed = train_cli.main(["--config", cfg_path, "--epochs", "3", "--resume",
                              "--device", "cpu"])
    assert not run.trainer._fused_compat
    losses = run.loss + resumed.loss
    assert len(losses) == 3 and np.isfinite(losses).all()
    if cfg.model.variant == "hyperbolic":
        assert float(resumed.state.center.norm()) < 1.0
    ev = eval_cli.main(["--config", cfg_path, "--device", "cpu"])
    assert np.isfinite(ev.result.auc) and len(ev.result.per_transform_auc) == 5
    scorer = AnomalyScorer.from_checkpoint(os.path.join(ckpt_dir, "best.ckpt"), device="cpu")
    windows = load_split(scorer.cfg, "test", stride=1).data[:100]
    np.testing.assert_array_equal(scorer.score_windows(windows), ev.window_scores[:100])


def test_port_eval_of_a_jax_hyperbolic_checkpoint_matches_jax_eval(tmp_path):
    """A JAX cli.train of the hyperbolic MLP model on the shipped HR-STC
    file, then both packages' cli.eval of its checkpoint."""
    cfg_path, _ = shipped_config(str(tmp_path), "hyperbolic_encoder", compute_dtype="float32",
                                 **CPU_CUT)
    jtrain_cli.main(["--config", cfg_path, "--epochs", "2"])
    want = jeval_cli.main(["--config", cfg_path])
    got = eval_cli.main(["--config", cfg_path, "--device", "cpu"])
    assert abs(got.result.auc - want.auc) <= 1e-4
    np.testing.assert_allclose(got.result.per_transform_auc, want.per_transform_auc, atol=1e-4)


def test_port_eval_of_a_jax_checkpoint_matches_jax_eval(tmp_path):
    cfg_path, ckpt_dir = narrow_dataset(str(tmp_path))
    jtrain_cli.main(["--config", cfg_path, "--epochs", "2"])
    want = jeval_cli.main(["--config", cfg_path])
    profiling.reset_spans()
    got = eval_cli.main(["--config", cfg_path, "--device", "cpu"])
    assert abs(got.result.auc - want.auc) <= 1e-4
    np.testing.assert_allclose(got.result.per_transform_auc, want.per_transform_auc, atol=1e-4)
    assert sorted(got.result.per_clip_auc) == sorted(want.per_clip_auc)
    assert set(got.wall_s) == {"ingest", "upload", "scoring", "aggregate"}
    # each phase is the span of its name, once
    spans = profiling.span_stats()
    assert {k: (spans[f"cli.{k}"]["count"], spans[f"cli.{k}"]["total_s"])
            for k in got.wall_s} == {k: (1, pytest.approx(v)) for k, v in got.wall_s.items()}


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
