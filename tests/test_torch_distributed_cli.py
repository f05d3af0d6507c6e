"""The port's command line on several ranks: `cli.train --distributed` and
`cli.eval --distributed` as two gloo processes (one thread each) on the
synthetic AlphaPose tree of tests/fixtures.py at narrow widths, against one
process on the same tree.

Bands: the epoch losses rtol 1e-3 and the center rtol 1e-3 (Adam,
tests/test_torch_train.py); the trained parameters per leaf within 1e-2
relative L2 (tests/test_distributed_cli.py's band for the JAX
package's 2-process run: Adam turns the rounding noise of the pre-BN biases'
zero gradient into +-lr steps); the validation and final AUCs of the two
trainings within 1e-3 (measured 2.9e-4 apart); the two-rank eval of a
checkpoint and the one-process eval of the same checkpoint, the same AUC to
the six printed decimals."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from coskad_tpu_torch.cli import eval as eval_cli
from coskad_tpu_torch.cli import train as train_cli
from coskad_tpu_torch.interop import flatten_tree
from coskad_tpu_torch.train import checkpoint
from coskad_tpu_torch.utils.net import free_port
from test_torch_cli import narrow_dataset

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT = 240
EPOCHS = 2


def child_env(**extra):
    """A rank's environment: the repo on the path, one thread, no JAX flags."""
    return dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", XLA_FLAGS="", **extra)


def launch_group(module, argv, n=2, port=None, **env):
    """n ranks of `python -m coskad_tpu_torch.cli.<module> ... --distributed`."""
    port = port or free_port("localhost")
    return [subprocess.Popen([sys.executable, "-u", "-m", f"coskad_tpu_torch.cli.{module}",
                              *argv, "--distributed", f"localhost:{port},{n},{rank}"],
                             cwd=ROOT, env=child_env(**env), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for rank in range(n)]


def join(procs, timeout=GROUP_TIMEOUT):
    """Every rank's output; each must have exited 0."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log[-4000:]}"
    return logs


def logged(ckpt_dir):
    with open(os.path.join(ckpt_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def final_auc(log):
    return re.search(r"final AUC score: ([0-9.]+)", log).group(1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_cli")
    single_cfg, single_dir = narrow_dataset(str(root / "single"))
    group_cfg, group_dir = narrow_dataset(str(root / "group"))
    scores_dir = str(root / "scores")
    dev = ["--device", "cpu"]
    group = launch_group("train", ["--config", group_cfg, "--epochs", str(EPOCHS), *dev])
    single = train_cli.main(["--config", single_cfg, "--epochs", str(EPOCHS), *dev])
    train_logs = join(group)
    group = launch_group("eval", ["--config", group_cfg, "--save-scores", scores_dir, *dev])
    single_eval = eval_cli.main(["--config", single_cfg, *dev])
    same_ckpt_eval = eval_cli.main(["--config", group_cfg, *dev])
    eval_logs = join(group)
    return dict(single=single, single_dir=single_dir, group_dir=group_dir,
                train_logs=train_logs, eval_logs=eval_logs, single_eval=single_eval,
                same_ckpt_eval=same_ckpt_eval, scores_dir=scores_dir)


def test_two_rank_training_matches_one_process(runs):
    want, got = logged(runs["single_dir"]), logged(runs["group_dir"])
    assert [r["step"] for r in got] == [r["step"] for r in want]
    w = [r["validation_auc"] for r in want if "validation_auc" in r]
    g = [r["validation_auc"] for r in got if "validation_auc" in r]
    assert len(g) == len(w) == EPOCHS
    np.testing.assert_allclose(g, w, atol=1e-3)
    for log in runs["train_logs"]:  # every rank prints the global batch's epoch losses
        losses = [float(v) for v in re.findall(r"\] epoch \d+/\d+ loss=([0-9.]+)", log)]
        np.testing.assert_allclose(losses, runs["single"].loss, rtol=1e-3)
    a = checkpoint.read_payload(os.path.join(runs["single_dir"], "last.ckpt"))
    b = checkpoint.read_payload(os.path.join(runs["group_dir"], "last.ckpt"))
    assert a["extra"]["epochs_done"] == b["extra"]["epochs_done"] == EPOCHS
    np.testing.assert_allclose(np.asarray(b["state"]["center"]), np.asarray(a["state"]["center"]),
                               rtol=1e-3, atol=1e-6)
    pa, pb = flatten_tree(a["state"]["params"]), flatten_tree(b["state"]["params"])
    assert sorted(pa) == sorted(pb)
    for k in pa:
        err = np.linalg.norm(pb[k] - pa[k]) / max(np.linalg.norm(pa[k]), 1e-12)
        assert err < 1e-2, (k, err)


def test_rank_zero_alone_writes_and_prints(runs):
    assert sorted(os.listdir(runs["group_dir"])) == sorted(os.listdir(runs["single_dir"]))
    # one writer: as many metric records as one process writes
    assert len(logged(runs["group_dir"])) == len(logged(runs["single_dir"]))
    for rank, log in enumerate(runs["train_logs"]):
        assert f"process={rank}/2" in log and "[coskad] done" in log
    rank0, rank1 = runs["eval_logs"]
    assert "transf: 1/5" in rank0 and "transf:" not in rank1
    assert final_auc(rank0) == final_auc(rank1)
    assert len(os.listdir(runs["scores_dir"])) > 0


def test_two_rank_eval_is_the_one_process_eval_of_the_same_checkpoint(runs):
    assert final_auc(runs["eval_logs"][0]) == f"{runs['same_ckpt_eval'].result.auc:.6f}"
    assert abs(runs["same_ckpt_eval"].result.auc - runs["single_eval"].result.auc) <= 1e-3
