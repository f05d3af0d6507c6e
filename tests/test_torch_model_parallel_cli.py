"""The port's command line on a 2 x 2 mesh: `cli.train --distributed` (1
epoch, then `--resume` to 2) and `cli.eval --distributed` as four gloo
processes (one thread each) with `model_parallel: 2` in the config, on the
synthetic AlphaPose tree of tests/fixtures.py at narrow widths, against
one process on the same tree (tests/test_torch_distributed_cli.py's
pattern and bands: epoch losses rtol 1e-3 under Adam). The mesh's last
checkpoint holds the whole kernels, as one process writes them; its eval
prints one AUC on every rank, rank 0 alone prints the per-clip lines, and
the one-process eval of the mesh's checkpoint gives that AUC."""

import os
import re

import numpy as np
import pytest
import torch

from coskad_tpu_torch.cli import eval as eval_cli
from coskad_tpu_torch.cli import train as train_cli
from coskad_tpu_torch.interop import flatten_tree
from coskad_tpu_torch.train import checkpoint
from test_torch_cli import narrow_dataset
from test_torch_distributed_cli import join, launch_group

torch.set_num_threads(1)



@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """cli.train (1 epoch, then --resume to 2) and cli.eval as four ranks of
    a 2 x 2 mesh (`model_parallel: 2` in the config), and cli.train / eval
    of the same tree and model in one process."""
    root = tmp_path_factory.mktemp("mp_cli")
    single_cfg, single_dir = narrow_dataset(str(root / "single"))
    mesh_cfg, mesh_dir = narrow_dataset(str(root / "mesh"), model_parallel=2)
    dev = ["--device", "cpu"]
    group = launch_group("train", ["--config", mesh_cfg, "--epochs", "1", *dev], n=4)
    single = train_cli.main(["--config", single_cfg, "--epochs", "2", *dev])
    first = join(group)
    resumed = join(launch_group("train", ["--config", mesh_cfg, "--resume", "--epochs", "2",
                                          *dev], n=4))
    group = launch_group("eval", ["--config", mesh_cfg, *dev], n=4)
    # the mesh's checkpoint in one process, through the one-process config
    same_ckpt = eval_cli.main(["--config", single_cfg, "--ckpt",
                               os.path.join(mesh_dir, "best.ckpt"), *dev])
    evals = join(group)
    return dict(single=single, single_dir=single_dir, mesh_dir=mesh_dir, first=first,
                resumed=resumed, evals=evals, same_ckpt=same_ckpt)


def epoch_losses(log):
    return [float(v) for v in re.findall(r"\] epoch \d+/\d+ loss=([0-9.]+)", log)]


def test_the_mesh_trains_resumes_and_evaluates_through_the_clis(cli_runs):
    for rank, (a, b) in enumerate(zip(cli_runs["first"], cli_runs["resumed"])):
        assert f"process={rank}/4" in a and "[coskad] resumed from" in b
        # Adam: the band of tests/test_torch_distributed_cli.py
        np.testing.assert_allclose(epoch_losses(a) + epoch_losses(b), cli_runs["single"].loss,
                                   rtol=1e-3)
    payload = checkpoint.read_payload(os.path.join(cli_runs["mesh_dir"], "last.ckpt"))
    want = checkpoint.read_payload(os.path.join(cli_runs["single_dir"], "last.ckpt"))
    assert payload["extra"]["epochs_done"] == want["extra"]["epochs_done"] == 2
    # the file holds the whole kernels, as one process writes them
    shapes = {k: np.shape(v) for k, v in flatten_tree(payload["state"]["params"]).items()}
    assert shapes == {k: np.shape(v) for k, v in flatten_tree(want["state"]["params"]).items()}
    assert sorted(os.listdir(cli_runs["mesh_dir"])) == sorted(os.listdir(cli_runs["single_dir"]))
    aucs = [re.search(r"final AUC score: ([0-9.]+)", log).group(1) for log in cli_runs["evals"]]
    assert len(set(aucs)) == 1 and "transf: 1/" in cli_runs["evals"][0]
    assert all("transf:" not in log for log in cli_runs["evals"][1:])
    # the mesh's eval of its checkpoint is the one-process eval of that file
    assert abs(float(aucs[0]) - cli_runs["same_ckpt"].result.auc) <= 1e-6
