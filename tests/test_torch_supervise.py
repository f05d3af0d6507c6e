"""The port's training supervisor (`coskad_tpu_torch.cli.supervise`), driven
end to end on the CPU over the synthetic AlphaPose tree of
tests/fixtures.py at narrow widths, its children gloo ranks of one thread:

  * a 2-rank group whose rank 1 crashes after epoch 1 (COSKAD_CRASH_AT_EPOCH,
    COSKAD_CRASH_RANK) is taken down and restarted with --resume, and ends
    at the checkpoint of the same group run without a crash;
  * a child that hangs after epoch 0's checkpoint (COSKAD_HANG_AT_EPOCH) is
    caught as a stall, SIGTERMed and restarted;
  * a coordinator port held by another process costs no restart: the group
    is relaunched on a fresh port, and --max-restarts 0 still succeeds.

The runs go at once, each in its own tree. Band: the final checkpoints'
arrays within rtol 1e-5 (the cli band of resumed against straight runs,
chip_smoke.py's RESUME_RTOL); the same collective layout, so in practice
the same bits."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from coskad_tpu_torch.interop import flatten_tree
from coskad_tpu_torch.train import checkpoint
from test_torch_cli import narrow_dataset
from test_torch_distributed_cli import child_env, join, launch_group

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS = 3
TIMEOUT = 300


def supervise(cfg_path, *argv, **env):
    return subprocess.Popen(
        [sys.executable, "-m", "coskad_tpu_torch.cli.supervise", "--config", cfg_path,
         "--device", "cpu", "--backoff", "0.1", "--poll", "0.2", *argv],
        cwd=ROOT, env=child_env(**env), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def finish(proc):
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, out, err


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("supervise")
    trees = {name: narrow_dataset(str(root / name))
             for name in ("straight", "crash", "hang", "held_port")}
    held = socket.socket()
    held.bind(("localhost", 0))
    held.listen()
    try:
        straight = launch_group("train", ["--config", trees["straight"][0], "--epochs",
                                          str(EPOCHS), "--device", "cpu"])
        procs = dict(
            crash=supervise(trees["crash"][0], "--epochs", str(EPOCHS), "--num-processes", "2",
                            "--max-restarts", "2", "--stall-timeout", "300",
                            COSKAD_CRASH_AT_EPOCH="1", COSKAD_CRASH_RANK="1"),
            hang=supervise(trees["hang"][0], "--epochs", "1", "--max-restarts", "1",
                           "--stall-timeout", "8", "--startup-grace", "120",
                           COSKAD_HANG_AT_EPOCH="0"),
            held_port=supervise(trees["held_port"][0], "--epochs", str(EPOCHS),
                                "--num-processes", "2", "--max-restarts", "0",
                                "--coordinator-port", str(held.getsockname()[1])))
        results = {name: finish(p) for name, p in procs.items()}
        join(straight, timeout=TIMEOUT)
    finally:
        held.close()
    results["dirs"] = {name: tree[1] for name, tree in trees.items()}
    return results


def last_checkpoint(ckpt_dir):
    payload = checkpoint.read_payload(os.path.join(ckpt_dir, "last.ckpt"))
    return flatten_tree(payload["state"]), payload["extra"]


def assert_same_run(ckpt_dir, want_dir):
    got, extra = last_checkpoint(ckpt_dir)
    want, want_extra = last_checkpoint(want_dir)
    assert extra["epochs_done"] == want_extra["epochs_done"] == EPOCHS
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64), rtol=1e-5, err_msg=k)


def test_a_crashed_rank_restarts_the_group_to_the_straight_runs_checkpoint(runs):
    code, out, err = runs["crash"]
    assert code == 0, err[-3000:]
    assert "rank 1 exited 17" in err or "rank 1 exit code 17" in err, err[-3000:]
    assert "injected crash at epoch 1" in out
    assert "restart 1/2" in err and "run completed after 2 attempt(s)" in err
    assert err.count("--distributed localhost:") == 2  # a fresh group each attempt
    assert_same_run(runs["dirs"]["crash"], runs["dirs"]["straight"])


def test_a_hang_is_caught_as_a_stall(runs):
    code, out, err = runs["hang"]
    assert code == 0, err[-3000:]
    assert "injected hang at epoch 0" in out
    assert "stall; SIGTERM child pid" in err and "stall; restart 1/1" in err
    assert "run completed after 2 attempt(s)" in err


def test_a_held_coordinator_port_is_retried_without_a_restart(runs):
    code, out, err = runs["held_port"]
    assert code == 0, err[-3000:]
    assert "coordinator port taken by another process" in err
    assert "no restart spent" in err and "restart budget exhausted" not in err
    assert_same_run(runs["dirs"]["held_port"], runs["dirs"]["straight"])
