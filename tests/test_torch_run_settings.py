"""The run settings the port does not act on yet are refused, not ignored:
`run.data_parallel` and `run.model_parallel` (the JAX package builds its
(data, model) mesh from them, `coskad_tpu/parallel/mesh.py`) until
multi-GPU is ported (ROADMAP.md, Queue 1 item 5). The defaults, and every
shipped config, still build a Trainer."""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from coskad_tpu_torch import config as tconfig
from coskad_tpu_torch.data.windows import SegmentDataset
from coskad_tpu_torch.train.loop import Trainer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "config", "*", "*.yaml")))


def _dataset(cfg, count=8):
    rng = np.random.default_rng(0)
    t, v = cfg.data.seg_len, cfg.data.n_joints
    return SegmentDataset(rng.normal(size=(count, cfg.model.num_coords, t, v)).astype(np.float32),
                          np.ones((count, 4), np.int64), np.ones((count, t), np.int32),
                          num_transform=cfg.data.num_transform)


def _small(**run):
    return tconfig.Config(model=tconfig.ModelConfig(channels=(4,), h_dim=4, latent_dim=2),
                          data=tconfig.DataConfig(seg_len=6, n_joints_override=5, batch_size=8,
                                                  num_transform=1),
                          run=tconfig.RunConfig(**run))


@pytest.mark.parametrize("run", [dict(data_parallel=4), dict(data_parallel=2),
                                 dict(model_parallel=2), dict(data_parallel=2, model_parallel=2)],
                         ids=["data_parallel4", "data_parallel2", "model_parallel2", "both2"])
def test_parallel_settings_are_refused(run):
    cfg = _small(**run)
    with pytest.raises(ValueError, match="Queue 1 item 5"):
        Trainer(cfg, _dataset(cfg), device="cpu")


@pytest.mark.parametrize("run", [dict(), dict(data_parallel=-1), dict(data_parallel=1),
                                 dict(data_parallel=1, model_parallel=1)],
                         ids=["default", "data_parallel-1", "data_parallel1", "both1"])
def test_one_device_settings_are_accepted(run):
    cfg = _small(**run)
    trainer = Trainer(cfg, _dataset(cfg), device="cpu")
    assert (trainer.cfg.run.data_parallel, trainer.cfg.run.model_parallel) == (
        run.get("data_parallel", -1), run.get("model_parallel", 1))


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.relpath(p, ROOT) for p in CONFIGS])
def test_shipped_configs_build_a_trainer(path):
    cfg = tconfig.from_reference_yaml(path)
    assert (cfg.run.data_parallel, cfg.run.model_parallel) == (-1, 1)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, batch_size=8))
    trainer = Trainer(cfg, _dataset(cfg), device="cpu")
    assert trainer.device.type == "cpu"
