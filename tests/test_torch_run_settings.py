"""The parallel run settings are acted on or refused, never ignored: the
(data, model) mesh must cover the process group (one rank without one):
`run.model_parallel` must divide the world and `run.data_parallel` be -1 or
the world / model_parallel, so in one process a data axis of 2 or 4 and
any model axis are refused (the mesh would need more ranks than one), as is
a mesh that leaves ranks idle (`parallel/mesh.py::mesh_shape`). The
defaults, and every shipped config, still build a Trainer."""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from coskad_tpu_torch import config as tconfig
from coskad_tpu_torch.data.windows import SegmentDataset
from coskad_tpu_torch.parallel import mesh
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
    """One process is a world of one: a data axis of 2 or 4 is refused, as
    is any model axis, and the message names the settings and the world."""
    cfg = _small(**run)
    with pytest.raises(ValueError, match=r"run\.data_parallel .*run\.model_parallel .*"
                                         r"group's 1 rank\(s\).*model_parallel must divide"):
        Trainer(cfg, _dataset(cfg), device="cpu")


@pytest.mark.parametrize("world,data,model", [(4, -1, 3), (6, -1, 4), (6, 2, 2), (8, 2, 2),
                                              (4, 4, 2)],
                         ids=["model_does_not_divide", "model_does_not_divide6",
                              "idle_ranks", "idle_ranks8", "data_times_model_past_world"])
def test_a_mesh_off_the_world_is_refused(world, data, model):
    """model_parallel must divide the world, and data x model must be the
    world: JAX would leave the devices past it idle, an idle rank here would
    be a process with nothing to do."""
    with pytest.raises(ValueError, match=rf"group's {world} rank\(s\)"):
        mesh.mesh_shape(world, data, model)


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
