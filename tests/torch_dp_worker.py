"""Data-parallel scenarios of the port on the CPU, run by one process a rank.

    python tests/torch_dp_worker.py <rank> <world> <port> <weights.npz> <out_prefix> <name>...

Each rank joins a gloo group of `world` ranks (`parallel/mesh.py`), then
runs the named scenarios in order (`SCENARIOS`): a small Trainer over the
tests/mp_scenario.py data (96 windows, batch 32, 2 epochs), its weights
from <weights.npz> where it holds the scenario's flax trees (the keys of
`interop.flatten_tree` under `<name>.params.` and `<name>.batch_stats.`),
else drawn from the seed;
and writes <out_prefix><name>.rank<r>.npz: per-step losses, epoch losses,
center, inverse covariance, scores, every parameter and BN statistic.

`run(name, weights)` runs one scenario in the calling process, at world 1
when no group is live: the tests' one-process baseline. This module
imports neither jax nor the tests' conftest.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from coskad_tpu_torch import config as tconfig
from coskad_tpu_torch.data.windows import SegmentDataset
from coskad_tpu_torch.interop import flatten_tree, load_jax_variables, nest_flat, to_jax_variables
from coskad_tpu_torch.train.loop import Trainer
from coskad_tpu_torch.utils.logging import MetricLogger

N_WINDOWS, BATCH, EPOCHS = 96, 32, 2
FLAGSHIP = dict(channels=(32, 16, 32), h_dim=64, latent_dim=16)
NARROW = dict(channels=(8, 4, 8), h_dim=16, latent_dim=4)


def _config(model, run=None, opt=None, evaluation=None):
    return tconfig.Config(
        model=tconfig.ModelConfig(num_coords=2, **model),
        data=tconfig.DataConfig(seg_len=12, kp18_format=False, batch_size=BATCH,
                                num_transform=1),
        opt=tconfig.OptConfig(**{"lr": 1e-3, "epochs": EPOCHS, "validation": False,
                                 **(opt or {})}),
        eval=tconfig.EvalConfig(**(evaluation or {})),
        run=tconfig.RunConfig(**(run or {})))


# name -> (config, SGD's learning rate, fed VAE draws)
SCENARIOS = {
    # held to JAX's 4-device mesh (tests/test_torch_parallel.py)
    "module_mahalanobis": (_config(dict(variant="euclidean_static", distance="mahalanobis",
                                        projector="linear", **FLAGSHIP),
                                   run=dict(fused_train="off"), opt=dict(cov_shrinkage=0.5)),
                           1e-4, False),
    "fused_ghost8": (_config(dict(variant="euclidean_dynamic", projector="linear", **FLAGSHIP),
                             run=dict(fused_train="on", ghost_size=8)), 1e-4, False),
    # held to the one-process run
    "mlp_head": (_config(dict(variant="euclidean_dynamic", projector="mlp", **NARROW)),
                 1e-3, False),
    "dropout": (_config(dict(variant="euclidean_dynamic", projector="linear", dropout=0.1,
                             **NARROW)), 1e-3, False),
    "contrastive": (_config(dict(variant="euclidean_dynamic", projector="linear", **NARROW),
                            run=dict(fused_train="on", ghost_size=8),
                            opt=dict(contrastive_weight=0.5)), 1e-4, False),
    # trained on fed draws, scored by the posterior mean
    "vae": (_config(dict(variant="vae", distribution="ps", projector="linear", **NARROW),
                    run=dict(fused_train="off"), evaluation=dict(vae_sample=False)), 1e-3, True),
    # trained and scored on the Trainer's own draws
    "vae_sampled": (_config(dict(variant="vae", distribution="ps", projector="linear", **NARROW),
                            run=dict(fused_train="off")), 1e-3, False),
}


def dataset() -> SegmentDataset:
    """tests/mp_scenario.py's windows: 96 of [2, 12, 17], the last 8 at 3x."""
    rng = np.random.default_rng(0)
    data = rng.normal(size=(N_WINDOWS, 2, 12, 17)).astype(np.float32)
    data[-8:] *= 3.0
    return SegmentDataset(data, np.tile([1, 1, 1, 1], (N_WINDOWS, 1)).astype(np.int64),
                          np.tile(np.arange(1, 13), (N_WINDOWS, 1)).astype(np.int32),
                          num_transform=1)


def fed_draws(step: int, latent: int):
    """The VAE's fed draws of a step for the global batch: (z01 [B], v_raw
    [B, D - 1])."""
    rng = np.random.default_rng((7, step))
    return (torch.from_numpy(rng.uniform(0.05, 0.95, size=BATCH).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(BATCH, latent - 1)).astype(np.float32)))


class StepLosses(MetricLogger):
    """Every step's loss, nothing printed."""

    def __init__(self):
        super().__init__(every_n_steps=1)
        self.losses = []

    def log(self, metrics, step, force=False):
        if "loss" in metrics:
            self.losses.append(float(metrics["loss"]))


def run(name: str, weights=None) -> dict:
    """One scenario in this process (its group's ranks, or one): its results
    as numpy arrays."""
    cfg, lr, vae_fed = SCENARIOS[name]
    ds = dataset()
    log = StepLosses()
    trainer = Trainer(cfg, ds, device="cpu", logger=log)
    flat = {k[len(name) + 1:]: v for k, v in (weights or {}).items()
            if k.startswith(name + ".")}
    if flat:
        tree = nest_flat(flat)
        load_jax_variables(trainer.model, tree["params"], tree.get("batch_stats", {}))
    # SGD: Adam turns the rounding noise of the pre-BN biases' zero gradient
    # into +-lr steps (ROADMAP.md, "Scores after Adam")
    trainer.optimizer = torch.optim.SGD(trainer.model.parameters(), lr=lr)
    if vae_fed:
        inner = trainer.train_step

        def fed(state, data, indices, frozen_bn=False, **kw):
            return inner(state, data, indices, frozen_bn=frozen_bn,
                         vae_draws=fed_draws(state.step, cfg.model.latent_dim))

        trainer.train_step = fed
    state, history = trainer.fit(epochs=EPOCHS)
    scores, _ = trainer.score_all(state, ds, trainer.train_data)
    params, stats = to_jax_variables(trainer.model)
    out = {"step_losses": np.asarray(log.losses), "epoch_losses": np.asarray(history["loss"]),
           "center": state.center.numpy(), "inv_cov": state.inv_cov.numpy(),
           "mean_vector": state.mean_vector.numpy(), "scores": scores,
           "step": np.asarray(state.step)}
    out.update({f"params/{k}": v for k, v in flatten_tree(params).items()})
    out.update({f"batch_stats/{k}": v for k, v in flatten_tree(stats).items()})
    return out


def main(argv):
    rank, world, port, weights_path, prefix, *names = argv
    torch.set_num_threads(1)
    from coskad_tpu_torch.parallel import mesh

    mesh.initialize_distributed(f"localhost:{port}", int(world), int(rank), device="cpu")
    weights = dict(np.load(weights_path)) if weights_path != "-" else None
    for name in names:
        np.savez(f"{prefix}{name}.rank{rank}.npz", **run(name, weights))
    mesh.barrier()
    mesh.destroy()


if __name__ == "__main__":
    main(sys.argv[1:])
