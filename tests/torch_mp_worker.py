"""Model-parallel scenarios of the port on the CPU, run by one process a rank.

    python tests/torch_mp_worker.py <rank> <world> <port> <weights.npz> <out_prefix> <name>...

Each rank joins a gloo group of `world` ranks and runs the named scenarios
(`SCENARIOS`) as a (world / 2) x 2 mesh (`run.model_parallel` 2), over
tests/torch_dp_worker.py's data, weights and draws: the results, gathered
whole (`interop.to_jax_variables`), go to <out_prefix><name>.rank<r>.npz
with each parameter's shape on this rank under `local_shape/`. The name
`checkpoint` restores <out_prefix>one.ckpt (a one-process checkpoint),
writes it back as <out_prefix>again.ckpt, trains one Adam epoch, writes
<out_prefix>trained.ckpt and records the latents; `fused_on` records the
message with which `fused_train: on` is refused.

`run(name, weights, model_parallel)` runs one scenario in the calling
process; at one rank it takes `model_parallel` 1 and the module path,
which `fused_train: auto` takes under a model axis. This module imports
neither jax nor the tests' conftest.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from coskad_tpu_torch.interop import flatten_tree, load_jax_variables, nest_flat, to_jax_variables
from coskad_tpu_torch.train import checkpoint
from coskad_tpu_torch.train.loop import Trainer

from torch_dp_worker import NARROW, StepLosses, _config, dataset

EPOCHS = 2

# name -> (config, SGD's learning rate)
SCENARIOS = {
    # held to JAX's 2 x 2 mesh and to one process
    "linear": (_config(dict(variant="euclidean_dynamic", projector="linear", **NARROW),
                       run=dict(fused_train="auto")), 1e-3),
    "mlp_head": (_config(dict(variant="euclidean_dynamic", projector="mlp",
                              projector_hidden_layers=(8, 6), **NARROW)), 1e-3),
    "autoencoder": (_config(dict(variant="autoencoder", projector="linear", **NARROW)),
                    1e-3),
    # held to one process: the draws
    "dropout": (_config(dict(variant="euclidean_dynamic", projector="linear", dropout=0.1,
                             **NARROW)), 1e-3),
    "vae": (_config(dict(variant="vae", distribution="ps", projector="linear", **NARROW),
                    run=dict(fused_train="off")), 1e-3),
}


def scenario_config(name: str, model_parallel: int):
    """The scenario's config on a mesh with `model_parallel` model ranks;
    at one, the module path where it says 'auto'."""
    cfg = SCENARIOS[name][0]
    run = dataclasses.replace(cfg.run, model_parallel=model_parallel)
    if model_parallel == 1 and run.fused_train == "auto":
        run = dataclasses.replace(run, fused_train="off")
    return dataclasses.replace(cfg, run=run)


def load_weights(trainer, name: str, weights) -> None:
    flat = {k[len(name) + 1:]: v for k, v in (weights or {}).items()
            if k.startswith(name + ".")}
    if flat:
        tree = nest_flat(flat)
        load_jax_variables(trainer.model, tree["params"], tree.get("batch_stats", {}))


def results(trainer, state, log, history, ds) -> dict:
    scores, rec = trainer.score_all(state, ds, trainer.train_data)
    params, stats = to_jax_variables(trainer.model)
    out = {"step_losses": np.asarray(log.losses), "epoch_losses": np.asarray(history["loss"]),
           "center": state.center.numpy(), "inv_cov": state.inv_cov.numpy(),
           "mean_vector": state.mean_vector.numpy(), "scores": scores, "rec": rec,
           "step": np.asarray(state.step)}
    out.update({f"params/{k}": v for k, v in flatten_tree(params).items()})
    out.update({f"batch_stats/{k}": v for k, v in flatten_tree(stats).items()})
    out.update({f"local_shape/{k}": np.asarray(p.shape)
                for k, p in trainer.model.named_parameters()})
    if hasattr(trainer.model, "rev_btlnk"):  # the decoder's K1 input, and the modules'
        probe = torch.linspace(-1.0, 1.0, 3 * trainer.cfg.model.latent_dim).reshape(3, -1)
        with torch.no_grad():
            out["rev_channel_major"] = trainer.model.rev_btlnk.channel_major(probe).numpy()
            out["rev_hidden"] = trainer.model.rev_btlnk(probe).numpy()
    return out


def run(name: str, weights=None, model_parallel: int = 1) -> dict:
    """One scenario in this process (its group's ranks, or one): its results
    as numpy arrays."""
    _, lr = SCENARIOS[name]
    ds = dataset()
    log = StepLosses()
    trainer = Trainer(scenario_config(name, model_parallel), ds, device="cpu", logger=log)
    load_weights(trainer, name, weights)
    trainer.optimizer = torch.optim.SGD(trainer.model.parameters(), lr=lr)
    state, history = trainer.fit(epochs=EPOCHS)
    return results(trainer, state, log, history, ds)


def checkpoint_trainer(model_parallel: int) -> Trainer:
    """The checkpoint round trip's trainer: the autoencoder scenario (both
    kinds of split kernel) under Adam."""
    ds = dataset()
    return Trainer(scenario_config("autoencoder", model_parallel), ds, device="cpu",
                   logger=StepLosses())


def checkpoint_round_trip(prefix: str, model_parallel: int) -> dict:
    """Restore the one-process checkpoint, write it back unchanged, train an
    Adam epoch from it and write that: the latents before and after."""
    trainer = checkpoint_trainer(model_parallel)
    state, _, extra = checkpoint.restore(f"{prefix}one.ckpt", trainer)
    z0 = trainer.embed_all(state, trainer.train_ds, trainer.train_data)
    checkpoint.save(f"{prefix}again.ckpt", trainer, state, trainer.cfg, extra=extra)
    state, _ = trainer.fit(state, epochs=1)
    checkpoint.save(f"{prefix}trained.ckpt", trainer, state, trainer.cfg,
                    extra={"epoch": 1})
    z1 = trainer.embed_all(state, trainer.train_ds, trainer.train_data)
    return {"z_restored": z0, "z_trained": z1, "center": state.center.numpy()}


def fused_on_message(model_parallel: int) -> dict:
    cfg = scenario_config("linear", model_parallel)
    cfg = dataclasses.replace(cfg, run=dataclasses.replace(cfg.run, fused_train="on"))
    try:
        Trainer(cfg, dataset(), device="cpu")
    except ValueError as e:
        return {"message": np.asarray(str(e))}
    return {"message": np.asarray("")}


def main(argv):
    rank, world, port, weights_path, prefix, *names = argv
    torch.set_num_threads(1)
    from coskad_tpu_torch.parallel import mesh

    mesh.initialize_distributed(f"localhost:{port}", int(world), int(rank), device="cpu")
    weights = dict(np.load(weights_path)) if weights_path != "-" else None
    for name in names:
        if name == "checkpoint":
            out = checkpoint_round_trip(prefix, 2)
        elif name == "fused_on":
            out = fused_on_message(2)
        else:
            out = run(name, weights, model_parallel=2)
        np.savez(f"{prefix}{name}.rank{rank}.npz", **out)
    mesh.barrier()
    mesh.destroy()


if __name__ == "__main__":
    main(sys.argv[1:])
