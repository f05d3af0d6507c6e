"""Checkpoint save and restore in the JAX package's own file format.

Counterpart of `coskad_tpu/train/checkpoint.py` (its msgpack flavor): one
flax-msgpack file, written atomically (`<path>.tmp`, then `os.replace`),
with `<path>.config.json` beside it. A checkpoint written by either package
is resumed, evaluated and served by either. The payload:

    {"state": {step, params, batch_stats, opt_state, rng, center, inv_cov,
               mean_vector, acc_vec, acc_weight, acc_outer},
     "scaler": {center, scale},   # when a robust scaler was fitted
     "extra": {...}}              # epoch, AUCs, schedule state

How the port's objects map onto `state`:

- `params` / `batch_stats`: the model's parameters and BatchNorm running
  statistics under their flax paths (`interop.to_jax_variables`).
- `opt_state`: the JAX optimizer is `optax.inject_hyperparams(optax.adam)`
  seen through `optax.flatten`, so the state is `{count, hyperparams: {b1,
  b2, eps, eps_root, learning_rate}, hyperparams_states: {}, inner_state:
  {"0": {count, mu, nu}, "1": {}}}`. `mu` and `nu` are ONE flat vector
  over all parameters, in `jax.flatten_util.ravel_pytree` order: the params
  tree's leaves with keys sorted at every level. They are cut into
  `torch.optim.Adam`'s per-parameter `exp_avg` / `exp_avg_sq` by name and
  shape, never by the order of `named_parameters()`. `count` is Adam's
  `step`, and `learning_rate` the live lr of every param group (the
  plateau reducer may have lowered it).
- `rng`: the port draws no JAX keys. It writes the value of
  `jax.random.PRNGKey(cfg.run.seed)` (`[0, seed]` for a seed below 2^32)
  and ignores the field on read: the VAE's samples come from generators
  seeded from (cfg.run.seed, step), and dropout's masks from generators
  seeded from (cfg.run.seed, step, 0x60).
- `mean_vector`: the VAE's scoring anchor, the last epoch's latent mean
  (`require_vae_anchor` refuses a VAE checkpoint without one).

In a process group every rank calls `save` and rank 0 alone writes, and
every rank reads on resume: the ranks hold the same weights, optimizer state and geometry. Under a model axis
(`parallel/mesh.py`) a rank holds blocks of the split kernels and of their
Adam moments: `state_payload` gathers them whole over the model group, so
every rank builds the payload together and the file is the one a single
process writes; a restore gives each rank its blocks.

The Orbax directory flavor of the JAX package (`save_orbax`,
`restore_orbax`) is refused by design, not left for later: nothing in the
JAX package calls it, orbax imports jax, and its array layout needs
tensorstore, which the card's machine does not have (ROADMAP.md,
"Deliberate differences").
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..data.normalize import RobustScalerState
from ..interop import flatten_tree, load_jax_variables, to_jax_variables
from ..parallel import mesh
from . import msgpack
from .state import TrainState

_GEOMETRY = ("center", "inv_cov", "mean_vector", "acc_vec", "acc_weight", "acc_outer")


def _prng_key(seed: int) -> np.ndarray:
    """The value of jax.random.PRNGKey(seed) for a non-negative seed."""
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def ravel_order(params: dict) -> list:
    """Flat names of a params tree in ravel_pytree order (keys sorted at
    every level)."""
    out = []
    for k in sorted(params):
        v = params[k]
        out += [f"{k}.{n}" for n in ravel_order(v)] if isinstance(v, dict) else [k]
    return out


def _adam(trainer) -> torch.optim.Adam:
    opt = trainer.optimizer
    if not isinstance(opt, torch.optim.Adam):
        raise TypeError(f"checkpoints carry Adam's state; the trainer's optimizer is "
                        f"{type(opt).__name__}")
    return opt


def _opt_state(trainer, params: dict) -> dict:
    """torch.optim.Adam's state as the JAX optimizer's opt_state."""
    opt = _adam(trainer)
    group = opt.param_groups[0]
    by_name = dict(trainer.model.named_parameters())
    whole = flatten_tree(params)
    lay = mesh.model_layout(trainer.model)
    mu, nu, steps = [], [], set()
    for name in ravel_order(params):
        st = opt.state.get(by_name[name], {})
        if st:
            steps.add(int(st["step"]))
            # a split kernel's moments are gathered whole over the model group
            for out, key in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
                out.append(mesh.whole(lay, name, st[key].detach()).cpu().numpy().ravel())
        else:
            steps.add(0)
            mu.append(np.zeros(whole[name].size, np.float32))
            nu.append(np.zeros(whole[name].size, np.float32))
    if len(steps) != 1:
        raise ValueError(f"Adam's parameters are at different steps {sorted(steps)}; the "
                         "JAX optimizer keeps one count")
    return adam_payload(steps.pop(), np.concatenate(mu), np.concatenate(nu), group["lr"],
                        group["betas"], group["eps"])


def adam_payload(step: int, mu: np.ndarray, nu: np.ndarray, lr: float,
                 betas=(0.9, 0.999), eps: float = 1e-8) -> dict:
    """The JAX optimizer's opt_state from Adam's step count, flat mu / nu
    (ravel_pytree order) and hyperparameters."""
    count = np.asarray(step, np.int32)
    f32 = lambda v: np.asarray(v, np.float32)  # noqa: E731
    return {
        "count": count,
        "hyperparams": {"b1": f32(betas[0]), "b2": f32(betas[1]), "eps": f32(eps),
                        "eps_root": f32(0.0), "learning_rate": f32(lr)},
        "hyperparams_states": {},
        "inner_state": {"0": {"count": count, "mu": f32(mu), "nu": f32(nu)}, "1": {}},
    }


def _load_opt_state(trainer, opt_state: dict, params: dict) -> None:
    """Fill torch.optim.Adam from the JAX optimizer's opt_state (after
    the model's parameters, whose names it checks)."""
    opt = _adam(trainer)
    hyper = opt_state["hyperparams"]
    if float(hyper["eps_root"]) != 0.0:
        raise ValueError("eps_root != 0 has no torch.optim.Adam counterpart")
    adam = opt_state["inner_state"]["0"]
    mu, nu = np.asarray(adam["mu"]), np.asarray(adam["nu"])
    by_name = dict(trainer.model.named_parameters())
    index = {id(p): i for i, p in enumerate(p for g in opt.param_groups for p in g["params"])}
    names = ravel_order(params)  # load_jax_variables checked them against the model
    shapes = {k: np.shape(v) for k, v in flatten_tree(params).items()}
    total = sum(int(np.prod(shapes[n])) for n in names)
    if mu.shape != (total,) or nu.shape != (total,):
        raise ValueError(f"mu/nu hold {mu.shape} values, the model {total}")
    lay = mesh.model_layout(trainer.model)
    step = int(adam["count"])
    state, offset = {}, 0
    for name in names:
        n = int(np.prod(shapes[name]))

        def moment(flat):  # this rank's block of a split kernel's moment
            whole = torch.from_numpy(flat[offset:offset + n].reshape(shapes[name]))
            return mesh.local_block(lay, name, whole).clone()

        state[index[id(by_name[name])]] = {"step": torch.tensor(float(step)),
                                           "exp_avg": moment(mu), "exp_avg_sq": moment(nu)}
        offset += n
    sd = opt.state_dict()
    sd["state"] = state if step > 0 else {}
    for g in sd["param_groups"]:
        g["lr"] = _hyper(g["lr"], hyper["learning_rate"])
        g["betas"] = (_hyper(g["betas"][0], hyper["b1"]), _hyper(g["betas"][1], hyper["b2"]))
        g["eps"] = _hyper(g["eps"], hyper["eps"])
    opt.load_state_dict(sd)


def _hyper(current: float, stored) -> float:
    """A hyperparameter from the checkpoint, which stores float32: the
    current value where it rounds to the stored one (so a resumed run keeps
    the exact lr it started with), else the stored value."""
    return current if np.float32(current) == np.float32(stored) else float(stored)


def state_payload(trainer, state: TrainState) -> dict:
    """The `state` entry of a checkpoint: the model, the optimizer and
    `state` in the JAX package's TrainState layout."""
    params, batch_stats = to_jax_variables(trainer.model)
    return tree_payload(params, batch_stats, _opt_state(trainer, params),
                        trainer.cfg.run.seed, state)


def tree_payload(params: dict, batch_stats: dict, opt_state: dict, seed: int,
                 state: TrainState) -> dict:
    """The `state` entry of a checkpoint from flax-named trees, an
    opt_state and the geometry of `state`."""
    out = {
        "step": np.asarray(state.step, np.int32),
        "params": params,
        "batch_stats": batch_stats,
        "opt_state": opt_state,
        "rng": _prng_key(seed),
    }
    for k in _GEOMETRY:
        out[k] = getattr(state, k).detach().cpu().numpy().astype(np.float32)
    return out


def load_state_payload(trainer, payload_state: dict) -> TrainState:
    """Fill trainer.model and trainer.optimizer from a checkpoint's `state`
    entry; returns the TrainState on the trainer's device."""
    params, batch_stats = payload_state["params"], payload_state["batch_stats"]
    load_jax_variables(trainer.model, params, batch_stats)
    _load_opt_state(trainer, payload_state["opt_state"], params)
    geometry = {k: torch.as_tensor(np.asarray(payload_state[k], np.float32),
                                   device=trainer.device) for k in _GEOMETRY}
    return TrainState(step=int(payload_state["step"]), **geometry)


def save(
    path: str,
    trainer,
    state: TrainState,
    cfg: Optional[Config] = None,
    scaler: Optional[RobustScalerState] = None,
    extra: Optional[dict] = None,
) -> str:
    """Write `trainer`'s model and optimizer with `state` to `path`, and the
    config snapshot beside it when `cfg` is given. In a process group every
    rank calls it (a model axis gathers the payload over the model group)
    and rank 0 alone writes."""
    payload = state_payload(trainer, state)
    return write(path, payload, cfg, scaler, extra) if trainer.layout.rank == 0 else path


def write(path: str, state: dict, cfg: Optional[Config] = None,
          scaler: Optional[RobustScalerState] = None, extra: Optional[dict] = None) -> str:
    """Write a checkpoint whose `state` entry is `state` (`state_payload`,
    `tree_payload`), and the config snapshot beside it when `cfg` is given."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"state": state}
    if scaler is not None:
        payload["scaler"] = {"center": np.asarray(scaler.center),
                             "scale": np.asarray(scaler.scale)}
    if extra:
        payload["extra"] = extra
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack.packb(payload))
    os.replace(tmp, path)
    if cfg is not None:
        with open(path + ".config.json", "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)
    return path


def read_payload(path: str) -> Dict:
    with open(path, "rb") as f:
        return msgpack.unpackb(f.read())


def scaler_of(payload: dict) -> Optional[RobustScalerState]:
    if "scaler" not in payload:
        return None
    return RobustScalerState(center=np.asarray(payload["scaler"]["center"]),
                             scale=np.asarray(payload["scaler"]["scale"]))


def load_scaler(path: str) -> Optional[RobustScalerState]:
    """Read just the fitted scaler from a checkpoint."""
    return scaler_of(read_payload(path))


def require_vae_anchor(cfg: Config, state: TrainState, path: str) -> None:
    """Raise for a VAE checkpoint whose anchor `mean_vector` is zero: every
    window would score 1 - cos(z, 0) = 1. Training sets the anchor at the
    end of every epoch, so only a checkpoint converted from the reference
    (which never stores it for 'ps') lacks it. The anchor is the training
    latents' mean: it is not recomputed from the split being scored."""
    if cfg.model.variant == "vae" and not bool(torch.any(state.mean_vector != 0)):
        raise ValueError(
            f"{path}: the VAE's scoring anchor mean_vector is missing (all zeros): the "
            "checkpoint was not written by a training epoch (a converted reference "
            "checkpoint stores none), and the anchor is the training latents' mean, which "
            "eval does not recompute from the test split; train at least one epoch and "
            "evaluate that checkpoint")


def restore(path: str, trainer, payload: Optional[dict] = None
            ) -> Tuple[TrainState, Optional[RobustScalerState], dict]:
    """Fill `trainer.model` and `trainer.optimizer` from the checkpoint at
    `path`; returns (TrainState, scaler or None, extra). Pass a `payload`
    from read_payload to read the file once."""
    if payload is None:
        payload = read_payload(path)
    state = load_state_payload(trainer, payload["state"])
    return state, scaler_of(payload), payload.get("extra", {})


ORBAX_REFUSED = (
    "the Orbax directory checkpoint flavor is not supported by coskad_tpu_torch: nothing in the "
    "JAX package calls it, orbax imports jax and its layout needs tensorstore; use the msgpack "
    "checkpoint (save / restore), which both packages read")


def save_orbax(*args, **kwargs):
    """Refused: see ORBAX_REFUSED."""
    raise NotImplementedError(ORBAX_REFUSED)


def restore_orbax(*args, **kwargs):
    """Refused: see ORBAX_REFUSED."""
    raise NotImplementedError(ORBAX_REFUSED)
