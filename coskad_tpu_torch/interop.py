"""Carry weights between the JAX package's flax variables and the port.

The port's modules are named after the flax variable tree, so a flax path
joined by '.' is the port's `state_dict` key:

    params/encoder/layer_0/tcn_dense/kernel  ->  encoder.layer_0.tcn_dense.kernel
    batch_stats/encoder/layer_0/tcn_bn/mean  ->  encoder.layer_0.tcn_bn.mean
    params/btlnk/kernel                      ->  btlnk.kernel

Dense kernels keep flax's [fan_in, features] layout and the projector keeps
its (T, V, C) flatten order, so no array is transposed on the way, in
either direction (`load_jax_variables`, `to_jax_variables`).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn


def flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts of arrays -> {'a.b.c': np.ndarray}."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def state_from_jax_variables(params: Mapping[str, Any],
                             batch_stats: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax {params, batch_stats} trees -> a state dict in the port's names."""
    flat = flatten_tree(params)
    stats = flatten_tree(batch_stats)
    clash = flat.keys() & stats.keys()
    if clash:
        raise ValueError(f"names in both params and batch_stats: {sorted(clash)}")
    flat.update(stats)
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in flat.items()}


def load_jax_variables(model: nn.Module, params: Mapping[str, Any],
                       batch_stats: Mapping[str, Any]) -> nn.Module:
    """Fill `model` in place from the flax {params, batch_stats} trees (nested
    dicts of numpy arrays), so both packages compute the same function.
    Raises if a name is missing or left over, or a shape differs."""
    state = state_from_jax_variables(params, batch_stats)
    own = model.state_dict()
    missing = sorted(own.keys() - state.keys())
    extra = sorted(state.keys() - own.keys())
    if missing or extra:
        raise ValueError(f"flax variables do not match the model: missing {missing}, "
                         f"unexpected {extra}")
    for k, v in state.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{k}: flax shape {tuple(v.shape)} != port shape "
                             f"{tuple(own[k].shape)}")
    model.load_state_dict(state)
    return model


def nest_flat(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """{'a.b.c': array} -> nested dicts {'a': {'b': {'c': array}}} (the
    inverse of `flatten_tree`)."""
    out: Dict[str, Any] = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def to_jax_variables(model: nn.Module) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The model as flax {params, batch_stats} trees of float32 numpy arrays
    (the reverse of `load_jax_variables`): parameters go to params, the
    BatchNorm running statistics (buffers) to batch_stats."""
    buffers = {k for k, _ in model.named_buffers()}
    params, stats = {}, {}
    for k, v in model.state_dict().items():
        (stats if k in buffers else params)[k] = v.detach().cpu().numpy().astype(np.float32)
    return nest_flat(params), nest_flat(stats)
