"""Carry weights between the JAX package's flax variables and the port.

The port's modules are named after the flax variable tree, so a flax path
joined by '.' is the port's `state_dict` key:

    params/encoder/layer_0/tcn_dense/kernel  ->  encoder.layer_0.tcn_dense.kernel
    batch_stats/encoder/layer_0/tcn_bn/mean  ->  encoder.layer_0.tcn_bn.mean
    params/btlnk/kernel                      ->  btlnk.kernel
    params/btlnk/bn_0/scale                  ->  btlnk.bn_0.scale   (MLP head)
    batch_stats/btlnk/bn_0/var               ->  btlnk.bn_0.var
    params/rev_btlnk/kernel                  ->  rev_btlnk.kernel   (STSAE, STSVAE)
    params/decoder/layer_3/tcn_dense/kernel  ->  decoder.layer_3.tcn_dense.kernel
    params/fc_mean/kernel                    ->  fc_mean.kernel     (STSVAE)
    params/encoder/edge_importance_0         ->  encoder.edge_importance_0   (st_gcn)
    batch_stats/encoder/data_bn/mean         ->  encoder.data_bn.mean
    params/encoder/layer_0/tconv/kernel      ->  encoder.layer_0.tconv.kernel [9, 1, C_in, C_out]
    params/encoder/layer_0/bn1/scale         ->  encoder.layer_0.bn1.scale   (also gcn_dense,
                                                 residual_dense, residual_bn, bn2)
    params/encoder/adj_0                     ->  encoder.adj_0               (learnable_gcn)
    params/encoder/layer_0/weight            ->  encoder.layer_0.weight      (learnable_gcn,
                                                 static_gcn; and bias)
    params/encoder/dense_0/kernel            ->  encoder.dense_0.kernel      (cnn; bn_0.*)

Dense kernels keep flax's [fan_in, features] layout, the temporal
convolution its [k, 1, C_in, C_out] kernel and the projector its (T, V, C)
flatten order, so no array is transposed on the way, in either direction
(`load_jax_variables`, `to_jax_variables`). Every array is matched by its
name, never by its position in a tree.

Reference checkpoints (counterpart of `coskad_tpu/interop.py`): a user of
the reference COSKAD repo has PyTorch-Lightning `.ckpt` files (the model's
`state_dict` under a `model.` prefix, with the registered buffers `c`,
`inv_cov_matrix` and `mean_vector`) and, for robust-normalized data, a
fitted sklearn `RobustScaler` pickle. `convert_checkpoint` turns both into
a checkpoint of the JAX package's format (`train/checkpoint.py`), which
`cli.eval` and `cli.train --resume` of either package load;
`export_checkpoint` goes back. The layout rules, as JAX's:

  * STS-GCN layers: `gcn.A` / `gcn.T` copy; the 1x1 Conv2d `tcn.0` becomes
    a dense kernel (`w[:, :, 0, 0].T`); BatchNorm weight / bias -> scale /
    bias, running statistics -> batch_stats; PReLU's one weight -> `alpha`;
    the channel-changing residual maps the same way.
  * The linear projector `btlnk` and the VAE's identity-projector heads
    `fc_mean` / `fc_var` read the hidden state flattened (C, T, V) in the
    reference and (T, V, C) here: the Linear weight is permuted, then
    transposed into a kernel. `rev_btlnk`'s kernel is the weight transposed.
  * learnable_gcn / static_gcn: `gcn.weight` is [in, out] and copies;
    `gcn.Adj` is the learnable adjacency `adj_i`; the static encoder's
    fixed `encoder.Adj` rides along unchanged.
  * MLP projectors: the Linear / BatchNorm1d entries under `btlnk`, in
    index order, become `hidden_i` / `bn_i` / `out`.
  * `st_gcn` is not convertible (the reference cannot build it).

The templates come from the port's own model (`build_model`, then
`to_jax_variables`), whose trees carry flax's names; the trees returned
are nested dicts of numpy arrays under JAX's paths.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .parallel import mesh


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
    Raises if a name is missing or left over, or a shape differs. A model
    split over a model axis (`mesh.shard_model`) takes this rank's block of
    each whole split kernel."""
    lay = mesh.model_layout(model)
    state = {k: mesh.local_block(lay, k, v)
             for k, v in state_from_jax_variables(params, batch_stats).items()}
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
    BatchNorm running statistics (buffers) to batch_stats. A model split
    over a model axis gives its whole kernels, gathered over the model
    group: every rank of the group calls this together."""
    lay = mesh.model_layout(model)
    buffers = {k for k, _ in model.named_buffers()}
    params, stats = {}, {}
    for k, v in model.state_dict().items():
        v = mesh.whole(lay, k, v.detach())
        (stats if k in buffers else params)[k] = v.cpu().numpy().astype(np.float32)
    return nest_flat(params), nest_flat(stats)


# ------------------------------------------------- reference checkpoints

# keys of reference checkpoints that carry no convertible state
_IGNORED_SUFFIXES = ("num_batches_tracked",)
_IGNORED_KEYS = ("threshold_dist",)  # registered but never read (the reference's vae.py)
_CONVERTIBLE = ("sts_gcn", "learnable_gcn", "static_gcn")


class ConversionError(ValueError):
    pass


def load_torch_state_dict(path: str) -> Tuple[Dict[str, np.ndarray], dict]:
    """A torch / Lightning checkpoint as ({key: np.ndarray}, meta): a
    Lightning dict (with 'state_dict'), a bare state dict or a pickled
    `nn.Module`, with the Lightning module's `model.` prefix stripped; meta
    carries the Lightning 'epoch' if present."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    meta: dict = {}
    if hasattr(obj, "state_dict"):  # a pickled nn.Module
        sd = obj.state_dict()
    elif isinstance(obj, dict) and "state_dict" in obj:
        sd = obj["state_dict"]
        if isinstance(obj.get("epoch"), int):
            meta["epoch"] = obj["epoch"]
    elif isinstance(obj, dict):
        sd = obj
    else:
        raise ConversionError(f"unrecognized checkpoint object: {type(obj)}")
    out = {str(k): np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)
           for k, v in sd.items()}
    if out and all(k.startswith("model.") for k in out):
        out = {k[len("model."):]: v for k, v in out.items()}
    return out, meta


def _assign(tree: dict, path: List[str], value: np.ndarray) -> None:
    node = tree
    for p in path[:-1]:
        if p not in node:
            raise ConversionError(
                f"template has no node {'/'.join(path)} (at {p!r}; have {sorted(node)})")
        node = node[p]
    leaf = path[-1]
    if leaf not in node:
        raise ConversionError(f"template has no leaf {'/'.join(path)} (have {sorted(node)})")
    tmpl = np.asarray(node[leaf])
    node[leaf] = np.asarray(value, dtype=tmpl.dtype).reshape(tmpl.shape)


def _pop(sd: Dict[str, np.ndarray], key: str) -> np.ndarray:
    if key not in sd:
        raise ConversionError(f"reference checkpoint is missing key {key!r}")
    return sd.pop(key)


def _conv1x1_kernel(w: np.ndarray) -> np.ndarray:
    """torch Conv2d weight [out, in, 1, 1] -> dense kernel [in, out]."""
    if w.ndim != 4 or w.shape[2:] != (1, 1):
        raise ConversionError(f"expected a 1x1 conv weight, got {w.shape}")
    return np.ascontiguousarray(w[:, :, 0, 0].T)


def _linear_ctv_kernel(w: np.ndarray, c: int, t: int, v: int) -> np.ndarray:
    """torch Linear weight [out, C*T*V] over the (C, T, V) flatten -> kernel
    [T*V*C, out] over the (T, V, C) flatten."""
    out = w.shape[0]
    if w.shape[1] != c * t * v:
        raise ConversionError(f"linear fan-in {w.shape[1]} != C*T*V = {c}*{t}*{v}")
    w4 = w.reshape(out, c, t, v).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(w4.reshape(out, -1).T)


def _dense_to_conv1x1(kernel: np.ndarray) -> np.ndarray:
    """Dense kernel [in, out] -> torch Conv2d weight [out, in, 1, 1]."""
    return np.ascontiguousarray(kernel.T)[:, :, None, None]


def _kernel_to_linear_ctv(k: np.ndarray, c: int, t: int, v: int) -> np.ndarray:
    """The inverse of `_linear_ctv_kernel`."""
    out = k.shape[1]
    w4 = k.T.reshape(out, t, v, c).transpose(0, 3, 1, 2)
    return np.ascontiguousarray(w4.reshape(out, -1))


def _map_stsgcn_stack(sd: Dict[str, np.ndarray], src: str, params: dict, stats: dict,
                      in_channels: int, schedule: List[int]) -> None:
    """A reference Encoder / Decoder (a Sequential of ST_GCNN_layer under
    `<src>.model`) onto the `layer_{i}` trees of an STS-GCN stack."""
    for i, out_ch in enumerate(schedule):
        lp, ls = params[f"layer_{i}"], stats[f"layer_{i}"]
        key = f"{src}.model.{i}"
        _assign(lp, ["gcn", "a_adj"], _pop(sd, f"{key}.gcn.A"))
        _assign(lp, ["gcn", "t_adj"], _pop(sd, f"{key}.gcn.T"))
        _assign(lp, ["tcn_dense", "kernel"], _conv1x1_kernel(_pop(sd, f"{key}.tcn.0.weight")))
        if f"{key}.tcn.0.bias" in sd:
            _assign(lp, ["tcn_dense", "bias"], _pop(sd, f"{key}.tcn.0.bias"))
        _assign(lp, ["tcn_bn", "scale"], _pop(sd, f"{key}.tcn.1.weight"))
        _assign(lp, ["tcn_bn", "bias"], _pop(sd, f"{key}.tcn.1.bias"))
        _assign(ls, ["tcn_bn", "mean"], _pop(sd, f"{key}.tcn.1.running_mean"))
        _assign(ls, ["tcn_bn", "var"], _pop(sd, f"{key}.tcn.1.running_var"))
        _assign(lp, ["prelu", "alpha"], _pop(sd, f"{key}.prelu.weight"))
        has_residual = f"{key}.residual.0.weight" in sd
        if has_residual != (in_channels != out_ch):
            raise ConversionError(
                f"{key}: residual branch presence ({has_residual}) does not match the "
                f"channel schedule {in_channels}->{out_ch}")
        if has_residual:
            _assign(lp, ["residual_dense", "kernel"],
                    _conv1x1_kernel(_pop(sd, f"{key}.residual.0.weight")))
            if f"{key}.residual.0.bias" in sd:
                _assign(lp, ["residual_dense", "bias"], _pop(sd, f"{key}.residual.0.bias"))
            _assign(lp, ["residual_bn", "scale"], _pop(sd, f"{key}.residual.1.weight"))
            _assign(lp, ["residual_bn", "bias"], _pop(sd, f"{key}.residual.1.bias"))
            _assign(ls, ["residual_bn", "mean"], _pop(sd, f"{key}.residual.1.running_mean"))
            _assign(ls, ["residual_bn", "var"], _pop(sd, f"{key}.residual.1.running_var"))
        in_channels = out_ch


def _export_stsgcn_stack(sd: Dict[str, np.ndarray], src: str, params: dict, stats: dict,
                         in_channels: int, schedule: List[int]) -> None:
    zero = np.zeros((), np.int64)
    for i, out_ch in enumerate(schedule):
        lp, ls = params[f"layer_{i}"], stats[f"layer_{i}"]
        key = f"{src}.model.{i}"
        sd[f"{key}.gcn.A"] = np.asarray(lp["gcn"]["a_adj"])
        sd[f"{key}.gcn.T"] = np.asarray(lp["gcn"]["t_adj"])
        sd[f"{key}.tcn.0.weight"] = _dense_to_conv1x1(np.asarray(lp["tcn_dense"]["kernel"]))
        if "bias" in lp["tcn_dense"]:
            sd[f"{key}.tcn.0.bias"] = np.asarray(lp["tcn_dense"]["bias"])
        sd[f"{key}.tcn.1.weight"] = np.asarray(lp["tcn_bn"]["scale"])
        sd[f"{key}.tcn.1.bias"] = np.asarray(lp["tcn_bn"]["bias"])
        sd[f"{key}.tcn.1.running_mean"] = np.asarray(ls["tcn_bn"]["mean"])
        sd[f"{key}.tcn.1.running_var"] = np.asarray(ls["tcn_bn"]["var"])
        sd[f"{key}.tcn.1.num_batches_tracked"] = zero
        sd[f"{key}.prelu.weight"] = np.asarray(lp["prelu"]["alpha"]).reshape(1)
        if in_channels != out_ch:
            sd[f"{key}.residual.0.weight"] = _dense_to_conv1x1(
                np.asarray(lp["residual_dense"]["kernel"]))
            if "bias" in lp["residual_dense"]:
                sd[f"{key}.residual.0.bias"] = np.asarray(lp["residual_dense"]["bias"])
            sd[f"{key}.residual.1.weight"] = np.asarray(lp["residual_bn"]["scale"])
            sd[f"{key}.residual.1.bias"] = np.asarray(lp["residual_bn"]["bias"])
            sd[f"{key}.residual.1.running_mean"] = np.asarray(ls["residual_bn"]["mean"])
            sd[f"{key}.residual.1.running_var"] = np.asarray(ls["residual_bn"]["var"])
            sd[f"{key}.residual.1.num_batches_tracked"] = zero
        in_channels = out_ch


def _map_plain_gcn_encoder(sd: Dict[str, np.ndarray], params: dict, n_layers: int,
                           learnable: bool) -> None:
    """The reference's learnable / static plain-GCN encoders (a `gcns`
    ModuleList): `gcn.weight` is [in, out] already and copies."""
    for i in range(n_layers):
        key = f"encoder.gcns.{i}.gcn"
        layer = params["encoder"][f"layer_{i}"]
        _assign(layer, ["weight"], _pop(sd, f"{key}.weight"))
        if f"{key}.bias" in sd:
            _assign(layer, ["bias"], _pop(sd, f"{key}.bias"))
        if learnable:
            _assign(params["encoder"], [f"adj_{i}"], _pop(sd, f"{key}.Adj"))


def _mlp_groups(sd: Dict[str, np.ndarray], prefix: str):
    """The Linear (2-D weight) and BatchNorm1d (with running statistics)
    entries under `prefix`, in index order, popped from sd: (linears, bns)
    as lists of dicts."""
    pat = re.compile(re.escape(prefix)
                     + r"\.(.*?)(\d+)\.(weight|bias|running_mean|running_var)$")
    found: Dict[int, dict] = {}
    for k in sorted(sd):
        m = pat.match(k)
        if m:
            found.setdefault(int(m.group(2)), {})[m.group(3)] = sd.pop(k)
    linears, bns = [], []
    for idx in sorted(found):
        entry = found[idx]
        if "running_mean" in entry:
            bns.append(entry)
        elif entry.get("weight") is not None and entry["weight"].ndim == 2:
            linears.append(entry)
        else:
            raise ConversionError(f"unrecognized module at {prefix}[{idx}]: keys {sorted(entry)}")
    return linears, bns


def _map_mlp_head(sd: Dict[str, np.ndarray], src: str, params: dict, stats: dict,
                  first_ctv: Optional[Tuple[int, int, int]]) -> None:
    """A reference MLP (Linear + BN + ReLU per hidden layer, then a Linear)
    onto the MLP head's hidden_i / bn_i / out; `first_ctv` is (C, T, V)
    where the first Linear reads the (C, T, V)-flat hidden state."""
    linears, bns = _mlp_groups(sd, src)
    n_hidden = len(linears) - 1
    expected = ({f"hidden_{i}" for i in range(n_hidden)} | {"out"}
                | {f"bn_{i}" for i in range(n_hidden)})
    if expected != set(params):
        raise ConversionError(
            f"{src}: reference MLP has {n_hidden} hidden layers but the config's "
            f"projector_hidden_layers built {sorted(params)}")
    if len(bns) != n_hidden:
        raise ConversionError(f"{src}: found {len(bns)} BN entries for {n_hidden} hidden layers")
    for i, lin in enumerate(linears):
        name = f"hidden_{i}" if i < n_hidden else "out"
        w = lin["weight"]
        kernel = (_linear_ctv_kernel(w, *first_ctv) if i == 0 and first_ctv is not None
                  else np.ascontiguousarray(w.T))
        _assign(params[name], ["kernel"], kernel)
        if "bias" in lin:
            _assign(params[name], ["bias"], lin["bias"])
    for i, bn in enumerate(bns):
        _assign(params[f"bn_{i}"], ["scale"], bn["weight"])
        _assign(params[f"bn_{i}"], ["bias"], bn["bias"])
        _assign(stats[f"bn_{i}"], ["mean"], bn["running_mean"])
        _assign(stats[f"bn_{i}"], ["var"], bn["running_var"])


def _kinds(model) -> Tuple[bool, bool]:
    from .models.stse import STSAE, STSVAE

    return isinstance(model, STSVAE), isinstance(model, STSAE)


def _decoder_schedule(model) -> List[int]:
    return list(model.decoder_channels or list(model.layer_channels)[::-1]) + [model.input_dim]


def convert_state_dict(sd: Dict[str, np.ndarray], model
                       ) -> Tuple[dict, dict, dict, Dict[str, np.ndarray]]:
    """A reference state dict -> (params, batch_stats, buffers, passthrough)
    for the port's `model` (STSE / STSAE / STSVAE of `models.stse`), as
    nested dicts of numpy arrays under flax's paths. `buffers` holds
    center / inv_cov / mean_vector for the checkpoint's state; `passthrough`
    the torch-only bookkeeping (num_batches_tracked, threshold_dist, the
    static encoder's encoder.Adj) that an export puts back unchanged. A key
    left over raises."""
    sd = dict(sd)
    et = model.encoder_type.lower()
    if et == "st_gcn":
        raise ConversionError(
            "encoder_type 'st_gcn' is unconvertible: the reference snapshot cannot construct "
            "it (its models/graph_layers/stgcn.py), so no such checkpoint exists")
    if et not in _CONVERTIBLE:
        raise ConversionError(f"no conversion rule for encoder_type {et!r}")
    c_in, t, v = model.input_dim, model.n_frames, model.n_joints
    hidden, latent = model.hidden_dimension, model.latent_dim
    is_vae, is_ae = _kinds(model)
    params, stats = to_jax_variables(model)

    buffers = {}
    for src_key, dst_key in (("c", "center"), ("inv_cov_matrix", "inv_cov"),
                             ("mean_vector", "mean_vector")):
        if src_key in sd:
            # the reference registers mean_vector as [1, D]
            shape = (latent, latent) if dst_key == "inv_cov" else (latent,)
            buffers[dst_key] = np.asarray(sd.pop(src_key), np.float32).reshape(shape)
    if is_vae and model.distribution == "ps" and "mean_vector" not in buffers:
        # the reference's 'ps' VAE never registers mean_vector, so no such
        # checkpoint carries the scoring anchor
        print("[convert] note: 'ps' VAE checkpoints cannot carry mean_vector (the reference "
              "never registers it); the port's cli.eval and AnomalyScorer refuse the converted "
              "checkpoint until a training epoch sets the anchor (cli.train --resume)")

    schedule = list(model.layer_channels) + [hidden]
    if et == "sts_gcn":
        _map_stsgcn_stack(sd, "encoder", params["encoder"], stats.get("encoder", {}), c_in,
                          schedule)
    else:
        _map_plain_gcn_encoder(sd, params, len(schedule), learnable=et == "learnable_gcn")

    ctv = (hidden, t, v)
    mlp = model.projector.lower() == "mlp"
    if is_vae:
        # the identity projector's heads read the flat hidden state; the MLP
        # head's read its latent
        for head in ("fc_mean", "fc_var"):
            w = _pop(sd, f"{head}.weight")
            _assign(params[head], ["kernel"],
                    np.ascontiguousarray(w.T) if mlp else _linear_ctv_kernel(w, *ctv))
            if f"{head}.bias" in sd:
                _assign(params[head], ["bias"], _pop(sd, f"{head}.bias"))
    if mlp:
        _map_mlp_head(sd, "btlnk", params["btlnk"], stats.get("btlnk", {}), first_ctv=ctv)
    elif not is_vae:
        _assign(params["btlnk"], ["kernel"], _linear_ctv_kernel(_pop(sd, "btlnk.weight"), *ctv))
        if "btlnk.bias" in sd:
            _assign(params["btlnk"], ["bias"], _pop(sd, "btlnk.bias"))

    if is_ae:
        w = _pop(sd, "rev_btlnk.weight")
        if w.shape != (hidden * t * v, latent):
            raise ConversionError(f"rev_btlnk weight {w.shape} != ({hidden * t * v}, {latent})")
        _assign(params["rev_btlnk"], ["kernel"], np.ascontiguousarray(w.T))
        if "rev_btlnk.bias" in sd:
            _assign(params["rev_btlnk"], ["bias"], _pop(sd, "rev_btlnk.bias"))
        _map_stsgcn_stack(sd, "decoder", params["decoder"], stats.get("decoder", {}), hidden,
                          _decoder_schedule(model))

    # exactly the static encoder's one persisted buffer: a suffix match would
    # also swallow a learnable_gcn checkpoint's per-layer gcn.Adj under a
    # static_gcn config, which the leftover check below must catch
    passthrough = {k: sd.pop(k) for k in list(sd)
                   if k.endswith(_IGNORED_SUFFIXES) or k in _IGNORED_KEYS
                   or (et == "static_gcn" and k == "encoder.Adj")}
    if sd:
        raise ConversionError(f"unconverted reference keys (mapping gap?): {sorted(sd)}")
    return params, stats, buffers, passthrough


def convert_checkpoint(ckpt_path: str, cfg, out_path: Optional[str] = None,
                       scaler_path: Optional[str] = None,
                       allow_missing_scaler: bool = False) -> str:
    """A reference Lightning checkpoint (and its `robust.pkl`) -> a
    checkpoint at `out_path` (default <ckpt_dir>/converted.ckpt) in the JAX
    package's format: the converted trees, a zero Adam state in optax's
    flat mu / nu layout, rng = PRNGKey(cfg.run.seed), the reference's
    buffers, and extra {epoch, converted_from, torch_passthrough}. A
    robust-normalized config needs the scaler: without it eval would fit
    another one on the test split, so this raises unless
    `allow_missing_scaler`."""
    if (scaler_path is None and not allow_missing_scaler
            and cfg.data.normalization_strategy == "robust"):
        raise ConversionError(
            "this config uses normalization_strategy 'robust': pass the reference run's "
            "fitted-scaler pickle (robust.pkl) via scaler_path/--scaler, or force with "
            "allow_missing_scaler/--allow-missing-scaler (eval would then fit a scaler on "
            "the test split, NOT the coordinate system the checkpoint was trained in)")
    from .models.stse import build_model
    from .train import checkpoint
    from .train.loop import model_kwargs_from_config
    from .train.state import init_state

    model = build_model(**model_kwargs_from_config(cfg))
    sd, meta = load_torch_state_dict(ckpt_path)
    params, stats, buffers, passthrough = convert_state_dict(sd, model)
    n = sum(np.asarray(v).size for v in flatten_tree(params).values())
    zeros = np.zeros(n, np.float32)
    state = init_state(cfg.model.latent_dim, torch.device("cpu")).replace(
        **{k: torch.from_numpy(v) for k, v in buffers.items()})
    payload = checkpoint.tree_payload(params, stats,
                                      checkpoint.adam_payload(0, zeros, zeros, cfg.opt.lr),
                                      cfg.run.seed, state)
    scaler = load_sklearn_scaler(scaler_path) if scaler_path else None
    out_path = out_path or os.path.join(cfg.ckpt_dir, "converted.ckpt")
    extra = {"epoch": int(meta.get("epoch", -1)),
             "converted_from": os.path.abspath(ckpt_path)}
    if passthrough:
        extra["torch_passthrough"] = {k: np.asarray(v) for k, v in passthrough.items()}
    return checkpoint.write(out_path, payload, cfg=cfg, scaler=scaler, extra=extra)


def export_state_dict(model, params: dict, stats: dict, buffers: Dict[str, np.ndarray],
                      distance: str = "euclidean") -> Dict[str, np.ndarray]:
    """The inverse of `convert_state_dict`: flax-named trees and buffers ->
    a reference state dict (bare model keys). A params subtree the config's
    model does not map raises (a wrong --config)."""
    et = model.encoder_type.lower()
    if et not in _CONVERTIBLE:
        raise ConversionError(f"no export rule for encoder_type {et!r}")
    c_in, t, v = model.input_dim, model.n_frames, model.n_joints
    hidden, latent = model.hidden_dimension, model.latent_dim
    is_vae, is_ae = _kinds(model)
    ctv = (hidden, t, v)
    sd: Dict[str, np.ndarray] = {}

    sd["c"] = np.asarray(buffers.get("center", np.zeros(latent, np.float32)))
    if distance.lower() == "mahalanobis":
        sd["inv_cov_matrix"] = np.asarray(
            buffers.get("inv_cov", np.zeros((latent, latent), np.float32)))
    if is_vae:
        if model.distribution == "normal":
            sd["mean_vector"] = np.asarray(
                buffers.get("mean_vector", np.zeros(latent, np.float32))).reshape(1, latent)
        sd["threshold_dist"] = np.zeros((), np.float32)

    schedule = list(model.layer_channels) + [hidden]
    expected = {f"layer_{i}" for i in range(len(schedule))}
    if et == "learnable_gcn":
        expected |= {f"adj_{i}" for i in range(len(schedule))}
    if set(params["encoder"]) != expected:
        raise ConversionError(
            f"encoder params {sorted(params['encoder'])} do not match the config's layer "
            f"schedule (expected {sorted(expected)}): wrong --config for this checkpoint?")
    consumed = {"encoder"}
    if et == "sts_gcn":
        _export_stsgcn_stack(sd, "encoder", params["encoder"], stats.get("encoder", {}), c_in,
                             schedule)
    else:
        for i in range(len(schedule)):
            key = f"encoder.gcns.{i}.gcn"
            layer = params["encoder"][f"layer_{i}"]
            sd[f"{key}.weight"] = np.asarray(layer["weight"])
            if "bias" in layer:
                sd[f"{key}.bias"] = np.asarray(layer["bias"])
            if et == "learnable_gcn":
                sd[f"{key}.Adj"] = np.asarray(params["encoder"][f"adj_{i}"])
        if et == "static_gcn":
            # the reference persists its fixed space-time adjacency
            from .models.graph import build_spacetime_adjacency

            sd["encoder.Adj"] = np.asarray(build_spacetime_adjacency(t, v), np.float32)

    def export_mlp(p: dict, s: dict):
        # the reference MLP's layout: Linear + BN1d + ReLU a hidden layer
        # under `net`, then the last Linear
        n_hidden = sum(1 for name in p if name.startswith("hidden_"))
        for i in range(n_hidden):
            w = np.asarray(p[f"hidden_{i}"]["kernel"])
            sd[f"btlnk.net.{3 * i}.weight"] = (_kernel_to_linear_ctv(w, *ctv) if i == 0
                                               else np.ascontiguousarray(w.T))
            if "bias" in p[f"hidden_{i}"]:
                sd[f"btlnk.net.{3 * i}.bias"] = np.asarray(p[f"hidden_{i}"]["bias"])
            bn = f"btlnk.net.{3 * i + 1}"
            sd[f"{bn}.weight"] = np.asarray(p[f"bn_{i}"]["scale"])
            sd[f"{bn}.bias"] = np.asarray(p[f"bn_{i}"]["bias"])
            sd[f"{bn}.running_mean"] = np.asarray(s[f"bn_{i}"]["mean"])
            sd[f"{bn}.running_var"] = np.asarray(s[f"bn_{i}"]["var"])
            sd[f"{bn}.num_batches_tracked"] = np.zeros((), np.int64)
        w = np.asarray(p["out"]["kernel"])
        sd[f"btlnk.net.{3 * n_hidden}.weight"] = (_kernel_to_linear_ctv(w, *ctv) if n_hidden == 0
                                                  else np.ascontiguousarray(w.T))
        if "bias" in p["out"]:
            sd[f"btlnk.net.{3 * n_hidden}.bias"] = np.asarray(p["out"]["bias"])

    mlp = model.projector.lower() == "mlp"
    if is_vae:
        for head in ("fc_mean", "fc_var"):
            k = np.asarray(params[head]["kernel"])
            sd[f"{head}.weight"] = (np.ascontiguousarray(k.T) if mlp
                                    else _kernel_to_linear_ctv(k, *ctv))
            if "bias" in params[head]:
                sd[f"{head}.bias"] = np.asarray(params[head]["bias"])
            consumed.add(head)
    if mlp:
        export_mlp(params["btlnk"], stats.get("btlnk", {}))
        consumed.add("btlnk")
    elif not is_vae:
        sd["btlnk.weight"] = _kernel_to_linear_ctv(np.asarray(params["btlnk"]["kernel"]), *ctv)
        if "bias" in params["btlnk"]:
            sd["btlnk.bias"] = np.asarray(params["btlnk"]["bias"])
        consumed.add("btlnk")

    if is_ae:
        sd["rev_btlnk.weight"] = np.ascontiguousarray(np.asarray(params["rev_btlnk"]["kernel"]).T)
        if "bias" in params["rev_btlnk"]:
            sd["rev_btlnk.bias"] = np.asarray(params["rev_btlnk"]["bias"])
        _export_stsgcn_stack(sd, "decoder", params["decoder"], stats.get("decoder", {}), hidden,
                             _decoder_schedule(model))
        consumed |= {"rev_btlnk", "decoder"}

    unread = set(params) - consumed
    if unread:
        raise ConversionError(
            f"checkpoint has params the config's model does not map: {sorted(unread)}: wrong "
            "--config for this checkpoint?")
    return {k: val if val.dtype == np.int64 else np.asarray(val, np.float32)
            for k, val in sd.items()}


def export_checkpoint(ckpt_path: str, cfg, out_path: str) -> str:
    """A checkpoint (the JAX package's format, written by either package)
    -> a reference-format torch file ({'state_dict': {'model.<k>': tensor},
    'epoch': N}). A checkpoint converted from the reference puts its
    torch-only bookkeeping back (extra['torch_passthrough']), so a round
    trip is exact. A fitted scaler goes to `<out_path>.robust.pkl`, a
    pickled sklearn RobustScaler (`data.robust.write_sklearn_scaler`)."""
    from .models.stse import build_model
    from .train import checkpoint
    from .train.loop import model_kwargs_from_config

    model = build_model(**model_kwargs_from_config(cfg))
    payload = checkpoint.read_payload(ckpt_path)
    state = payload["state"]
    extra = payload.get("extra", {})
    buffers = {k: np.asarray(state[k]) for k in ("center", "inv_cov", "mean_vector")
               if k in state}
    sd = export_state_dict(model, state["params"], state.get("batch_stats", {}) or {},
                           buffers, distance=cfg.model.distance)
    for k, v in extra.get("torch_passthrough", {}).items():
        sd[k] = np.asarray(v)
    torch.save({"state_dict": {f"model.{k}": torch.tensor(v) for k, v in sd.items()},
                "epoch": int(extra.get("epoch", -1))}, out_path)
    if "scaler" in payload:
        from .data.robust import write_sklearn_scaler

        write_sklearn_scaler(payload["scaler"]["center"], payload["scaler"]["scale"],
                             out_path + ".robust.pkl")
        print(f"[coskad] fitted scaler -> {out_path}.robust.pkl (place it as the reference "
              "run's exp_dir/robust.pkl)")
    elif cfg.data.normalization_strategy == "robust":
        print("[coskad] WARNING: robust-normalized config but no fitted scaler in the "
              "checkpoint: the reference side will fit its own and scores will NOT match "
              "this run")
    return out_path


def load_sklearn_scaler(path: str):
    """The reference's fitted-RobustScaler pickle as a RobustScalerState,
    read by `data.robust.load_scaler`'s restricted unpickler (sklearn is not
    imported)."""
    from .data.normalize import RobustScalerState
    from .data.robust import load_scaler

    obj = load_scaler(path)
    center, scale = getattr(obj, "center_", None), getattr(obj, "scale_", None)
    if center is None or scale is None:
        raise ConversionError(f"{path} does not hold a fitted sklearn RobustScaler "
                              f"(center_/scale_ missing on {type(obj)})")
    return RobustScalerState(center=np.asarray(center, np.float64),
                             scale=np.asarray(scale, np.float64))
