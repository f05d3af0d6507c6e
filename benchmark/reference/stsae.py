"""Plain PyTorch reference of the STSAE (COSKAD's Euclidean autoencoder) in eval.

Written from the model's equations, not from the program: it imports
neither the port nor the JAX package, and takes nothing the program has
made. It reuses the helpers of `stse.py` (the batch's gather, the graph
matrix, the score, the roundings) and adds the autoencoder:

* the parameters: the STSE's (`stse.param_spec`) and the reverse projector
  `rev_btlnk.kernel` [L, H*T*V], `rev_btlnk.bias` [H*T*V] (the flat hidden
  in channel-major (H, T, V) order), then the decoder's layers
  `decoder.layer_i.*`, the encoder's layer over the channels H, the
  encoder's channels reversed, then C_in (the port's `state_dict` names);
* the eval forward: the encoder, each layer a graph contraction through one
  [T*V, T*V] matrix, a dense with BatchNorm from running statistics, a
  residual dense with its own BatchNorm where the channels change, their
  sum and a PReLU; the projector to the latent z (linear, or the MLP: a
  dense, BatchNorm, ReLU, a dense); z times the reverse projector's kernel
  plus its bias, read as [B, H, T, V]; the decoder's layers, each the
  encoder's; the reconstruction [B, C_in, T, V];
* each window's score, mean((z - c)^2), and its reconstruction error, the
  mean over (C, T, V) of the squared gap between the reconstruction and the
  batch the model was given.

Everything is computed in the dtype of the tensors given (float32, with
TF32 off, or float64). `precision` is the format the compute dtype's casts
round to. A model whose compute dtype is bf16 casts where the JAX
package's modules cast (the casts its bf16 configuration defines, which the
port keeps): each STS-GCN layer's input, its graph matrix and the graph
product, each dense's folded weight, folded bias, product and sum
(BatchNorm from running statistics folded into the dense, w = kernel *
scale / sqrt(var + eps), b = (bias - mean) * scale / sqrt(var + eps) +
shift), the branches' sum before the PReLU (whose float32 slope leaves its
output uncast); the linear projector's operands, product, bias and sum
(the MLP projector computes in float32); the reverse projector's latent,
kernel, product, bias and sum. "exact" casts nowhere: the model's
equations in the given dtype. "bf16" is the shipped configuration's
computation; "fp8" (float8 e4m3, each cast scaled by its tensor's largest
magnitude) the same computation one precision down, the control.

Departures from the paper's description (Flaborea et al., Pattern
Recognition 156, 2024, and its code, `models/sts/ae.py`):
* the windows are synthetic, from the seed, and the weights are drawn with
  a trained model's spread (`make_params`), not trained;
* the projector is the MLP head this repository builds for `projector:
  mlp` (one hidden layer of the latent's width, BatchNorm, ReLU, a dense
  to the latent); the paper's code builds its MLP from a size it never
  sets;
* eval's BatchNorm is folded into its dense, as the JAX package folds it;
  the paper's code applies it after the dense, the same function;
* the paper combines the two scores (`--rec-weight`) after the window
  scores are aggregated to frames; this file stops at the window: the
  benchmark compares each of the two numbers by itself.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from benchmark.reference import stse

PRECISIONS = ("exact", "bf16", "fp8")


def caster(precision: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The compute dtype's cast at `precision`: a rounding, held in the
    tensor's own dtype."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} is none of {PRECISIONS}")
    return (lambda t: t) if precision == "exact" else stse._ROUND[precision]


def decoder_layers(arch: dict) -> List[Tuple[int, int]]:
    """(C_in, C_out) of each decoder layer: from the hidden width through the
    encoder's channels reversed to the input's."""
    chans = [arch["hidden"]] + list(arch["channels"])[::-1] + [arch["in_dim"]]
    return list(zip(chans[:-1], chans[1:]))


def param_spec(arch: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every parameter and BatchNorm statistic: the
    STSE's, the reverse projector's, then the decoder's (kinds as
    `stse.param_spec`)."""
    t, v = arch["frames"], arch["joints"]
    flat = arch["hidden"] * t * v
    spec = stse.param_spec(arch)
    spec += [("rev_btlnk.kernel", (arch["latent"], flat), "kernel"),
             ("rev_btlnk.bias", (flat,), "bias")]
    for i, (ci, co) in enumerate(decoder_layers(arch)):
        p = f"decoder.layer_{i}"
        spec += [(f"{p}.gcn.t_adj", (v, t, t), "t_adj"), (f"{p}.gcn.a_adj", (t, v, v), "a_adj")]
        for br in ["tcn"] + (["residual"] if ci != co else []):
            spec += [(f"{p}.{br}_dense.kernel", (ci, co), "kernel"),
                     (f"{p}.{br}_dense.bias", (co,), "bias"),
                     (f"{p}.{br}_bn.scale", (co,), "scale"), (f"{p}.{br}_bn.bias", (co,), "shift"),
                     (f"{p}.{br}_bn.mean", (co,), "mean"), (f"{p}.{br}_bn.var", (co,), "var")]
        spec.append((f"{p}.prelu.alpha", (), "alpha"))
    return spec


def make_params(arch: dict, generator: torch.Generator, device, trained: bool
                ) -> Dict[str, torch.Tensor]:
    """Every parameter and statistic from one uniform draw on `device`, each
    kind as `stse.make_params` draws it: dense kernels and biases
    U(+-1/sqrt(fan_in)) (the reverse projector's fan-in is the latent),
    the graph factors U(+-1/sqrt(their second axis)), BatchNorm and PReLU at
    their initial values or (`trained`) with a trained model's spread."""
    spec = param_spec(arch)
    shapes = {name: shape for name, shape, _ in spec}
    sizes = [int(np.prod(s)) if s else 1 for _, s, _ in spec]
    draw = torch.rand(sum(sizes), generator=generator, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for (name, shape, kind), n in zip(spec, sizes):
        u = draw[at:at + n].reshape(shape)
        at += n
        if kind == "kernel":
            val = u / math.sqrt(shape[0])
        elif kind == "bias":
            val = u / math.sqrt(shapes[name[:-len("bias")] + "kernel"][0])
        elif kind in ("t_adj", "a_adj"):
            val = u / math.sqrt(shape[1])
        elif kind == "scale":
            val = 1.0 + 0.5 * u if trained else torch.ones_like(u)
        elif kind in ("shift", "mean"):
            val = 0.2 * u if trained else torch.zeros_like(u)
        elif kind == "var":
            val = 1.25 + 0.75 * u if trained else torch.ones_like(u)
        else:  # alpha
            val = 0.25 + 0.15 * u if trained else torch.full_like(u, 0.25)
        out[name] = val.contiguous()
    return out


def _dense_bn(p: dict, pre: str, branch: str, x: torch.Tensor, cast) -> torch.Tensor:
    """BatchNorm(x @ kernel + bias) of one branch, the statistics folded
    into the dense; x [B, N, C_in] cast."""
    inv = p[f"{pre}.{branch}_bn.scale"] * torch.rsqrt(p[f"{pre}.{branch}_bn.var"] + stse.BN_EPS)
    w = cast(p[f"{pre}.{branch}_dense.kernel"] * inv)
    b = cast((p[f"{pre}.{branch}_dense.bias"] - p[f"{pre}.{branch}_bn.mean"]) * inv
             + p[f"{pre}.{branch}_bn.bias"])
    return cast(cast(torch.einsum("bnc,co->bno", x, w)) + b)


def _layer(p: dict, pre: str, h: torch.Tensor, cast) -> torch.Tensor:
    """One STS-GCN layer in eval, h [B, N, C_in] -> [B, N, C_out]."""
    x = cast(h)
    m = cast(stse.graph_matrix(p[f"{pre}.gcn.t_adj"], p[f"{pre}.gcn.a_adj"]))
    g = cast(torch.einsum("bnc,nm->bmc", x, m))
    out = _dense_bn(p, pre, "tcn", g, cast)
    res = _dense_bn(p, pre, "residual", x, cast) if f"{pre}.residual_dense.kernel" in p else x
    y = cast(out + res)
    return torch.where(y >= 0, y, p[f"{pre}.prelu.alpha"] * y)


def _stack(p: dict, prefix: str, h: torch.Tensor, cast) -> torch.Tensor:
    i = 0
    while f"{prefix}.layer_{i}.gcn.t_adj" in p:
        h = _layer(p, f"{prefix}.layer_{i}", h, cast)
        i += 1
    return h


def encode(p: dict, arch: dict, x: torch.Tensor, precision: str = "exact") -> torch.Tensor:
    """Windows [B, C, T, V] -> latents [B, L]."""
    cast = caster(precision)
    b, c, t, v = x.shape
    flat = _stack(p, "encoder", x.permute(0, 2, 3, 1).reshape(b, t * v, c), cast).reshape(b, -1)
    if arch["projector"] == "linear":
        return cast(cast(cast(flat) @ cast(p["btlnk.kernel"])) + cast(p["btlnk.bias"]))
    hid = flat @ p["btlnk.hidden_0.kernel"] + p["btlnk.hidden_0.bias"]
    hid = (hid - p["btlnk.bn_0.mean"]) * torch.rsqrt(p["btlnk.bn_0.var"] + stse.BN_EPS) * p[
        "btlnk.bn_0.scale"] + p["btlnk.bn_0.bias"]
    return torch.relu(hid) @ p["btlnk.out.kernel"] + p["btlnk.out.bias"]


def decode(p: dict, arch: dict, z: torch.Tensor, precision: str = "exact") -> torch.Tensor:
    """Latents [B, L] -> reconstructions [B, C_in, T, V]."""
    cast = caster(precision)
    b, t, v, hid = z.shape[0], arch["frames"], arch["joints"], arch["hidden"]
    flat = cast(cast(cast(z) @ cast(p["rev_btlnk.kernel"])) + cast(p["rev_btlnk.bias"]))
    h = flat.reshape(b, hid, t * v).transpose(1, 2)  # channel-major -> [B, N, H]
    return _stack(p, "decoder", h, cast).reshape(b, t, v, -1).permute(0, 3, 1, 2)


@torch.no_grad()
def eval_outputs(p: dict, arch: dict, data: torch.Tensor, indices: torch.Tensor,
                 table: torch.Tensor, center: torch.Tensor, block: int = 4096,
                 precision: str = "exact", decoder_precision: str = ""
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(score, reconstruction error) of every logical index, in blocks of
    `block` rows; the decoder at `decoder_precision` where one is given (a
    decoder computed below the encoder's precision)."""
    scores, errors = [], []
    for i in range(0, len(indices), block):
        x = stse.gather(data, indices[i:i + block], table, arch["in_dim"])
        z = encode(p, arch, x, precision)
        scores.append(stse.scores(z, center))
        rec = decode(p, arch, z, decoder_precision or precision)
        errors.append(torch.mean((rec - x) ** 2, dim=(1, 2, 3)))
    return torch.cat(scores), torch.cat(errors)
