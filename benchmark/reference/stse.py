"""Plain PyTorch reference of the STSE one-class model, as the benchmark judges it.

Written from the model's equations, not from the program: it imports
neither the port nor the JAX package, and takes nothing the program has
made. The benchmark makes the windows, the weights and the center from the
seed and hands the same to the program and to this file.

What it computes, in the dtype of the tensors it is given (float32, with
TF32 off, or float64):

* the batch: window i % N of the resident set under affine transform
  i // N (the reference's 5-transform table), x and y transformed, the
  confidence channel dropped;
* the encoder: per layer the space-time graph contraction through one
  [T*V, T*V] matrix M[(t, v), (q, w)] = T[v, t, q] A[q, v, w], the 1x1
  dense, BatchNorm, a residual dense with its own BatchNorm, their sum
  and a PReLU; BatchNorm from running statistics in eval, over ghost
  blocks of consecutive windows (`bn="ghost"`) or the whole batch
  (`bn="live"`) in training, biased variance, eps 1e-5;
* the projector: linear over the hidden state flattened in (T, V, C)
  order, or an MLP (dense, whole-batch BatchNorm, ReLU, dense);
* the loss mean((z - c)^2) + alpha * mean over the non-bias parameters of
  0.5 ||W||^2, and Adam (eps outside the square root);
* the score mean((z - c)^2) of each window, and the center, the float64
  mean of the latents clamped away from 0 by the tolerance.

`precision` picks how every product's operands are held, to build the
control: "exact" (as given), "tf32" (operands rounded to TF32's 10-bit
mantissa), "bf16" (rounded to bfloat16: a witness of what a bf16 config's
rounding does, never a control) or "fp8" (operands scaled per tensor and
rounded to float8 e4m3); the cotangents of the backward products are rounded alike, and the
products then summed in the given dtype.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

BN_EPS = 1e-5
ADAM = dict(beta1=0.9, beta2=0.999, eps=1e-8)
PRECISIONS = ("exact", "tf32", "bf16", "fp8")


# ---------------------------------------------------------------- transforms

def _affine(rot_deg: float = 0.0, flip: bool = False) -> np.ndarray:
    c, s = math.cos(math.radians(rot_deg)), math.sin(math.radians(rot_deg))
    flip_m = np.eye(3)
    if flip:
        flip_m[0, 0] = -1.0
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return (flip_m @ rot).astype(np.float32)


def transform_table(k: int) -> np.ndarray:
    """The first k of identity, flip, rot90, rot90 + flip, rot45: [k, 3, 3]."""
    table = np.stack([_affine(), _affine(flip=True), _affine(90), _affine(90, True),
                      _affine(45)])
    return table[:k]


def gather(data: torch.Tensor, indices: torch.Tensor, table: torch.Tensor,
           num_coords: int = 2) -> torch.Tensor:
    """Windows [N, C, T, V] and logical indices [B] -> the batch [B, 2, T, V]."""
    n = data.shape[0]
    x = data[indices % n]
    m = table[indices // n]
    xs, ys = x[:, 0], x[:, 1]
    out = [m[:, r, 0, None, None] * xs + m[:, r, 1, None, None] * ys + m[:, r, 2, None, None]
           for r in range(2)]
    return torch.stack(out, dim=1)[:, :num_coords]


# ---------------------------------------------------------------- precision

def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32).to(x.dtype)


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-30) / 448.0
    return (x / scale).float().to(torch.float8_e4m3fn).to(x.dtype) * scale


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


_ROUND = {"tf32": _round_tf32, "bf16": _round_bf16, "fp8": _round_fp8}


class _LowProduct(torch.autograd.Function):
    """einsum with every operand rounded, both ways."""

    @staticmethod
    def forward(ctx, a, b, eq, precision):
        ctx.save_for_backward(a, b)
        ctx.eq, ctx.precision = eq, precision
        q = _ROUND[precision]
        return torch.einsum(eq, q(a), q(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        q = _ROUND[ctx.precision]
        with torch.enable_grad():
            a_, b_ = q(a.detach()).requires_grad_(), q(b.detach()).requires_grad_()
            out = torch.einsum(ctx.eq, a_, b_)
            ga, gb = torch.autograd.grad(out, (a_, b_), q(g.contiguous()))
        return ga, gb, None, None


def product(eq: str, a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "exact":
        return torch.einsum(eq, a, b)
    return _LowProduct.apply(a, b, eq, precision)


# ---------------------------------------------------------------- parameters

def arch_of(cfg: dict) -> dict:
    """The shapes the reference needs, from a benchmark config file's
    `reference` keys."""
    r = cfg["reference"]
    joints = 18 if r.get("dataset_kp18_format", True) else 17
    return dict(in_dim=r.get("num_coords", 2), channels=list(r["channels"]), hidden=r["h_dim"],
                latent=r["latent_dim"], frames=r["dataset_seg_len"], joints=joints,
                projector=r.get("projector", "linear").lower())


def param_spec(arch: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every parameter and BatchNorm statistic, under
    the flax variable paths joined by '.'. Kinds: kernel, t_adj, a_adj,
    bias, scale, shift, mean, var, alpha."""
    t, v = arch["frames"], arch["joints"]
    spec = []
    c = arch["in_dim"]
    for i, co in enumerate(arch["channels"] + [arch["hidden"]]):
        p = f"encoder.layer_{i}"
        spec += [(f"{p}.gcn.t_adj", (v, t, t), "t_adj"), (f"{p}.gcn.a_adj", (t, v, v), "a_adj")]
        branches = ["tcn"] + (["residual"] if c != co else [])
        for br in branches:
            spec += [(f"{p}.{br}_dense.kernel", (c, co), "kernel"),
                     (f"{p}.{br}_dense.bias", (co,), "bias"),
                     (f"{p}.{br}_bn.scale", (co,), "scale"), (f"{p}.{br}_bn.bias", (co,), "shift"),
                     (f"{p}.{br}_bn.mean", (co,), "mean"), (f"{p}.{br}_bn.var", (co,), "var")]
        spec.append((f"{p}.prelu.alpha", (), "alpha"))
        c = co
    flat = t * v * arch["hidden"]
    if arch["projector"] == "linear":
        spec += [("btlnk.kernel", (flat, arch["latent"]), "kernel"),
                 ("btlnk.bias", (arch["latent"],), "bias")]
    else:
        h = arch["latent"]
        spec += [("btlnk.hidden_0.kernel", (flat, h), "kernel"),
                 ("btlnk.hidden_0.bias", (h,), "bias"),
                 ("btlnk.bn_0.scale", (h,), "scale"), ("btlnk.bn_0.bias", (h,), "shift"),
                 ("btlnk.bn_0.mean", (h,), "mean"), ("btlnk.bn_0.var", (h,), "var"),
                 ("btlnk.out.kernel", (h, arch["latent"]), "kernel"),
                 ("btlnk.out.bias", (arch["latent"],), "bias")]
    return spec


def is_statistic(name: str) -> bool:
    return name.endswith((".mean", ".var"))


def make_params(arch: dict, generator: torch.Generator, device, trained: bool
                ) -> Dict[str, torch.Tensor]:
    """Every parameter and statistic from one uniform draw on `device`.
    Dense kernels and biases, and the graph factors, U(+-1/sqrt(fan_in)) as
    torch's and flax's defaults; BatchNorm and PReLU at their initial
    values, or (`trained`) spread as a trained model's are: scale in [0.5,
    1.5], shift and mean in [-0.2, 0.2], var in [0.5, 2], slope in [0.1,
    0.4]."""
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


# ---------------------------------------------------------------- the model

def graph_matrix(t_adj: torch.Tensor, a_adj: torch.Tensor) -> torch.Tensor:
    v, t, _ = t_adj.shape
    return torch.einsum("vtq,qvw->tvqw", t_adj, a_adj).reshape(t * v, t * v)


def _bn_batch(h: torch.Tensor, scale, shift) -> torch.Tensor:
    """BatchNorm over every row of h [rows, C] with its biased statistics."""
    mean = h.mean(dim=0)
    var = torch.clamp((h * h).mean(dim=0) - mean * mean, min=0.0)
    return (h - mean) * torch.rsqrt(var + BN_EPS) * scale + shift


def _bn(h: torch.Tensor, p: dict, name: str, mode: str, ghost: int) -> torch.Tensor:
    """h [B, N, C]; mode "eval" (running statistics), "live" (whole batch)
    or "ghost" (blocks of `ghost` consecutive windows)."""
    scale, shift = p[f"{name}.scale"], p[f"{name}.bias"]
    if mode == "eval":
        return (h - p[f"{name}.mean"]) * torch.rsqrt(p[f"{name}.var"] + BN_EPS) * scale + shift
    b, n, c = h.shape
    if mode == "live":
        return _bn_batch(h.reshape(b * n, c), scale, shift).reshape(b, n, c)
    blocks = h.reshape(b // ghost, ghost * n, c)
    mean = blocks.mean(dim=1, keepdim=True)
    var = torch.clamp((blocks * blocks).mean(dim=1, keepdim=True) - mean * mean, min=0.0)
    return ((blocks - mean) * torch.rsqrt(var + BN_EPS) * scale + shift).reshape(b, n, c)


def encode(p: dict, arch: dict, x: torch.Tensor, mode: str, ghost: int = 0,
           precision: str = "exact") -> torch.Tensor:
    """Windows [B, C, T, V] -> latents [B, latent]."""
    b, c, t, v = x.shape
    h = x.permute(0, 2, 3, 1).reshape(b, t * v, c)
    for i in range(len(arch["channels"]) + 1):
        pre = f"encoder.layer_{i}"
        m = graph_matrix(p[f"{pre}.gcn.t_adj"], p[f"{pre}.gcn.a_adj"])
        g = product("bnc,nm->bmc", h, m, precision)
        out = _bn(product("bnc,co->bno", g, p[f"{pre}.tcn_dense.kernel"], precision)
                  + p[f"{pre}.tcn_dense.bias"], p, f"{pre}.tcn_bn", mode, ghost)
        if f"{pre}.residual_dense.kernel" in p:
            res = _bn(product("bnc,co->bno", h, p[f"{pre}.residual_dense.kernel"], precision)
                      + p[f"{pre}.residual_dense.bias"], p, f"{pre}.residual_bn", mode, ghost)
        else:
            res = h
        y = out + res
        h = torch.where(y >= 0, y, p[f"{pre}.prelu.alpha"] * y)
    flat = h.reshape(b, -1)
    if arch["projector"] == "linear":
        return product("bk,kl->bl", flat, p["btlnk.kernel"], precision) + p["btlnk.bias"]
    hid = product("bk,kl->bl", flat, p["btlnk.hidden_0.kernel"], precision) + p[
        "btlnk.hidden_0.bias"]
    if mode == "eval":
        hid = (hid - p["btlnk.bn_0.mean"]) * torch.rsqrt(p["btlnk.bn_0.var"] + BN_EPS) * p[
            "btlnk.bn_0.scale"] + p["btlnk.bn_0.bias"]
    else:
        hid = _bn_batch(hid, p["btlnk.bn_0.scale"], p["btlnk.bn_0.bias"])
    return product("bk,kl->bl", torch.relu(hid), p["btlnk.out.kernel"], precision) + p[
        "btlnk.out.bias"]


def regularizer(p: dict) -> torch.Tensor:
    """Mean over the non-bias parameters (statistics are not parameters) of
    0.5 ||W||^2."""
    vals = [0.5 * torch.sum(t * t) for k, t in p.items()
            if not is_statistic(k) and k.rsplit(".", 1)[-1] != "bias"]
    return sum(vals) / len(vals)


def scores(z: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    return torch.mean((z - center) ** 2, dim=-1)


def clamp_center(c: torch.Tensor, tol: float) -> torch.Tensor:
    small = torch.abs(c) < tol
    c = torch.where(small & (c < 0), torch.full_like(c, -tol), c)
    return torch.where(small & (c > 0), torch.full_like(c, tol), c)


@torch.no_grad()
def eval_scores(p: dict, arch: dict, data: torch.Tensor, indices: torch.Tensor,
                table: torch.Tensor, center: torch.Tensor, block: int = 4096,
                precision: str = "exact") -> torch.Tensor:
    """The score of every logical index, in blocks of `block` rows."""
    out = [scores(encode(p, arch, gather(data, indices[i:i + block], table, arch["in_dim"]),
                         "eval", precision=precision), center)
           for i in range(0, len(indices), block)]
    return torch.cat(out)


@torch.no_grad()
def center_of(p: dict, arch: dict, data: torch.Tensor, n_items: int, table: torch.Tensor,
              tol: float, block: int = 4096, precision: str = "exact") -> torch.Tensor:
    """clamp(float64 mean of the eval latents of every logical item)."""
    total = torch.zeros(arch["latent"], dtype=torch.float64, device=data.device)
    for i in range(0, n_items, block):
        idx = torch.arange(i, min(i + block, n_items), device=data.device)
        z = encode(p, arch, gather(data, idx, table, arch["in_dim"]), "eval",
                   precision=precision)
        total += z.double().sum(dim=0)
    return clamp_center((total / n_items).to(data.dtype), tol)


def train_steps(p0: dict, arch: dict, data: torch.Tensor, table: torch.Tensor,
                batches: Sequence[torch.Tensor], center: torch.Tensor, lr: float,
                alpha: float, bn: str, ghost: int = 0, precision: str = "exact"
                ) -> dict:
    """Adam steps from p0 over the index batches: each step's loss, the
    first step's gradients, the parameters after the last step and each
    step's latents' sum and count (the dynamic center's accumulators)."""
    params = {k: v.clone().requires_grad_(not is_statistic(k)) for k, v in p0.items()}
    names = [k for k in params if not is_statistic(k)]
    m = {k: torch.zeros_like(params[k]) for k in names}
    v = {k: torch.zeros_like(params[k]) for k in names}
    losses, grad1 = [], None
    z_sum = torch.zeros(arch["latent"], dtype=data.dtype, device=data.device)
    count = 0
    for step, idx in enumerate(batches, start=1):
        x = gather(data, idx, table, arch["in_dim"])
        z = encode(params, arch, x, bn, ghost, precision)
        loss = torch.mean((z - center) ** 2) + alpha * regularizer(params)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        losses.append(float(loss.detach()))
        z_sum += z.detach().sum(dim=0)
        count += z.shape[0]
        if grad1 is None:
            grad1 = {k: g.detach().clone() for k, g in zip(names, grads)}
        b1, b2, eps = ADAM["beta1"], ADAM["beta2"], ADAM["eps"]
        with torch.no_grad():
            for k, g in zip(names, grads):
                m[k].mul_(b1).add_((1 - b1) * g)
                v[k].mul_(b2).add_((1 - b2) * g * g)
                m_hat = m[k] / (1 - b1 ** step)
                v_hat = v[k] / (1 - b2 ** step)
                params[k] -= lr * m_hat / (torch.sqrt(v_hat) + eps)
    final = {k: params[k].detach() for k in names}
    return dict(losses=losses, grad1=grad1, params=final, z_sum=z_sum, count=count)


def center_update(z_sum: torch.Tensor, count: int, tol: float) -> torch.Tensor:
    """euclidean_dynamic's epoch-end center from the epoch's latent sum."""
    return clamp_center(z_sum / count, tol)

