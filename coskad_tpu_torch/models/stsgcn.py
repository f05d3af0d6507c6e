"""Space-Time-Separable GCN layers (PyTorch), eval mode.

Counterpart of `coskad_tpu/models/stsgcn.py`. Tensors flow channels-last
[B, T, V, C] through the stack, like the JAX package. Module and parameter
names follow the flax variable tree (`gcn.t_adj`, `tcn_dense.kernel`,
`tcn_bn.scale`, `tcn_bn.mean`, ...) and dense kernels keep flax's
[fan_in, features] layout, so weights carry across by name
(`coskad_tpu_torch/interop.py`).

Only eval mode is here: BatchNorm uses its running statistics, folded into
the dense layer exactly as `_moment_dense_bn(use_running=True)` does. Train
mode (live and ghost BatchNorm) belongs to the training slice.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..kernels.stse_fused import combined_graph_matrix

_TRAIN_MODE = (
    "train mode is not ported yet: it comes with the training slice "
    "(ROADMAP.md, Queue 1 item 2)"
)


def _uniform_(t: torch.Tensor, bound: float, generator: Optional[torch.Generator]):
    """Fill `t` from U(-bound, bound), drawn on the CPU so that a seeded
    CPU generator gives the same weights on every device."""
    with torch.no_grad():
        t.copy_(torch.empty(t.shape).uniform_(-bound, bound, generator=generator))


class Dense(nn.Module):
    """y = x @ kernel + bias, kernel [fan_in, features] (flax layout).
    Init as torch's nn.Linear: U(+-1/sqrt(fan_in)) for kernel and bias."""

    def __init__(self, fan_in: int, features: int, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(fan_in, features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        bound = 1.0 / math.sqrt(self.kernel.shape[0])
        _uniform_(self.kernel, bound, generator)
        if self.bias is not None:
            _uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel
        return y if self.bias is None else y + self.bias


class BatchNorm(nn.Module):
    """BatchNorm's affine (`scale`, `bias`) and running statistics (`mean`,
    `var`, buffers) under flax's names. Applied through `dense_bn`."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)


def dense_bn(x: torch.Tensor, dense: Dense, bn: BatchNorm, eps: float = 1e-5) -> torch.Tensor:
    """BN(x @ kernel + bias) from running statistics, with the BN affine
    folded into the matmul (`_moment_dense_bn` with use_running=True)."""
    inv = bn.scale * torch.rsqrt(bn.var + eps)
    bias = 0.0 if dense.bias is None else dense.bias
    w_eff = dense.kernel * inv[None, :]
    b_eff = (bias - bn.mean) * inv + bn.bias
    return x @ w_eff + b_eff


class PReLU(nn.Module):
    """Parametric ReLU with one shared slope: x >= 0 ? x : alpha * x."""

    def __init__(self, init_alpha: float = 0.25):
        super().__init__()
        self.init_alpha = init_alpha
        self.alpha = nn.Parameter(torch.tensor(init_alpha))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.alpha.fill_(self.init_alpha)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha * x)


class SpaceTimeGraphConv(nn.Module):
    """The separable graph contraction in 'combined' mode: one [T*V, T*V]
    matrix M[(t, v), (q, w)] = T[v, t, q] * A[q, v, w] applied over the node
    axis. [B, T, V, C] -> [B, T, V, C]."""

    def __init__(self, time_dim: int, joints_dim: int):
        super().__init__()
        self.t_adj = nn.Parameter(torch.empty(joints_dim, time_dim, time_dim))
        self.a_adj = nn.Parameter(torch.empty(time_dim, joints_dim, joints_dim))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        v, t, _ = self.t_adj.shape
        _uniform_(self.t_adj, 1.0 / math.sqrt(t), generator)
        _uniform_(self.a_adj, 1.0 / math.sqrt(v), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, v, c = x.shape
        m = combined_graph_matrix(self.t_adj, self.a_adj)
        h = torch.einsum("bnc,nm->bmc", x.reshape(b, t * v, c), m)
        return h.reshape(b, t, v, c)


class STSGCNLayer(nn.Module):
    """Graph conv -> 1x1 dense + BN, residual (dense + BN when the channel
    count changes, identity otherwise), PReLU. [B, T, V, C_in] ->
    [B, T, V, C_out]. Dropout is the identity in eval mode."""

    def __init__(self, in_channels: int, out_channels: int, time_dim: int,
                 joints_dim: int, use_bias: bool = True):
        super().__init__()
        self.gcn = SpaceTimeGraphConv(time_dim, joints_dim)
        self.tcn_dense = Dense(in_channels, out_channels, use_bias)
        self.tcn_bn = BatchNorm(out_channels)
        if in_channels != out_channels:
            self.residual_dense = Dense(in_channels, out_channels, use_bias)
            self.residual_bn = BatchNorm(out_channels)
        else:
            self.residual_dense = self.residual_bn = None
        self.prelu = PReLU()

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            raise NotImplementedError(_TRAIN_MODE)
        res = x if self.residual_dense is None else dense_bn(
            x, self.residual_dense, self.residual_bn)
        h = dense_bn(self.gcn(x), self.tcn_dense, self.tcn_bn)
        return self.prelu(h + res)


class STSGCNStack(nn.Module):
    """Sequential ST-GCNN layers `layer_0`, `layer_1`, ... over a channel
    schedule (encoder: layer_channels + [hidden_dim])."""

    def __init__(self, in_channels: int, channel_schedule: Sequence[int],
                 time_dim: int, joints_dim: int, use_bias: bool = True):
        super().__init__()
        self.n_layers = len(channel_schedule)
        c = in_channels
        for i, ch in enumerate(channel_schedule):
            self.add_module(f"layer_{i}", STSGCNLayer(c, ch, time_dim, joints_dim, use_bias))
            c = ch

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x, train=train)
        return x
