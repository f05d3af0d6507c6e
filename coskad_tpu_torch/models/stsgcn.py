"""Space-Time-Separable GCN layers (PyTorch).

Counterpart of `coskad_tpu/models/stsgcn.py`. Tensors flow channels-last
[B, T, V, C] through the stack, like the JAX package. Module and parameter
names follow the flax variable tree (`gcn.t_adj`, `tcn_dense.kernel`,
`tcn_bn.scale`, `tcn_bn.mean`, ...) and dense kernels keep flax's
[fan_in, features] layout, so weights carry across by name
(`coskad_tpu_torch/interop.py`).

BatchNorm, as the JAX package runs it:
  * eval mode and `frozen_bn`: running statistics, folded into the dense
    layer exactly as `_moment_dense_bn(use_running=True)` does (`dense_bn`);
    gradients flow through the folded affine;
  * train mode: flax `nn.BatchNorm` over all B*T*V rows per channel, the
    variance E[x^2] - E[x]^2 clamped at 0 (biased), eps 1e-5
    (`batch_norm_train`). The running statistics keep 0.9 of the old
    value. Where flax returns new `batch_stats`, the port updates the
    `mean` / `var` buffers in place, in PyTorch's manner; K1's fold cache
    is keyed on the buffers' versions, so it refolds after an update.
    (`F.batch_norm` would store the unbiased variance and drift from flax.)
Ghost BatchNorm, the fused train path, is `kernels/stse_train.py`. The MLP
projector (`MLPHead`) runs flax BatchNorm on its hidden layers as it is,
unfolded: `batch_norm_eval` from the running statistics, `batch_norm_train`
in train mode.

Compute dtype (`dtype`, the JAX modules' own): parameters stay float32;
with `torch.bfloat16` every cast of the JAX modules is a rounding point
(`rounded`): a tensor is rounded to bf16 where JAX casts it and held in
float32. So each dense or graph product multiplies bf16 values exactly in
float32 and sums in float32 (JAX's bf16 dot with f32 accumulation), and its
bf16 result is rounded once; BatchNorm takes its statistics in float32 and
rounds its output (flax's `BatchNorm(dtype=bfloat16)`); PReLU's slope is a
float32 parameter, so its output is float32, as jnp's type promotion makes
it. Held in float32, the module path is one function on the CPU and the
card (a bf16 `torch.matmul` would accumulate differently on each).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..kernels.stse_fused import combined_graph_matrix

BN_MOMENTUM = 0.9
_DROPOUT = "dropout in train mode is not ported yet (ROADMAP.md, Queue 1 item 3c)"


def rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to `dtype` (round to nearest even) and held in x's own
    dtype: the JAX package's `x.astype(dtype)` as a rounding point. Autograd
    rounds the gradient at the same point, as JAX's cast rounds its
    cotangent. The identity where `dtype` is float32."""
    if dtype == torch.float32:
        return x
    return x.to(dtype).to(x.dtype)


def _uniform_(t: torch.Tensor, bound: float, generator: Optional[torch.Generator]):
    """Fill `t` from U(-bound, bound), drawn on the CPU so that a seeded
    CPU generator gives the same weights on every device."""
    with torch.no_grad():
        t.copy_(torch.empty(t.shape).uniform_(-bound, bound, generator=generator))


class Dense(nn.Module):
    """y = x @ kernel + bias, kernel [fan_in, features] (flax layout).
    Init as torch's nn.Linear: U(+-1/sqrt(fan_in)) for kernel and bias.
    At a bf16 `dtype`, flax's `nn.Dense(dtype=bfloat16)`: the product of the
    rounded x and kernel rounded, then the rounded bias added and rounded."""

    def __init__(self, fan_in: int, features: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(fan_in, features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.dtype = dtype
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        bound = 1.0 / math.sqrt(self.kernel.shape[0])
        _uniform_(self.kernel, bound, generator)
        if self.bias is not None:
            _uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = rounded(rounded(x, dt) @ rounded(self.kernel, dt), dt)
        return y if self.bias is None else rounded(y + rounded(self.bias, dt), dt)


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
    folded into the matmul (`_moment_dense_bn` with use_running=True); at a
    bf16 dtype the folded weight and bias, the product and the sum are
    rounded, as there."""
    dt = dense.dtype
    inv = bn.scale * torch.rsqrt(bn.var + eps)
    bias = 0.0 if dense.bias is None else dense.bias
    w_eff = rounded(dense.kernel * inv[None, :], dt)
    b_eff = rounded((bias - bn.mean) * inv + bn.bias, dt)
    return rounded(rounded(rounded(x, dt) @ w_eff, dt) + b_eff, dt)


def batch_norm_eval(h: torch.Tensor, bn: BatchNorm, eps: float = 1e-5) -> torch.Tensor:
    """flax `nn.BatchNorm(use_running_average=True)` over h [..., C]:
    (h - mean) * (rsqrt(var + eps) * scale) + bias from the running
    statistics."""
    return (h - bn.mean) * (torch.rsqrt(bn.var + eps) * bn.scale) + bn.bias


def batch_norm_train(h: torch.Tensor, bn: BatchNorm, momentum: float = BN_MOMENTUM,
                     eps: float = 1e-5, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """flax `nn.BatchNorm(use_running_average=False, dtype=dtype)` over
    every row of h [..., C]: y = (h - mean) * (rsqrt(var + eps) * scale) +
    bias with the biased variance, the statistics and y in float32, y then
    rounded to `dtype`. Updates bn's running statistics in place."""
    rows = h.reshape(-1, h.shape[-1])
    mean = rows.mean(dim=0)
    var = torch.clamp((rows * rows).mean(dim=0) - mean * mean, min=0.0)
    with torch.no_grad():
        bn.mean.mul_(momentum).add_((1.0 - momentum) * mean)
        bn.var.mul_(momentum).add_((1.0 - momentum) * var)
    return rounded((h - mean) * (torch.rsqrt(var + eps) * bn.scale) + bn.bias, dtype)


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
    axis. [B, T, V, C] -> [B, T, V, C]. At a bf16 dtype x and M are rounded,
    summed in float32 and the result rounded."""

    def __init__(self, time_dim: int, joints_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.t_adj = nn.Parameter(torch.empty(joints_dim, time_dim, time_dim))
        self.a_adj = nn.Parameter(torch.empty(time_dim, joints_dim, joints_dim))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        v, t, _ = self.t_adj.shape
        _uniform_(self.t_adj, 1.0 / math.sqrt(t), generator)
        _uniform_(self.a_adj, 1.0 / math.sqrt(v), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, v, c = x.shape
        dt = self.dtype
        m = rounded(combined_graph_matrix(self.t_adj, self.a_adj), dt)
        h = torch.einsum("bnc,nm->bmc", rounded(x, dt).reshape(b, t * v, c), m)
        return rounded(h, dt).reshape(b, t, v, c)


class STSGCNLayer(nn.Module):
    """Graph conv -> 1x1 dense + BN, residual (dense + BN when the channel
    count changes, identity otherwise), PReLU. [B, T, V, C_in] ->
    [B, T, V, C_out]. Dropout is the identity in eval mode. At a bf16 dtype
    the input, each branch and their sum are rounded (the PReLU's output is
    float32, its slope a float32 parameter)."""

    def __init__(self, in_channels: int, out_channels: int, time_dim: int,
                 joints_dim: int, use_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.gcn = SpaceTimeGraphConv(time_dim, joints_dim, dtype)
        self.tcn_dense = Dense(in_channels, out_channels, use_bias, dtype)
        self.tcn_bn = BatchNorm(out_channels)
        if in_channels != out_channels:
            self.residual_dense = Dense(in_channels, out_channels, use_bias, dtype)
            self.residual_bn = BatchNorm(out_channels)
        else:
            self.residual_dense = self.residual_bn = None
        self.prelu = PReLU()

    def forward(self, x: torch.Tensor, train: bool = False,
                frozen_bn: bool = False) -> torch.Tensor:
        """train: live BatchNorm statistics (running ones updated in place);
        frozen_bn: running statistics while training."""
        live = train and not frozen_bn
        dt = self.dtype

        def bn(h, dense, norm):
            return (batch_norm_train(dense(h), norm, dtype=dt) if live
                    else dense_bn(h, dense, norm))

        x = rounded(x, dt)
        res = x if self.residual_dense is None else bn(x, self.residual_dense, self.residual_bn)
        h = bn(self.gcn(x), self.tcn_dense, self.tcn_bn)
        return self.prelu(rounded(h + res, dt))


class STSGCNStack(nn.Module):
    """Sequential ST-GCNN layers `layer_0`, `layer_1`, ... over a channel
    schedule (encoder: layer_channels + [hidden_dim])."""

    def __init__(self, in_channels: int, channel_schedule: Sequence[int],
                 time_dim: int, joints_dim: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_layers = len(channel_schedule)
        c = in_channels
        for i, ch in enumerate(channel_schedule):
            self.add_module(f"layer_{i}", STSGCNLayer(c, ch, time_dim, joints_dim, use_bias,
                                                      dtype))
            c = ch

    def forward(self, x: torch.Tensor, train: bool = False,
                frozen_bn: bool = False) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x, train=train, frozen_bn=frozen_bn)
        return x


class MLPHead(nn.Module):
    """The MLP projector: per hidden layer `hidden_{i}` (Dense) -> `bn_{i}`
    (BatchNorm over the whole batch, not ghost blocks) -> ReLU, then the
    Dense `out`. [B, fan_in] -> [B, output_size]. In train mode BatchNorm
    uses the batch's statistics and updates its running ones in place with
    flax's semantics (`batch_norm_train`); in eval mode the running ones."""

    def __init__(self, fan_in: int, hidden_layers: Sequence[int], output_size: int,
                 use_bias: bool = True):
        super().__init__()
        self.n_hidden = len(hidden_layers)
        for i, h in enumerate(hidden_layers):
            self.add_module(f"hidden_{i}", Dense(fan_in, h, use_bias))
            self.add_module(f"bn_{i}", BatchNorm(h))
            fan_in = h
        self.out = Dense(fan_in, output_size, use_bias)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i in range(self.n_hidden):
            h = getattr(self, f"hidden_{i}")(x)
            bn = getattr(self, f"bn_{i}")
            x = torch.relu(batch_norm_train(h, bn) if train else batch_norm_eval(h, bn))
        return self.out(x)
