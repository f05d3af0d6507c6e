"""The other encoder backbones and the encoder registry (PyTorch).

Counterpart of `coskad_tpu/models/encoders.py`: besides the `sts_gcn`
stack (`stsgcn.py`), the fixed-skeleton ST-GCN (`st_gcn`), the plain GCNs
over the flattened T*V nodes with a learnable (`learnable_gcn`) or a fixed
space-time (`static_gcn`) adjacency, and the plain dense + BatchNorm stack
(`cnn`). Every encoder maps channels-last [B, T, V, C] to [B, T, V, H].

Names follow the flax variable tree, so weights carry across by name
(`interop.py`, the checkpoint codec): `encoder.edge_importance_{i}`,
`encoder.data_bn.*`, `encoder.layer_{i}.{gcn_dense, residual_dense,
residual_bn, bn1, tconv, bn2}.*` (st_gcn), `encoder.adj_{i}` and
`encoder.layer_{i}.{weight, bias}` (the plain GCNs), `encoder.dense_{i}` and
`encoder.bn_{i}` (cnn). The temporal convolution keeps flax's kernel layout
[9, 1, C_in, C_out]. The fixed adjacencies are constants of the module
(buffers outside the state dict), as they are outside JAX's tree.

As in JAX, `make_encoder` gives the compute dtype to the `sts_gcn` stack
only: the other encoders compute in float32 under a bf16 config. Their
BatchNorm is flax's `nn.BatchNorm`, unfolded: the batch's statistics in
train mode (running ones updated in place), the running ones in eval mode
and under `frozen_bn`. Dropout (st_gcn, cnn) acts in train mode, under
`frozen_bn` too, with its mask from the caller's generator.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .graph import build_partitioned_adjacency, build_spacetime_adjacency
from .stsgcn import (BatchNorm, Dense, STSGCNStack, _uniform_, batch_norm_eval,
                     batch_norm_train, dropout)

TEMPORAL_KERNEL = 9  # the ST-GCN block's temporal convolution, 9 x 1 over T


def _lecun_normal_(t: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]):
    """flax's `lecun_normal`: a normal truncated to +-2 standard deviations,
    scaled to variance 1 / fan_in, drawn on the CPU from `generator` (the
    inverse CDF of a uniform draw, in float64)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    lo, hi = (0.5 * (1.0 + math.erf(b / math.sqrt(2.0))) for b in (-2.0, 2.0))
    with torch.no_grad():
        u = torch.empty(t.shape, dtype=torch.float64).uniform_(lo, hi, generator=generator)
        z = (math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).clamp_(-2.0, 2.0)
        t.copy_(z * std)


def _bn(h: torch.Tensor, norm: BatchNorm, live: bool) -> torch.Tensor:
    return batch_norm_train(h, norm) if live else batch_norm_eval(h, norm)


class TemporalConv(nn.Module):
    """flax `nn.Conv(features, kernel_size=(9, 1), padding=((4, 4), (0, 0)))`
    over [B, T, V, C]: `kernel` [9, 1, C_in, C_out] (flax's layout), `bias`
    [C_out]; lecun-normal kernel, zero bias.

    `forward` sums one matmul a tap (`addmm`) over the time-major,
    zero-padded input, whose every tap is then a contiguous slice. A cuDNN
    convolution would run in TF32 on the card at PyTorch's default
    (`cudnn.allow_tf32`), a 10-bit mantissa under a float32 config; a matmul
    stays float32 at PyTorch's default, forward and backward, as JAX's
    convolution is."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(TEMPORAL_KERNEL, 1, in_channels, out_channels))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        k, _, c_in, _ = self.kernel.shape
        _lecun_normal_(self.kernel, k * c_in, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        b, t, v, c = h.shape
        taps = self.kernel.shape[0]
        pad = (taps - 1) // 2
        hp = F.pad(h.movedim(1, 0).contiguous(), (0, 0, 0, 0, 0, 0, pad, pad))
        out = self.bias
        for i in range(taps):  # addmm: each tap's product added in the matmul's epilogue
            out = torch.addmm(out, hp[i:i + t].reshape(-1, c), self.kernel[i, 0])
        return out.view(t, b, v, -1).movedim(0, 1)


class STGCNBlock(nn.Module):
    """One ST-GCN layer (Yan et al.): a dense layer to K * C_out channels,
    the partitioned spatial contraction with the (importance-weighted)
    adjacency, BN -> ReLU -> 9x1 temporal conv -> BN -> dropout, the
    residual (identity, or dense + BN when the channel count changes) and a
    ReLU. [B, T, V, C_in] -> [B, T, V, C_out]."""

    def __init__(self, in_channels: int, out_channels: int, n_partitions: int,
                 dropout: float = 0.0):
        super().__init__()
        self.out_channels, self.n_partitions, self.dropout = out_channels, n_partitions, dropout
        if in_channels != out_channels:
            self.residual_dense = Dense(in_channels, out_channels)
            self.residual_bn = BatchNorm(out_channels)
        else:
            self.residual_dense = self.residual_bn = None
        self.gcn_dense = Dense(in_channels, out_channels * n_partitions)
        self.bn1 = BatchNorm(out_channels)
        self.tconv = TemporalConv(out_channels, out_channels)
        self.bn2 = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor, adj: torch.Tensor, train: bool = False,
                frozen_bn: bool = False, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        live = train and not frozen_bn
        res = (x if self.residual_dense is None
               else _bn(self.residual_dense(x), self.residual_bn, live))
        h = self.gcn_dense(x)
        b, t, v, _ = h.shape
        h = h.reshape(b, t, v, self.n_partitions, self.out_channels)
        h = torch.einsum("btvkc,kvw->btwc", h, adj)
        h = torch.relu(_bn(h, self.bn1, live))
        h = _bn(self.tconv(h), self.bn2, live)
        h = dropout(h, self.dropout, train, generator)
        return torch.relu(h + res)


class STGCNEncoder(nn.Module):
    """The fixed-skeleton ST-GCN encoder: the input BatchNorm over the
    (V * C) features of a frame (`data_bn`), then one `STGCNBlock` a channel
    of layer_channels + [hidden], each with its edge-importance mask
    (`edge_importance_{i}`, all ones at init) on the openpose layout's
    spatial partition (the JAX encoder's defaults, which make_encoder
    keeps): 17 joints."""

    def __init__(self, input_dim: int, layer_channels: Sequence[int], hidden_dimension: int,
                 n_joints: int = 17, dropout: float = 0.0):
        super().__init__()
        adj = torch.as_tensor(build_partitioned_adjacency("openpose", "spatial"),
                              dtype=torch.float32)
        if adj.shape[1] != n_joints:
            raise ValueError(f"graph layout openpose has {adj.shape[1]} joints, "
                             f"input has {n_joints}")
        self.register_buffer("adj", adj, persistent=False)
        self.data_bn = BatchNorm(n_joints * input_dim)
        schedule = list(layer_channels) + [hidden_dimension]
        self.n_layers = len(schedule)
        c = input_dim
        for i, ch in enumerate(schedule):
            self.register_parameter(f"edge_importance_{i}", nn.Parameter(torch.ones(adj.shape)))
            self.add_module(f"layer_{i}", STGCNBlock(c, ch, adj.shape[0], dropout=dropout))
            c = ch

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            for i in range(self.n_layers):
                getattr(self, f"edge_importance_{i}").fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool = False, frozen_bn: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, t, v, c = x.shape
        h = _bn(x.reshape(b, t, v * c), self.data_bn, train and not frozen_bn)
        h = h.reshape(b, t, v, c)
        for i in range(self.n_layers):
            adj = self.adj * getattr(self, f"edge_importance_{i}")
            h = getattr(self, f"layer_{i}")(h, adj, train=train, frozen_bn=frozen_bn,
                                            generator=generator)
        return h


class PlainGCNLayer(nn.Module):
    """relu(adj @ (x @ weight) + bias) over [B, N, C]: `weight` [C_in,
    C_out] and `bias` [C_out], both uniform +-1/sqrt(C_out)."""

    def __init__(self, in_channels: int, out_channels: int, use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels))
        self.bias = nn.Parameter(torch.empty(out_channels)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        _uniform_(self.weight, bound, generator)
        if self.bias is not None:
            _uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        h = adj @ (x @ self.weight)
        if self.bias is not None:
            h = h + self.bias
        return torch.relu(h)


class LearnablePlainGCNEncoder(nn.Module):
    """A plain GCN over the T*V nodes whose adjacency is a parameter
    (`adj_{i}` [T*V, T*V], uniform(0, 1) at init) passed through a row
    softmax each forward."""

    def __init__(self, input_dim: int, layer_channels: Sequence[int], hidden_dimension: int,
                 n_frames: int, n_joints: int, use_bias: bool = True):
        super().__init__()
        n = n_frames * n_joints
        schedule = list(layer_channels) + [hidden_dimension]
        self.n_layers = len(schedule)
        c = input_dim
        for i, ch in enumerate(schedule):
            self.register_parameter(f"adj_{i}", nn.Parameter(torch.empty(n, n)))
            self.add_module(f"layer_{i}", PlainGCNLayer(c, ch, use_bias))
            c = ch
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            for i in range(self.n_layers):
                adj = getattr(self, f"adj_{i}")
                adj.copy_(torch.empty(adj.shape).uniform_(0.0, 1.0, generator=generator))

    def forward(self, x: torch.Tensor, train: bool = False, frozen_bn: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, t, v, c = x.shape
        h = x.reshape(b, t * v, c)
        for i in range(self.n_layers):
            adj = torch.softmax(getattr(self, f"adj_{i}"), dim=-1)
            h = getattr(self, f"layer_{i}")(h, adj)
        return h.reshape(b, t, v, -1)


class StaticPlainGCNEncoder(nn.Module):
    """A plain GCN over the fixed row-normalized space-time adjacency of
    `graph.build_spacetime_adjacency` (bones and self loops, replicated over
    every frame pair, plus each joint's temporal chain)."""

    def __init__(self, input_dim: int, layer_channels: Sequence[int], hidden_dimension: int,
                 n_frames: int, n_joints: int, use_bias: bool = True):
        super().__init__()
        self.register_buffer("adj", torch.as_tensor(build_spacetime_adjacency(n_frames, n_joints)),
                             persistent=False)
        schedule = list(layer_channels) + [hidden_dimension]
        self.n_layers = len(schedule)
        c = input_dim
        for i, ch in enumerate(schedule):
            self.add_module(f"layer_{i}", PlainGCNLayer(c, ch, use_bias))
            c = ch

    def forward(self, x: torch.Tensor, train: bool = False, frozen_bn: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, t, v, c = x.shape
        h = x.reshape(b, t * v, c)
        for i in range(self.n_layers):
            h = getattr(self, f"layer_{i}")(h, self.adj)
        return h.reshape(b, t, v, -1)


class CNNEncoder(nn.Module):
    """A 1x1 conv (`dense_{i}`) -> BatchNorm (`bn_{i}`) -> dropout stack,
    one a channel of layer_channels + [hidden], with no activation."""

    def __init__(self, input_dim: int, layer_channels: Sequence[int], hidden_dimension: int,
                 dropout: float = 0.0, use_bias: bool = True):
        super().__init__()
        self.dropout = dropout
        schedule = list(layer_channels) + [hidden_dimension]
        self.n_layers = len(schedule)
        c = input_dim
        for i, ch in enumerate(schedule):
            self.add_module(f"dense_{i}", Dense(c, ch, use_bias))
            self.add_module(f"bn_{i}", BatchNorm(ch))
            c = ch

    def forward(self, x: torch.Tensor, train: bool = False, frozen_bn: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(self.n_layers):
            x = _bn(getattr(self, f"dense_{i}")(x), getattr(self, f"bn_{i}"),
                    train and not frozen_bn)
            x = dropout(x, self.dropout, train, generator)
        return x


def make_encoder(encoder_type: str, input_dim: int, layer_channels: Sequence[int],
                 hidden_dimension: int, n_frames: int, n_joints: int, dropout: float,
                 use_bias: bool, dtype: torch.dtype = torch.float32) -> nn.Module:
    """The encoder registry of `coskad_tpu/models/encoders.py::make_encoder`;
    `dtype` reaches the `sts_gcn` stack only, as there."""
    et = encoder_type.lower()
    if et == "sts_gcn":
        return STSGCNStack(input_dim, list(layer_channels) + [hidden_dimension], n_frames,
                           n_joints, use_bias, dtype, dropout)
    if et == "st_gcn":
        return STGCNEncoder(input_dim, layer_channels, hidden_dimension, n_joints, dropout)
    if et == "learnable_gcn":
        return LearnablePlainGCNEncoder(input_dim, layer_channels, hidden_dimension, n_frames,
                                        n_joints, use_bias)
    if et == "static_gcn":
        return StaticPlainGCNEncoder(input_dim, layer_channels, hidden_dimension, n_frames,
                                     n_joints, use_bias)
    if et == "cnn":
        return CNNEncoder(input_dim, layer_channels, hidden_dimension, dropout, use_bias)
    raise ValueError(
        f"Encoder type {encoder_type!r} not supported; choose from "
        "['sts_gcn', 'st_gcn', 'learnable_gcn', 'static_gcn', 'cnn']"
    )
