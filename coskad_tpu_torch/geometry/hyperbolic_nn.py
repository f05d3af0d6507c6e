"""Hyperbolic layers (counterpart of `coskad_tpu/geometry/hyperbolic_nn.py`).

The reference's hyperbolic layers (utils/hyperbolic.py:119-260):
`MobiusLinear` (a Möbius matrix-vector product and a Möbius bias on the
ball) and `MobiusDist2Hyperplane` (signed distances to learned hyperplanes,
scaled by exp(scale)). No model of the package uses them. Their parameters
carry flax's names and layouts (`kernel` [features, in], `bias`
[features]; `point`, `tangent` [features, in], `scale` [features]), so
`interop.load_jax_variables(layer, params, {})` fills a layer from the JAX
module's params. The weights are drawn from an explicit `torch.Generator`
(`reset_parameters`), on the CPU, so a seed gives the same layer on every
device.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from . import poincare as pm


def _normal(shape, generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.randn(shape, generator=generator)


class MobiusLinear(nn.Module):
    """y = project((W (x) x) (+) b) on the ball of curvature k; with
    `hyperbolic_input` False, x is a tangent vector: y = exp0(x W^T) (+) b.
    `nonlin` is applied in the tangent space at the origin (log0, f, exp0).

    Init (HNN++, reference utils/hyperbolic.py:186-192): the kernel from a
    normal of std 1 / sqrt(2 features in) / 100, the bias the ball point
    exp0(normal / 400)."""

    def __init__(self, in_features: int, features: int, k: float = -1.0,
                 use_bias: bool = True, hyperbolic_input: bool = True,
                 nonlin: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.k, self.hyperbolic_input, self.nonlin = k, hyperbolic_input, nonlin
        self.kernel = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        features, in_features = self.kernel.shape
        std = 1.0 / math.sqrt(2.0 * features * in_features) / 100.0
        with torch.no_grad():
            self.kernel.copy_(std * _normal(self.kernel.shape, generator))
            if self.bias is not None:
                self.bias.copy_(pm.expmap0(_normal(self.bias.shape, generator) / 400.0,
                                           self.k))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.hyperbolic_input:
            out = pm.mobius_matvec(self.kernel, x, self.k)
        else:
            out = pm.expmap0(torch.einsum("...d,ed->...e", x, self.kernel), self.k)
        if self.bias is not None:
            out = pm.mobius_add(out, self.bias.expand_as(out), self.k)
        if self.nonlin is not None:
            out = pm.expmap0(self.nonlin(pm.logmap0(out, self.k)), self.k)
        return pm.project(out, self.k)


class MobiusDist2Hyperplane(nn.Module):
    """Signed distances of x [..., in] to `features` learned Poincaré
    hyperplanes, each through `point` with the normal `tangent` (normalized
    in the forward), scaled by exp(`scale`) (reference
    utils/hyperbolic.py:223-252). Init: points project(exp0(normal / 4)),
    tangents normal, scales 0."""

    def __init__(self, in_features: int, features: int, k: float = -1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.k = k
        self.point = nn.Parameter(torch.empty(features, in_features))
        self.tangent = nn.Parameter(torch.empty(features, in_features))
        self.scale = nn.Parameter(torch.empty(features))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.point.copy_(pm.project(pm.expmap0(_normal(self.point.shape, generator) / 4.0,
                                                   self.k), self.k))
            self.tangent.copy_(_normal(self.tangent.shape, generator))
            self.scale.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tangent = self.tangent / torch.sqrt(torch.sum(self.tangent * self.tangent, dim=-1,
                                                      keepdim=True))
        d = pm.dist2plane(x[..., None, :], self.point, tangent, self.k, signed=True)
        return d * torch.exp(self.scale)
