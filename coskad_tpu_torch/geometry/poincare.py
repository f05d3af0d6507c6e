"""Poincaré-ball operations of the hyperbolic variant (PyTorch).

Counterpart of the part of `coskad_tpu/geometry/poincare.py` that training,
center initialization and scoring use: the exponential and logarithmic maps
at the origin, projection onto the ball, Möbius addition, the geodesic
distance, and the Einstein midpoint through Klein coordinates, with its
additive per-batch statistics; and for the contrastive view, the
all-pairs Möbius addition, the distance matrix and the InfoNCE loss. The
same float32 safeguards as the JAX
module: artanh's argument clipped to 1 - 1e-7, norms floored at 1e-15 under
the square root, points projected onto a ball shrunk by 4e-3 (1e-5 in
float64). Floors and clips use `torch.maximum` / `torch.minimum`, which
share the gradient at a tie as `jnp.maximum` / `jnp.minimum` do, and
selections `torch.where`, as the JAX module does.

`k` is the (negative) curvature, default -1. Every op broadcasts over
leading batch dimensions; the manifold dimension is the last axis.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

BALL_EPS_F32 = 4e-3
BALL_EPS_F64 = 1e-5
_ARTANH_EPS = 1e-7
_MIN_NORM = 1e-15


def _ball_eps(dtype: torch.dtype) -> float:
    return BALL_EPS_F64 if dtype == torch.float64 else BALL_EPS_F32


def _const(x: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full((), value, dtype=x.dtype, device=x.device)


def _floor(x: torch.Tensor, value: float = _MIN_NORM) -> torch.Tensor:
    """jnp.maximum(x, value)."""
    return torch.maximum(x, _const(x, value))


def _sqrt_c(k: float) -> float:
    return math.sqrt(-k)


def artanh(x: torch.Tensor) -> torch.Tensor:
    """Inverse hyperbolic tangent with the argument clipped to
    [-1 + 1e-7, 1 - 1e-7] (jnp.clip: a maximum, then a minimum)."""
    x = torch.maximum(_const(x, -1.0 + _ARTANH_EPS), x)
    x = torch.minimum(_const(x, 1.0 - _ARTANH_EPS), x)
    return 0.5 * (torch.log1p(x) - torch.log1p(-x))


def _norm(x: torch.Tensor, keepdim: bool = True) -> torch.Tensor:
    return torch.sqrt(_floor(torch.sum(x * x, dim=-1, keepdim=keepdim)))


def project(x: torch.Tensor, k: float = -1.0) -> torch.Tensor:
    """Radially rescale points outside the ball of radius (1 - eps)/sqrt(-k)
    onto its boundary."""
    maxnorm = (1.0 - _ball_eps(x.dtype)) / _sqrt_c(k)
    norm = _norm(x)
    return torch.where(norm > maxnorm, x / norm * maxnorm, x)


def lambda_x(x: torch.Tensor, k: float = -1.0, keepdim: bool = True) -> torch.Tensor:
    """Conformal factor 2 / (1 + k |x|^2)."""
    x2 = torch.sum(x * x, dim=-1, keepdim=keepdim)
    return 2.0 / _floor(1.0 + k * x2)


def mobius_add(x: torch.Tensor, y: torch.Tensor, k: float = -1.0) -> torch.Tensor:
    """Möbius addition x (+)_k y."""
    c = -k
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    y2 = torch.sum(y * y, dim=-1, keepdim=True)
    xy = torch.sum(x * y, dim=-1, keepdim=True)
    num = (1.0 + 2.0 * c * xy + c * y2) * x + (1.0 - c * x2) * y
    denom = 1.0 + 2.0 * c * xy + c * c * x2 * y2
    return num / _floor(denom)


def expmap0(u: torch.Tensor, k: float = -1.0) -> torch.Tensor:
    """Exponential map at the origin: tangent vector -> point of the ball."""
    sqrt_c = _sqrt_c(k)
    u_norm = _norm(u)
    return torch.tanh(sqrt_c * u_norm) * u / (sqrt_c * u_norm)


def logmap0(y: torch.Tensor, k: float = -1.0) -> torch.Tensor:
    """Logarithmic map at the origin: point of the ball -> tangent vector."""
    sqrt_c = _sqrt_c(k)
    y_norm = _norm(y)
    return y / y_norm / sqrt_c * artanh(sqrt_c * y_norm)


def dist(x: torch.Tensor, y: torch.Tensor, k: float = -1.0,
         keepdim: bool = False) -> torch.Tensor:
    """Geodesic distance 2/sqrt(-k) artanh(sqrt(-k) |(-x) (+) y|)."""
    sqrt_c = _sqrt_c(k)
    d = _norm(mobius_add(-x, y, k), keepdim=keepdim)
    return 2.0 / sqrt_c * artanh(sqrt_c * d)


def dist0(x: torch.Tensor, k: float = -1.0, keepdim: bool = False) -> torch.Tensor:
    """Geodesic distance to the origin."""
    sqrt_c = _sqrt_c(k)
    return 2.0 / sqrt_c * artanh(sqrt_c * _norm(x, keepdim=keepdim))


def poincare_to_klein(x: torch.Tensor, k: float = -1.0) -> torch.Tensor:
    denom = 1.0 + (-k) * torch.sum(x * x, dim=-1, keepdim=True)
    return 2.0 * x / denom


def klein_to_poincare(x: torch.Tensor, k: float = -1.0) -> torch.Tensor:
    denom = 1.0 + torch.sqrt(_floor(1.0 - (-k) * torch.sum(x * x, dim=-1, keepdim=True)))
    return x / denom


def lorenz_factor(x: torch.Tensor, k: float = -1.0, keepdim: bool = True) -> torch.Tensor:
    """Lorentz (gamma) factor of a point in Klein coordinates."""
    x2 = torch.sum(x * x, dim=-1, keepdim=keepdim)
    return 1.0 / torch.sqrt(_floor(1.0 - (-k) * x2))


def weighted_midpoint(xs: torch.Tensor, k: float = -1.0,
                      weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Einstein midpoint of points xs [N, D] of the ball (optionally
    weighted [N]): the Lorentz-factor-weighted mean in Klein coordinates,
    mapped back and projected. -> [D]."""
    klein = poincare_to_klein(xs, k)
    gamma = lorenz_factor(klein, k)
    if weights is not None:
        gamma = gamma * weights[:, None]
    mean_klein = torch.sum(gamma * klein, dim=0) / _floor(torch.sum(gamma, dim=0))
    return project(klein_to_poincare(mean_klein, k), k)


def streaming_midpoint_stats(xs: torch.Tensor, k: float = -1.0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The midpoint's additive statistics over xs [N, D]: (sum of gamma_i
    times the Klein point [D], sum of gamma_i [1]). Summed over batches they
    give the midpoint of all of them (`midpoint_from_stats`)."""
    klein = poincare_to_klein(xs, k)
    gamma = lorenz_factor(klein, k)
    return torch.sum(gamma * klein, dim=0), torch.sum(gamma, dim=0)


def midpoint_from_stats(weighted_sum: torch.Tensor, total_weight: torch.Tensor,
                        k: float = -1.0) -> torch.Tensor:
    mean_klein = weighted_sum / _floor(total_weight)
    return project(klein_to_poincare(mean_klein, k), k)


# ------------------------------------------------------- all-pairs, InfoNCE


def mobius_addition_batch(x: torch.Tensor, y: torch.Tensor, k: float = -1.0) -> torch.Tensor:
    """All-pairs Möbius addition: x [B, D], y [C, D] -> [B, C, D], with the
    reference's 1e-5 added to the denominator (no floor)."""
    c = -k
    xy = x @ y.T  # [B, C]
    x2 = torch.sum(x * x, dim=-1, keepdim=True)  # [B, 1]
    y2 = torch.sum(y * y, dim=-1, keepdim=True)  # [C, 1]
    num = (1 + 2 * c * xy + c * y2.T)[:, :, None] * x[:, None, :]
    num = num + (1 - c * x2)[:, :, None] * y[None, :, :]
    denom = 1 + 2 * c * xy + c ** 2 * x2 * y2.T
    return num / (denom[:, :, None] + 1e-5)


def dist_matrix(x: torch.Tensor, y: torch.Tensor, k: float = -1.0) -> torch.Tensor:
    """All-pairs geodesic distances: x [B, D], y [C, D] -> [B, C]. The norm
    is jnp.linalg.norm's, sqrt of the sum of squares with no floor."""
    sqrt_c = _sqrt_c(k)
    m = mobius_addition_batch(-x, y, k)
    norms = torch.sqrt(torch.sum(m * m, dim=-1))
    return 2.0 / sqrt_c * artanh(sqrt_c * norms)


def contrastive_loss(x: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor, tau: float,
                     hyp_c: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hyperbolic (cosine-style dot products when hyp_c == 0) InfoNCE loss.
    Returns (loss, logits [B, 2B]).

    The argument semantics are the reference's, whose names mislead: the
    target of sample i is column i of dist(x, `neg`), so `neg` is the
    cross-view batch whose diagonal holds the positive pairs, while `pos` is
    the same-view batch of negatives, its diagonal masked with eye * 1e9."""
    if hyp_c == 0:
        def dist_f(u, v):
            return u @ v.T
    else:
        def dist_f(u, v):
            return -dist_matrix(u, v, k=-hyp_c)
    bsize = x.shape[0]
    eye_mask = torch.eye(bsize, dtype=x.dtype, device=x.device) * 1e9
    logits00 = dist_f(x, pos) / tau - eye_mask
    logits01 = dist_f(x, neg) / tau
    logits = torch.cat([logits01, logits00], dim=1)
    logits = logits - torch.amax(logits, dim=1, keepdim=True).detach()
    log_probs = torch.log_softmax(logits, dim=1)
    target = torch.arange(bsize, device=x.device)
    loss = -torch.mean(log_probs[target, target])
    return loss, logits
