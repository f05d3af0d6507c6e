"""Poincaré-ball operations (PyTorch), counterpart of
`coskad_tpu/geometry/poincare.py`.

What training, center initialization and scoring use: the exponential and
logarithmic maps at the origin, projection onto the ball, Möbius addition,
the geodesic distance, and the Einstein midpoint through Klein coordinates,
with its additive per-batch statistics; for the contrastive view, the
all-pairs Möbius addition, the distance matrix and the InfoNCE loss. Then
the tools no training path calls, for analysis and for the Möbius layers
(`hyperbolic_nn.py`): the maps at any point, Möbius scalar and matrix
products, hyperbolic softmax logits, the distance to a hyperplane, the
curvature of a unit-volume ball, Gromov's delta and the Fréchet mean. The
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


def arsinh(x: torch.Tensor) -> torch.Tensor:
    return torch.asinh(x)


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


def expmap(x: torch.Tensor, u: torch.Tensor, k: float = -1.0) -> torch.Tensor:
    """Exponential map at x."""
    sqrt_c = _sqrt_c(k)
    u_norm = _norm(u)
    second = torch.tanh(sqrt_c / 2.0 * lambda_x(x, k) * u_norm) * u / (sqrt_c * u_norm)
    return mobius_add(x, second, k)


def logmap(x: torch.Tensor, y: torch.Tensor, k: float = -1.0) -> torch.Tensor:
    """Logarithmic map at x."""
    sqrt_c = _sqrt_c(k)
    sub = mobius_add(-x, y, k)
    sub_norm = _norm(sub)
    return 2.0 / sqrt_c / lambda_x(x, k) * artanh(sqrt_c * sub_norm) * sub / sub_norm


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


def mobius_scalar_mul(r, x: torch.Tensor, k: float = -1.0) -> torch.Tensor:
    """Möbius scalar multiplication r (x)_k x."""
    sqrt_c = _sqrt_c(k)
    x_norm = _norm(x)
    return torch.tanh(r * artanh(sqrt_c * x_norm)) * x / (x_norm * sqrt_c)


def mobius_matvec(m: torch.Tensor, x: torch.Tensor, k: float = -1.0) -> torch.Tensor:
    """Möbius matrix-vector product M (x)_k x (x @ m.T over the last dim);
    0 where M x is 0."""
    sqrt_c = _sqrt_c(k)
    x_norm = _norm(x)
    mx = torch.einsum("...d,ed->...e", x, m)
    mx_norm = _norm(mx)
    res = torch.tanh(mx_norm / x_norm * artanh(sqrt_c * x_norm)) * mx / (mx_norm * sqrt_c)
    zero_mx = torch.all(mx == 0.0, dim=-1, keepdim=True)
    return torch.where(zero_mx, torch.zeros_like(res), res)


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


def _vector_norm(x: torch.Tensor, dim: int, keepdim: bool = False) -> torch.Tensor:
    """jnp.linalg.norm over `dim`: the square root of the sum of squares,
    no floor."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim))


def hyperbolic_softmax(x: torch.Tensor, a: torch.Tensor, p: torch.Tensor,
                       k: float = -1.0) -> torch.Tensor:
    """Hyperbolic multinomial logistic regression logits (reference
    utils/hyper_math.py:428-436): x [B, D] points, a [C, D] tangent normals,
    p [C, D] hyperplane offsets -> [B, C]."""
    c = -k
    lambda_pkc = 2.0 / (1.0 - c * torch.sum(p * p, dim=1))
    kk = lambda_pkc * _vector_norm(a, 1) / math.sqrt(c)
    mob = mobius_addition_batch(-p, x, k)  # [C, B, D]
    num = 2.0 * math.sqrt(c) * torch.sum(mob * a[:, None, :], dim=-1)
    denom = _vector_norm(a, 1, keepdim=True) * (1.0 - c * torch.sum(mob * mob, dim=2))
    return (kk[:, None] * arsinh(num / denom)).T


def dist2plane(x: torch.Tensor, p: torch.Tensor, a: torch.Tensor, k: float = -1.0,
               signed: bool = True) -> torch.Tensor:
    """Signed (or absolute) distance from x to the hyperplane through p with
    tangent normal a (geoopt's dist2plane; `MobiusDist2Hyperplane`)."""
    c = -k
    sqrt_c = math.sqrt(c)
    diff = mobius_add(-p, x, k)
    diff2 = torch.sum(diff * diff, dim=-1)
    sc = torch.sum(diff * a, dim=-1)
    if not signed:
        sc = torch.abs(sc)
    num = 2.0 * sqrt_c * sc
    denom = _floor((1.0 - c * diff2) * _vector_norm(a, -1))
    return arsinh(num / denom) / sqrt_c


def auto_select_c(d: int) -> float:
    """The curvature at which the d-dimensional ball has volume pi
    (reference utils/hyper_math.py:494-504)."""
    dim2 = d / 2.0
    r = (math.gamma(dim2 + 1) / (math.pi ** (dim2 - 1))) ** (1.0 / d)
    return 1.0 / (r * r)


def delta_hyp(dismat: torch.Tensor) -> torch.Tensor:
    """Gromov's delta-hyperbolicity of a distance matrix, from its first
    point (reference utils/hyper_math.py:536-542)."""
    row = dismat[0, :][None, :]
    col = dismat[:, 0][:, None]
    gromov = 0.5 * (row + col - dismat)
    maxmin = torch.amax(torch.minimum(gromov[:, :, None], gromov[None, :, :]), dim=1)
    return torch.amax(maxmin - gromov)


def relative_delta(emb: torch.Tensor) -> torch.Tensor:
    """2 delta / diameter of the embedding's Euclidean distance matrix; the
    reference estimates a curvature as (0.144 / relative delta)^2
    (utils/hyper_math.py:545-561)."""
    d2 = torch.sum((emb[:, None, :] - emb[None, :, :]) ** 2, dim=-1)
    dists = torch.sqrt(torch.clamp(d2, min=0.0))
    return 2.0 * delta_hyp(dists) / torch.amax(dists)


def frechet_mean(xs: torch.Tensor, k: float = -1.0, num_iters: int = 30,
                 step_size: float = 0.5, weights: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """The Karcher / Fréchet mean of xs [N, D] by the damped fixed point
    m <- exp_m(step_size * mean(log_m(x_i))) from the Einstein midpoint,
    `num_iters` times (JAX's `lax.scan`, unrolled here); differentiable.
    A unit step overshoots in negative curvature for spread-out points, so
    the step is 0.5."""
    w = weights if weights is not None else torch.ones(xs.shape[0], dtype=xs.dtype,
                                                       device=xs.device)
    w = w / torch.sum(w)
    m = weighted_midpoint(xs, k, weights=w * xs.shape[0])
    for _ in range(num_iters):
        step = torch.sum(w[:, None] * logmap(m[None, :], xs, k), dim=0)
        m = project(expmap(m, step_size * step, k), k)
    return m


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
