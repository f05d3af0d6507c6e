"""PowerSpherical and hyperspherical-uniform distributions (PyTorch).

Counterpart of `coskad_tpu/geometry/sphere.py`: the spherical VAE's
posterior PowerSpherical(loc, scale) (De Cao & Aziz, 2020), with density
~ (1 + loc^T x)^scale on S^{D-1}, its uniform prior, and the KL between
them; also the diagonal-Normal KL of the `distribution='normal'` VAE.

Sampling is reparameterized. The marginal t = loc^T x is 2 Beta(alpha,
beta) - 1, the Beta drawn as Ga / (Ga + Gb) from two `torch._standard_gamma`
draws: their autograd is the implicit reparameterization gradient with
respect to the concentration, as `jax.random.beta` gives JAX's `rsample`. A
tangent direction from a normal draw and a Householder reflection taking
e1 onto loc complete the sample. Every draw comes from the caller's
`torch.Generator`, on the tensors' device. Special functions run in the
dtype of `scale` (float32 in the models).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from ..parallel import mesh


def _log_surface_area(sphere_dim: int) -> float:
    """Log surface area of S^{sphere_dim} embedded in R^{sphere_dim + 1}."""
    d = sphere_dim + 1
    return math.log(2.0) + (d / 2.0) * math.log(math.pi) - math.lgamma(d / 2.0)


class HypersphericalUniform(NamedTuple):
    """Uniform distribution on S^{dim} (dim = ambient dimension - 1)."""

    dim: int

    def entropy(self) -> torch.Tensor:
        return torch.tensor(_log_surface_area(self.dim), dtype=torch.float32)

    def sample(self, generator: torch.Generator, shape: Sequence[int] = (),
               device=None) -> torch.Tensor:
        v = torch.randn((*shape, self.dim + 1), generator=generator, device=device)
        return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _householder(loc: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y reflected by the Householder map that takes e1 onto loc."""
    e1 = torch.zeros_like(loc)
    e1[..., 0] = 1.0
    u = e1 - loc
    u = u / torch.clamp(torch.linalg.vector_norm(u, dim=-1, keepdim=True), min=1e-12)
    return y - 2.0 * u * torch.sum(u * y, dim=-1, keepdim=True)


def _tangent_sample(loc: torch.Tensor, t: torch.Tensor, v_raw: torch.Tensor) -> torch.Tensor:
    """The sample with marginal t [..., 1] and tangent noise v_raw [..., D-1]."""
    v = v_raw / torch.linalg.vector_norm(v_raw, dim=-1, keepdim=True)
    y = torch.cat([t, torch.sqrt(torch.clamp(1.0 - t ** 2, min=0.0)) * v], dim=-1)
    return _householder(loc, y)


class PowerSpherical(NamedTuple):
    """PowerSpherical(loc, scale) on the unit sphere.

    loc: [..., D] unit vectors, scale (the concentration kappa): [...]."""

    loc: torch.Tensor
    scale: torch.Tensor

    @property
    def dim(self) -> int:
        return self.loc.shape[-1]

    def _alpha_beta(self):
        beta = (self.dim - 1.0) / 2.0
        return beta + self.scale, beta

    def log_normalizer(self) -> torch.Tensor:
        alpha, beta = self._alpha_beta()
        return -((alpha + beta) * math.log(2.0) + torch.lgamma(alpha)
                 - torch.lgamma(alpha + beta) + beta * math.log(math.pi))

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return self.log_normalizer() + self.scale * torch.log1p(torch.sum(self.loc * x, dim=-1))

    def entropy(self) -> torch.Tensor:
        alpha, beta = self._alpha_beta()
        digamma = torch.special.digamma
        return -(self.log_normalizer()
                 + self.scale * (math.log(2.0) + digamma(alpha) - digamma(alpha + beta)))

    def rsample(self, generator: torch.Generator) -> torch.Tensor:
        """A reparameterized sample from `generator` (on loc's device);
        gradients flow to loc and to scale. In a sharded scope
        (`parallel/mesh.py`) loc is a rank's block of the batch: the Beta
        draw depends on every row's concentration, so the concentrations
        are gathered (`mesh.gather_rows`, whose backward returns each rank
        its rows' gradient), the global batch is drawn and this rank keeps
        its rows, which are then the one-process draw's."""
        alpha, beta = self._alpha_beta()
        lay = mesh.active()
        if lay is not None:
            alpha = mesh.gather_rows(alpha)
        ga = torch._standard_gamma(alpha, generator=generator)
        gb = torch._standard_gamma(torch.full_like(alpha, beta), generator=generator)
        z = ga / (ga + gb)
        v = torch.randn((*alpha.shape, self.dim - 1), generator=generator,
                        device=self.loc.device, dtype=self.loc.dtype)
        if lay is not None:
            z, v = lay.rows(z), lay.rows(v)
        return _tangent_sample(self.loc, (2.0 * z - 1.0)[..., None], v)

    def sample_from_draws(self, z01: torch.Tensor, v_raw: torch.Tensor) -> torch.Tensor:
        """The sample from fed draws: z01 [...] in (0, 1) (the Beta draw) and
        v_raw [..., D-1] (tangent noise). Both packages give the same sample
        from the same draws (the lockstep hook); gradients reach loc through
        the Householder map, none reach scale (the draws are constants)."""
        return _tangent_sample(self.loc, (2.0 * z01 - 1.0)[..., None], v_raw)

    def kl_to_uniform(self) -> torch.Tensor:
        """KL(PowerSpherical || HypersphericalUniform on S^{D-1})."""
        return -self.entropy() + _log_surface_area(self.dim - 1)


def normal_kl_standard(mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """KL(N(mean, std^2) || N(0, 1)) elementwise; [..., D] -> [..., D]. The
    VAE's head gives the standard deviation (the reference's Normal scale)."""
    return 0.5 * (std ** 2 + mean ** 2 - 1.0) - torch.log(std)
