"""The spherical VAE's distributions: the port's PowerSpherical,
HypersphericalUniform and normal_kl_standard against
`coskad_tpu/geometry/sphere.py` on the same seeded inputs, and the port's
reparameterized sampler by its statistics.

Tolerances: values against JAX rtol 1e-5 (atol 1e-6 for the fed-draw
samples, whose coordinates pass through 0); the log-normalizer's sums
(entropy, KL, log_prob) add atol 4 float32 ulps of their largest term,
|lgamma(alpha + beta)| + (alpha + beta) log 2 (up to ~250 at kappa 60 and
D 16), as each package's lgamma and digamma round there and the result
cancels down to O(1); a sample lies on the sphere within 1e-5; the mean
of loc . x over N samples within 4 standard errors of (alpha - beta) /
(alpha + beta), and its derivative in kappa within 5 standard errors of
2 beta / (2 beta + kappa)^2."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coskad_tpu.geometry import sphere as jsphere
from coskad_tpu_torch.geometry import sphere

torch.set_num_threads(1)

TOL = dict(rtol=1e-5)
N_STAT = 32768


def cancel_tol(scale, d):
    """rtol 1e-5 and atol 4 float32 ulps of the log-normalizer's largest
    term at concentration `scale` on S^{d-1}."""
    ab = np.asarray(scale, np.float64) + (d - 1.0)
    big = np.abs(np.vectorize(math.lgamma)(ab)) + ab * math.log(2.0)
    return dict(rtol=1e-5, atol=4 * np.finfo(np.float32).eps * float(big.max()))


def unit(rng, n, d):
    v = rng.normal(size=(n, d))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def pair(rng, n, d, lo=1.0, hi=60.0):
    loc = unit(rng, n, d)
    scale = rng.uniform(lo, hi, size=n).astype(np.float32)
    return (sphere.PowerSpherical(torch.from_numpy(loc), torch.from_numpy(scale)),
            jsphere.PowerSpherical(jnp.asarray(loc), jnp.asarray(scale)), loc)


@pytest.mark.parametrize("d", [3, 16])
@pytest.mark.parametrize("name", ["log_normalizer", "entropy", "kl_to_uniform"])
def test_power_spherical_functions_match_jax(name, d):
    ps, jps, _ = pair(np.random.default_rng(d), 64, d)
    got, want = getattr(ps, name)(), getattr(jps, name)()
    assert got.dtype == torch.float32 and got.shape == (64,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **cancel_tol(ps.scale, d))


@pytest.mark.parametrize("d", [3, 16])
def test_log_prob_and_sample_from_draws_match_jax(d):
    rng = np.random.default_rng(10 + d)
    ps, jps, loc = pair(rng, 64, d)
    z01 = rng.uniform(0.02, 0.98, size=64).astype(np.float32)
    v_raw = rng.normal(size=(64, d - 1)).astype(np.float32)
    x = ps.sample_from_draws(torch.from_numpy(z01), torch.from_numpy(v_raw))
    want = jps.sample_from_draws(jnp.asarray(z01), jnp.asarray(v_raw))
    np.testing.assert_allclose(x.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(torch.linalg.vector_norm(x, dim=-1).numpy(), 1.0, atol=1e-5)
    # t = loc . x is the fed Beta draw's 2 z - 1
    np.testing.assert_allclose(np.sum(loc * x.numpy(), -1), 2 * z01 - 1, atol=1e-5)
    # log_prob at points off the mode (a fed sample) and at other unit vectors
    for pts in (x.numpy(), unit(rng, 64, d)):
        np.testing.assert_allclose(ps.log_prob(torch.from_numpy(pts)).numpy(),
                                   np.asarray(jps.log_prob(jnp.asarray(pts))),
                                   **cancel_tol(ps.scale, d))


def test_uniform_prior_and_normal_kl_match_jax():
    for dim in (2, 15):
        np.testing.assert_allclose(sphere.HypersphericalUniform(dim).entropy().item(),
                                   float(jsphere.HypersphericalUniform(dim).entropy()), **TOL)
    x = sphere.HypersphericalUniform(15).sample(torch.Generator().manual_seed(0), (100,))
    assert x.shape == (100, 16)
    np.testing.assert_allclose(torch.linalg.vector_norm(x, dim=-1).numpy(), 1.0, atol=1e-5)
    rng = np.random.default_rng(3)
    mean = rng.normal(size=(32, 16)).astype(np.float32)
    std = rng.uniform(0.1, 3.0, size=(32, 16)).astype(np.float32)
    np.testing.assert_allclose(
        sphere.normal_kl_standard(torch.from_numpy(mean), torch.from_numpy(std)).numpy(),
        np.asarray(jsphere.normal_kl_standard(jnp.asarray(mean), jnp.asarray(std))), **TOL)


@pytest.mark.parametrize("kappa", [1.5, 30.0])
def test_rsample_statistics_and_reparameterized_gradient(kappa):
    """N samples around one loc at d = 16: on the sphere, E[loc . x] and
    d E[loc . x] / d kappa (per-sample gradients through the Gamma draws)
    within their standard errors of the closed forms."""
    d = 16
    loc = torch.from_numpy(np.tile(unit(np.random.default_rng(1), 1, d), (N_STAT, 1)))
    scale = torch.full((N_STAT,), kappa, requires_grad=True)
    x = sphere.PowerSpherical(loc, scale).rsample(torch.Generator().manual_seed(7))
    assert x.shape == (N_STAT, d)
    assert float((torch.linalg.vector_norm(x.detach(), dim=-1) - 1).abs().max()) < 1e-5
    t = torch.sum(loc * x, dim=-1)
    beta = (d - 1) / 2.0
    mean, se = float(t.mean()), float(t.std()) / np.sqrt(N_STAT)
    assert abs(mean - kappa / (2 * beta + kappa)) < 4 * se, (mean, se)
    t.sum().backward()
    g = scale.grad.double()
    g_mean, g_se = float(g.mean()), float(g.std()) / np.sqrt(N_STAT)
    want = 2 * beta / (2 * beta + kappa) ** 2
    assert g_se > 0 and abs(g_mean - want) < 5 * g_se, (g_mean, want, g_se)


def test_rsample_is_the_generators_and_reaches_loc():
    loc = torch.from_numpy(unit(np.random.default_rng(2), 8, 16)).requires_grad_(True)
    scale = torch.full((8,), 4.0)
    ps = sphere.PowerSpherical(loc, scale)
    a = ps.rsample(torch.Generator().manual_seed(3))
    b = ps.rsample(torch.Generator().manual_seed(3))
    c = ps.rsample(torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    a.sum().backward()
    assert torch.isfinite(loc.grad).all() and float(loc.grad.abs().sum()) > 0
