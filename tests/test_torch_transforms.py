"""gather_batch and the affine transforms: the port against the JAX package on
the same flat rows and indices. Tolerance: exact up to 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coskad_tpu.data import transforms as jt
from coskad_tpu_torch.data import transforms as tt

torch.set_num_threads(1)


def test_canonical_table_is_the_same():
    np.testing.assert_array_equal(tt.canonical_transforms(5), jt.canonical_transforms(5))
    np.testing.assert_array_equal(tt.canonical_transforms(2), jt.canonical_transforms(2))


@pytest.mark.parametrize("num_coords", [2, 3])
@pytest.mark.parametrize("flat", [True, False])
def test_gather_batch_matches_jax(num_coords, flat):
    rng = np.random.default_rng(num_coords)
    n, shape = 7, (3, 12, 18)  # x, y, confidence
    data = rng.normal(size=(n,) + shape).astype(np.float32)
    indices = rng.integers(0, 5 * n, size=40)  # every transform, indices >= N
    assert (indices >= n).any() and (indices // n == 4).any()
    table = tt.canonical_transforms(5)
    src = data.reshape(n, -1) if flat else data
    ws = shape if flat else None
    ref = jt.gather_batch(jnp.asarray(src), jnp.asarray(indices), jnp.asarray(table),
                          num_coords, window_shape=ws)
    out = tt.gather_batch(torch.from_numpy(src), torch.from_numpy(indices),
                          torch.from_numpy(table), num_coords, window_shape=ws)
    assert out.shape == (40, num_coords, 12, 18)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize("k", range(5))
def test_each_transform_matches_jax(k):
    rng = np.random.default_rng(10 + k)
    pose = rng.normal(size=(4, 3, 6, 5)).astype(np.float32)
    mats = np.repeat(jt.canonical_transforms(5)[k][None], 4, axis=0)
    ref = jt.apply_transforms(jnp.asarray(pose), jnp.asarray(mats))
    out = tt.apply_transforms(torch.from_numpy(pose), torch.from_numpy(mats))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(out[:, 2].numpy(), pose[:, 2])  # confidence untouched
