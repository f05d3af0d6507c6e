"""K1, the fused eval-mode STSE encoder: the port's fold + plain version
against the JAX package's Pallas kernel in interpret mode, on the same
weights and inputs. Tolerance rtol=2e-4, atol=2e-5: fp32 reassociation
(the same as tests/test_fused_kernel.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coskad_tpu.kernels import fold_stse_params as jax_fold
from coskad_tpu.kernels import fused_stse_forward as jax_fused
from coskad_tpu.models import STSE as JaxSTSE
from coskad_tpu_torch.interop import state_from_jax_variables
from coskad_tpu_torch.kernels import stse_fused
from test_fused_kernel import _trained_like_variables

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-5)


def _both(model_kwargs, batch, block, seed_x, seed_vars):
    model = JaxSTSE(projector="linear", **model_kwargs)
    c, t, v = model_kwargs["input_dim"], model_kwargs["n_frames"], model_kwargs["n_joints"]
    x = np.random.default_rng(seed_x).normal(size=(batch, c, t, v)).astype(np.float32)
    variables = _trained_like_variables(model, jnp.asarray(x[:2]), seed=seed_vars)
    ref = jax_fused(jnp.asarray(x), jax_fold(variables["params"], variables["batch_stats"]),
                    block_b=block, interpret=True)
    folded = stse_fused.fold_stse_params(
        state_from_jax_variables(variables["params"], variables["batch_stats"]))
    return torch.from_numpy(x), folded, np.asarray(ref)


FULL = dict(input_dim=2, layer_channels=(32, 16, 32), hidden_dimension=64,
            latent_dim=16, n_frames=12, n_joints=17)


@pytest.mark.parametrize("batch,block", [(64, 32), (50, 32)])  # incl. ragged
def test_reference_matches_jax_fused_kernel(batch, block):
    x, folded, ref = _both(FULL, batch, block, seed_x=1, seed_vars=0)
    z = stse_fused.fused_stse_forward_reference(x, folded)
    np.testing.assert_allclose(z.numpy(), ref, **TOL)
    # The wrapper on a CPU tensor takes the same plain version.
    np.testing.assert_allclose(stse_fused.fused_stse_forward(x, folded).numpy(), ref, **TOL)


def test_identity_residual_layer():
    kw = dict(input_dim=8, layer_channels=(8,), hidden_dimension=8, latent_dim=4,
              n_frames=6, n_joints=5)
    x, folded, ref = _both(kw, 16, 16, seed_x=2, seed_vars=3)
    assert torch.equal(folded.layers[0].w_res, torch.eye(8))
    z = stse_fused.fused_stse_forward_reference(x, folded)
    np.testing.assert_allclose(z.numpy(), ref, **TOL)


def test_cpu_wrapper_does_not_count_launches():
    x, folded, _ = _both(FULL, 4, 4, seed_x=4, seed_vars=1)
    before = stse_fused.launches.value
    stse_fused.fused_stse_forward(x, folded)
    assert stse_fused.launches.value == before


def test_pack_layout_pads_to_multiples_of_four():
    """The kernel's packed layout: padded nodes/channels are zeros, every
    segment 16-byte aligned, b + b_res stored as one bias."""
    x, folded, _ = _both(FULL, 2, 2, seed_x=5, seed_vars=2)
    packed = stse_fused.pack_folded(folded)
    assert packed.n_nodes == 12 * 17 and packed.n_pad == 204
    w = packed.weights
    for row, lay in zip(packed.layout, folded.layers):
        ci, co, cip, cop, om, ow, owr, ob, oa = (int(v) for v in row)
        assert (cip, cop) == (-(-ci // 4) * 4, -(-co // 4) * 4)
        assert all(off % 4 == 0 for off in (om, ow, owr, ob, oa))
        m = w[om:om + packed.n_pad ** 2].reshape(packed.n_pad, packed.n_pad)
        assert torch.equal(m[:204, :204], lay.graph)
        wf = w[ow:ow + cip * cop].reshape(cip, cop)
        assert torch.equal(wf[:ci, :co], lay.w) and not wf[ci:].any()
        torch.testing.assert_close(w[ob:ob + co], lay.b + lay.b_res)
        assert float(w[oa]) == float(lay.alpha)


def test_work_counts_flagship_flops_and_bytes():
    x, folded, _ = _both(dict(FULL, n_joints=18), 2, 2, seed_x=6, seed_vars=0)
    flops, nbytes = stse_fused.work(folded, 2048)
    n = 216
    per_window = 2 * n * n * (2 + 16 + 16 + 32) + 4 * n * (2 * 32 + 32 * 16 + 16 * 32 + 32 * 64)
    assert flops == 2048 * per_window
    assert nbytes > 4 * 2048 * n * (2 + 64)
