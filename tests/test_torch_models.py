"""The port's STSE eval forward (plain module path, weights carried across by
`interop.load_jax_variables`) against flax `STSE.apply` on the same inputs.
Tolerance rtol=2e-4, atol=2e-5: fp32 reassociation."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coskad_tpu.models import STSE as JaxSTSE
from coskad_tpu_torch.interop import load_jax_variables
from coskad_tpu_torch.kernels import stse_fused
from coskad_tpu_torch.models import STSE, build_model
from test_fused_kernel import _trained_like_variables

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-5)

CASES = {
    "narrow_stack": dict(input_dim=2, layer_channels=(8, 4), hidden_dimension=8,
                         latent_dim=4, n_frames=12, n_joints=18),
    "identity_residual": dict(input_dim=8, layer_channels=(8,), hidden_dimension=8,
                              latent_dim=4, n_frames=6, n_joints=5),
    "no_bias": dict(input_dim=2, layer_channels=(4,), hidden_dimension=8, latent_dim=4,
                    n_frames=6, n_joints=5, use_bias=False),
}


def _pair(kwargs, batch=12, seed=0):
    jmodel = JaxSTSE(projector="linear", **kwargs)
    c, t, v = kwargs["input_dim"], kwargs["n_frames"], kwargs["n_joints"]
    x = np.random.default_rng(seed + 10).normal(size=(batch, c, t, v)).astype(np.float32)
    variables = _trained_like_variables(jmodel, jnp.asarray(x[:2]), seed=seed)
    model = STSE(**kwargs).eval()
    load_jax_variables(model, variables["params"], variables["batch_stats"])
    return jmodel, variables, model, x


@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_forward_matches_flax(case):
    jmodel, variables, model, x = _pair(CASES[case])
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        z = model(torch.from_numpy(x))
    assert z.shape == ref.shape
    np.testing.assert_allclose(z.numpy(), ref, **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_hidden_state_matches_flax_and_folded_path(case):
    """The (T, V, C) hidden state, and the fold the CUDA route uses."""
    jmodel, variables, model, x = _pair(CASES[case], seed=1)
    _, h_ref = jmodel.apply(variables, jnp.asarray(x), method=JaxSTSE.encode)
    with torch.no_grad():
        z, h = model.encode(torch.from_numpy(x))
        folded, _ = model.folded()
        h_fused = stse_fused.fused_stse_hidden_reference(torch.from_numpy(x), folded)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), **TOL)
    np.testing.assert_allclose(h_fused.reshape(h.shape).numpy(), h.numpy(), **TOL)


def test_fold_cache_follows_weight_updates():
    _, variables, model, x = _pair(CASES["narrow_stack"], seed=2)
    f1, p1 = model.folded()
    assert model.folded()[1] is p1  # unchanged weights: cached
    with torch.no_grad():
        model.encoder.layer_0.tcn_bn.var.mul_(2.0)
    f2, p2 = model.folded()
    assert p2 is not p1 and not torch.equal(f1.layers[0].w, f2.layers[0].w)


def test_load_rejects_mismatched_trees():
    _, variables, model, _ = _pair(CASES["narrow_stack"], seed=3)
    params = dict(variables["params"])
    params.pop("btlnk")
    with pytest.raises(ValueError, match="missing"):
        load_jax_variables(model, params, variables["batch_stats"])
    other = STSE(**dict(CASES["narrow_stack"], latent_dim=5))
    with pytest.raises(ValueError, match="shape"):
        load_jax_variables(other, variables["params"], variables["batch_stats"])


def test_train_mode_and_unported_variants_raise():
    """Train mode runs (tests/test_torch_train.py holds it to flax); dropout
    in train mode and the other variants are not ported yet."""
    model = STSE(**CASES["narrow_stack"])
    x = torch.zeros(2, 2, 12, 18)
    assert model(x, train=True).shape == (2, 4)
    with pytest.raises(NotImplementedError, match="dropout"):
        STSE(**CASES["narrow_stack"], dropout=0.1)(x, train=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(use_vae=True, **CASES["narrow_stack"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        STSE(projector="mlp")
