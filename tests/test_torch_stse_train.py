"""K2-K4, the ghost-BN train-mode encoder: the port's plain versions and its
`FusedGhostEncode` against the JAX package's Pallas kernels in interpret
mode (and their pure-jnp spec), on the same weights and inputs.

Tolerances are tests/test_fused_train_kernel.py's: forward, sums and block
statistics rtol=2e-4, atol=2e-4; gradients err < 1e-3 * max(scale, 1) +
1e-6 (fp32 reassociation through the BN backward's 1/cnt cancellations)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coskad_tpu.kernels import stse_train as K
from coskad_tpu.models import STSE as JaxSTSE
from coskad_tpu_torch.interop import flatten_tree, load_jax_variables, to_jax_variables
from coskad_tpu_torch.kernels import stse_train
from coskad_tpu_torch.models import STSE

torch.set_num_threads(1)

FWD_TOL = dict(rtol=2e-4, atol=2e-4)

# The flagship's 12 x 18 = 216 nodes: the Pallas kernel pads nodes to 256
# and takes the pads' constant out of its sums afterwards, which cancels
# more digits the fewer nodes are real (30 nodes cost it ~4e-4 on a few
# activations). The widths are narrow.
CASES = {
    # 2 -> 8 -> 4 -> 8 -> 16: widening, narrowing and widening layers
    "narrow": dict(input_dim=2, layer_channels=(8, 4, 8), hidden_dimension=16, latent_dim=4,
                   n_frames=12, n_joints=18, batch=32, ghost=8),
    # 4 -> 8, then two identity residuals 8 -> 8
    "identity": dict(input_dim=4, layer_channels=(8, 8), hidden_dimension=8, latent_dim=3,
                     n_frames=12, n_joints=18, batch=16, ghost=8),
}


def jax_variables(model, x, seed):
    """Init, then BN affines away from (1, 0), PReLU slopes away from 0.25
    and non-trivial running statistics."""
    variables = model.init(jax.random.PRNGKey(seed), x)
    rng = np.random.default_rng(seed)
    ranges = dict(scale=(0.5, 1.5), mean=(-0.5, 0.5), var=(0.5, 2.0), alpha=(0.1, 0.4))

    def jitter(path, v):
        keys = [getattr(p, "key", "") for p in path]
        name = keys[-1]
        if name == "bias" and keys[-2].endswith("_bn"):
            return jnp.asarray(rng.uniform(-0.3, 0.3, np.shape(v)), jnp.float32)
        if name in ranges:
            return jnp.asarray(rng.uniform(*ranges[name], np.shape(v)), jnp.float32)
        return v

    return {k: jax.tree_util.tree_map_with_path(jitter, v) for k, v in variables.items()}


def pair(case, seed=0):
    kw = dict(CASES[case])
    batch, ghost = kw.pop("batch"), kw.pop("ghost")
    jmodel = JaxSTSE(projector="linear", bn_mode="flax", **kw)
    x = np.random.default_rng(seed + 7).normal(
        size=(batch, kw["input_dim"], kw["n_frames"], kw["n_joints"])).astype(np.float32)
    variables = jax_variables(jmodel, jnp.asarray(x[:2]), seed)
    model = STSE(**kw)
    load_jax_variables(model, variables["params"], variables["batch_stats"])
    return jmodel, variables, model, x, ghost


def close_grad(got, want, name):
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err < 1e-3 * max(scale, 1.0) + 1e-6, (name, err, scale)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_forward_matches_pallas_interpret(case):
    """K2's plain version against `_fwd_pallas(..., interpret=True,
    save_acts=True)`: [C, B, 256] maps to [B, N, C], (8 n_blocks, C) stat
    rows to [n_blocks, C]."""
    _, variables, model, x, ghost = pair(case)
    b, c, t, v = x.shape
    n = t * v
    params = variables["params"]
    res_identity = K.has_identity_residual(params)
    x_t = jnp.pad(jnp.transpose(jnp.asarray(x).reshape(b, c, n), (1, 0, 2)),
                  ((0, 0), (0, 0), (0, K.N_PAD - n)))
    z_j, sums_j, acts_j, stats_j = K._fwd_pallas(
        x_t, K.encoder_ops_from_tree(params, n), n, ghost, res_identity, interpret=True,
        save_acts=True)
    ops = stse_train.encoder_ops(model)
    x_nodes = torch.from_numpy(x).permute(0, 2, 3, 1).reshape(b, n, c)
    with torch.no_grad():
        z, sums, acts, stats = stse_train.ghost_forward(x_nodes, ops, ghost)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), **FWD_TOL)
    for l, ident in enumerate(res_identity):
        act = np.transpose(np.asarray(acts_j[l])[:, :, :n], (1, 2, 0))
        np.testing.assert_allclose(acts[l].numpy(), act, **FWD_TOL)
        st = np.stack([np.asarray(s)[::8] for s in stats_j[l]], axis=1)
        np.testing.assert_allclose(stats[l].numpy(), st, **FWD_TOL)
        # The Pallas kernel writes zero residual sums for an identity
        # residual (no BN there to update); the port sums r = x like the
        # jnp spec. Both leave an identity layer's statistics alone.
        k = 2 if ident else 4
        np.testing.assert_allclose(sums[l][:k].numpy(),
                                   np.stack([np.asarray(s)[:, 0] for s in sums_j[l]])[:k],
                                   **FWD_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_ghost_reference_matches_jax_spec(case):
    _, variables, model, x, ghost = pair(case, seed=1)
    z_j, sums_j = K.ghost_encode_reference(variables["params"], jnp.asarray(x), ghost)
    with torch.no_grad():
        z, sums = stse_train.ghost_encode_reference(
            stse_train.encoder_ops(model), torch.from_numpy(x), ghost)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), **FWD_TOL)
    for s, sj in zip(sums, sums_j):
        assert s["count"] == float(sj["count"])
        for key in ("tcn_sum", "tcn_sumsq", "res_sum", "res_sumsq"):
            np.testing.assert_allclose(s[key].numpy(), np.asarray(sj[key]), **FWD_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_jax_split_backward(case):
    """Parameter gradients through FusedGhostEncode (plain K2, autograd K3
    and K4 on the CPU) against jax.grad of fused_stse_apply(interpret=True,
    bwd_mode='split'), by flax path."""
    _, variables, model, x, ghost = pair(case, seed=2)
    latent = CASES[case]["latent_dim"]
    center = np.random.default_rng(5).normal(size=(latent,)).astype(np.float32)

    def loss_j(p):
        z, _ = K.fused_stse_apply(p, variables["batch_stats"], jnp.asarray(x),
                                  ghost_size=ghost, interpret=True, bwd_mode="split")
        return jnp.mean((z - center) ** 2)

    l_j, g_j = jax.value_and_grad(loss_j)(variables["params"])
    z = stse_train.fused_stse_apply(model, torch.from_numpy(x), ghost_size=ghost)
    loss = torch.mean((z - torch.from_numpy(center)) ** 2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(l_j), rtol=1e-5)
    want = flatten_tree(g_j)
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for k in want:
        close_grad(got[k], want[k], k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_running_stats_update_matches_jax(case):
    _, variables, model, x, ghost = pair(case, seed=3)
    _, new_j = K.fused_stse_apply(variables["params"], variables["batch_stats"],
                                  jnp.asarray(x), ghost_size=ghost, impl="reference")
    with torch.no_grad():
        stse_train.fused_stse_apply(model, torch.from_numpy(x), ghost_size=ghost)
    _, stats = to_jax_variables(model)
    want = flatten_tree(jax.device_get(new_j))
    got = flatten_tree(stats)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **FWD_TOL, err_msg=k)


def test_ghost_of_whole_batch_is_live_batchnorm():
    """ghost_size == B is the module path's live BatchNorm: the same
    latents, gradients and running statistics."""
    _, _, model, x, _ = pair("narrow", seed=4)
    live = STSE(**{k: v for k, v in CASES["narrow"].items() if k not in ("batch", "ghost")})
    live.load_state_dict(model.state_dict())
    xt = torch.from_numpy(x)
    z_g = stse_train.fused_stse_apply(model, xt, ghost_size=x.shape[0])
    z_l = live(xt, train=True)
    torch.testing.assert_close(z_g, z_l, **FWD_TOL)
    (z_g ** 2).mean().backward()
    (z_l ** 2).mean().backward()
    for (name, p), q in zip(model.named_parameters(), live.parameters()):
        close_grad(p.grad.numpy(), q.grad.numpy(), name)
    for (name, a), b in zip(model.named_buffers(), live.buffers()):
        torch.testing.assert_close(a, b, **FWD_TOL, msg=name)


def test_unported_modes_raise_and_cpu_launches_nothing():
    _, _, model, x, ghost = pair("narrow", seed=5)
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="compute_dtype 'float16'"):
        stse_train.fused_stse_apply(model, xt, ghost_size=ghost, compute_dtype="float16")
    with pytest.raises(ValueError, match="multiple of ghost_size"):
        stse_train.fused_stse_apply(model, xt[:12], ghost_size=ghost)
    with pytest.raises(ValueError, match="bwd_mode"):
        stse_train.fused_stse_apply(model, xt, ghost_size=ghost, bwd_mode="both")
    counters = (stse_train.forward_launches, stse_train.layer_backward_launches,
                stse_train.top_backward_launches, stse_train.mono_backward_launches)
    before = [c.value for c in counters]
    for mode in ("split", "mono"):
        stse_train.fused_stse_apply(model, xt, ghost_size=ghost, bwd_mode=mode).sum().backward()
    assert [c.value for c in counters] == before


def test_work_counts_flagship_flops():
    model = STSE(input_dim=2, layer_channels=(32, 16, 32), hidden_dimension=64,
                 latent_dim=16, n_frames=12, n_joints=18)
    w = stse_train.work(stse_train.encoder_ops(model), 2048, 64)
    n = 216
    graph = 2 * n * n * (2 + 32 + 16 + 32)
    dense = 2 * n * 2 * (2 * 32 + 32 * 16 + 16 * 32 + 32 * 64)
    assert w["K2"][0] == 2048 * (graph + dense + 2 * n * 64 * 16)
    assert set(w) == {"K2", "K3_layer0", "K3_layer1", "K3_layer2", "K4", "K5"}
    # K4: the graph contraction three times on 32 channels, six dense
    # products, the projector backward twice
    mm = 2 * n * 32 * 64
    assert w["K4"][0] == 2048 * (3 * 2 * n * n * 32 + 6 * mm + 2 * 2 * n * 64 * 16)
    # K5 (the mono backward): every layer's forward once (g, t, r), then its
    # backward and the projector's; with dx (the graph contraction three
    # times, six dense products) except on layer 0 (twice, five). The
    # function of K4 then K3 down the stack, so the same count.
    k5 = (2 * 2 * n * n * 2 + 2 * n * 2 * 32 * 5
          + sum(3 * 2 * n * n * ci + 2 * n * ci * co * 6 for ci, co in
                ((32, 16), (16, 32), (32, 64))) + 2 * 2 * n * 64 * 16)
    assert w["K5"][0] == 2048 * k5
    assert w["K5"][0] == sum(w[k][0] for k in w if k.startswith(("K3", "K4")))
    # the batch-reduction products' share: dW and dW_res a layer, dM a layer,
    # dwp in K4; K5 runs all of them, K2 none
    rows = 2048 * n
    assert w["K3_layer1"][2] == 2 * 2 * rows * 32 * 16 + 2 * n * n * 2048 * 32
    assert w["K4"][2] == 2 * 2 * rows * 32 * 64 + 2 * n * n * 2048 * 32 + 2 * 2048 * n * 64 * 16
    assert w["K2"][2] == 0 and w["K5"][2] == sum(w[k][2] for k in w if k != "K5")
    # the per-window passes' share, on the tensor cores: the rest of each
    # backward's FLOPs, and all of K2's (g, t, r and the projector)
    assert w["K4"][3] == 2048 * (2 * 2 * n * n * 32 + 4 * mm + 2 * n * 64 * 16)
    for k in ("K2", "K3_layer0", "K3_layer1", "K3_layer2", "K4", "K5"):
        assert w[k][2] + w[k][3] == w[k][0]
    assert w["K5"][3] == sum(w[k][3] for k in w if k not in ("K2", "K5"))
