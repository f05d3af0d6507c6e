"""The MLP projector: the port's `MLPHead` and `STSE(projector="mlp")`
against flax's `MLPHead` and `STSE`, from the same weights (carried across
by `interop`), on the same seeded inputs.

Tolerances: forwards and running statistics rtol=2e-4, atol=2e-5 (fp32
reassociation); gradients err < 1e-3 * max(scale, 1) + 1e-6 (the train
slice's gradient band, tests/test_torch_stse_train.py); the regularizer
rtol 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coskad_tpu import config as jconfig
from coskad_tpu.models import STSE as JaxSTSE
from coskad_tpu.models.stsgcn import MLPHead as JaxMLPHead
from coskad_tpu.train import objectives as jobjectives
from coskad_tpu_torch.data.windows import SegmentDataset
from coskad_tpu_torch.interop import flatten_tree, load_jax_variables, to_jax_variables
from coskad_tpu_torch.kernels import stse_fused
from coskad_tpu_torch.models import STSE
from coskad_tpu_torch.models.stsgcn import MLPHead
from coskad_tpu_torch.train import objectives
from coskad_tpu_torch.train.loop import Trainer
from test_torch_stse_train import close_grad
from test_torch_train import port_config

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-5)
# the paper's layer schedule at a narrow width, 17 joints
NARROW = dict(input_dim=2, layer_channels=(8, 4, 8), hidden_dimension=8, latent_dim=4,
              n_frames=6, n_joints=17)


def jittered(variables, seed):
    """BatchNorm affines away from (1, 0), PReLU slopes away from 0.25 and
    non-trivial running statistics, in every BatchNorm of the tree (the
    encoder's `*_bn` and the head's `bn_i`)."""
    rng = np.random.default_rng(seed)
    ranges = dict(scale=(0.5, 1.5), mean=(-0.5, 0.5), var=(0.5, 2.0), alpha=(0.1, 0.4))

    def jitter(path, v):
        keys = [getattr(p, "key", "") for p in path]
        name, owner = keys[-1], keys[-2] if len(keys) > 1 else ""
        is_bn = owner.endswith("_bn") or owner.startswith("bn_")
        if name == "bias" and is_bn:
            return jnp.asarray(rng.uniform(-0.3, 0.3, np.shape(v)), jnp.float32)
        if name in ranges:
            return jnp.asarray(rng.uniform(*ranges[name], np.shape(v)), jnp.float32)
        return v

    return {k: jax.tree_util.tree_map_with_path(jitter, v) for k, v in variables.items()}


def head_pair(hidden=(6, 5), fan_in=12, out=3, batch=16, seed=0):
    jhead = JaxMLPHead(hidden_layers=hidden, output_size=out)
    x = np.random.default_rng(seed + 3).normal(size=(batch, fan_in)).astype(np.float32)
    variables = jittered(jhead.init(jax.random.PRNGKey(seed), jnp.asarray(x[:2])), seed)
    head = MLPHead(fan_in, hidden, out)
    load_jax_variables(head, variables["params"], variables["batch_stats"])
    return jhead, variables, head, x


def stse_pair(kw=NARROW, batch=16, seed=0, **extra):
    jmodel = JaxSTSE(projector="mlp", **kw, **extra)
    x = np.random.default_rng(seed + 11).normal(
        size=(batch, kw["input_dim"], kw["n_frames"], kw["n_joints"])).astype(np.float32)
    variables = jittered(jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(x[:2])), seed)
    model = STSE(projector="mlp", **kw, **extra)
    load_jax_variables(model, variables["params"], variables["batch_stats"])
    return jmodel, variables, model, x


def assert_stats_match(model, batch_stats):
    want = flatten_tree(jax.device_get(batch_stats))
    got = flatten_tree(to_jax_variables(model)[1])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)


@pytest.mark.parametrize("hidden", [(6,), (6, 5)], ids=["one_hidden", "two_hidden"])
def test_head_eval_and_train_match_flax(hidden):
    """Eval from running statistics; a train step with the batch's
    statistics, the running ones after it, and the gradients."""
    jhead, variables, head, x = head_pair(hidden)
    names = sorted(flatten_tree(variables["params"])) + sorted(
        flatten_tree(variables["batch_stats"]))
    assert sorted(head.state_dict()) == sorted(names)
    np.testing.assert_allclose(head(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jhead.apply(variables, jnp.asarray(x))), **TOL)

    y_j, mutated = jhead.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    y = head(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **TOL)
    assert_stats_match(head, mutated["batch_stats"])

    def loss_j(p):
        out, _ = jhead.apply({"params": p, "batch_stats": variables["batch_stats"]},
                             jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.mean(out ** 2)

    g_j = flatten_tree(jax.grad(loss_j)(variables["params"]))
    torch.mean(y ** 2).backward()
    for k, p in head.named_parameters():
        close_grad(p.grad.numpy(), g_j[k], k)


def test_stse_mlp_eval_on_the_plain_route_matches_flax():
    jmodel, variables, model, x = stse_pair(seed=1)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        z = model(torch.from_numpy(x))
        # the CUDA route's composition: the encoder folded alone (no
        # btlnk.kernel in an MLP tree), then the head in eval mode
        folded, packed = model.folded()
        h = stse_fused.fused_stse_hidden(torch.from_numpy(x), folded, packed)
        z_k1 = model._project(h, train=False)
    np.testing.assert_allclose(z.numpy(), want, **TOL)
    np.testing.assert_allclose(z_k1.numpy(), want, **TOL)
    assert folded.w_proj is None and folded.b_proj is None
    with pytest.raises(ValueError, match="no linear projector"):
        stse_fused.fused_stse_forward(torch.from_numpy(x), folded, packed)


@pytest.mark.parametrize("frozen_bn", [False, True], ids=["live_bn", "frozen_encoder_bn"])
def test_stse_mlp_train_forward_matches_flax(frozen_bn):
    """The train forward with live BatchNorm (encoder and head), or with the
    encoder's running statistics under frozen_bn, where the head's BatchNorm
    stays live as in JAX: latents, every running statistic after the step,
    and the gradients."""
    jmodel, variables, model, x = stse_pair(seed=2)
    z_j, mutated = jmodel.apply(variables, jnp.asarray(x), train=True, frozen_bn=frozen_bn,
                                mutable=["batch_stats"])
    model.train()
    z = model(torch.from_numpy(x), train=True, frozen_bn=frozen_bn)
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(z_j), **TOL)
    assert_stats_match(model, mutated["batch_stats"])
    if frozen_bn:
        before = flatten_tree(jax.device_get(variables["batch_stats"]))
        after = flatten_tree(to_jax_variables(model)[1])
        assert all(np.array_equal(after[k], before[k]) for k in after if k.startswith("encoder"))
        assert not np.array_equal(after["btlnk.bn_0.mean"], before["btlnk.bn_0.mean"])

    def loss_j(p):
        out, _ = jmodel.apply({"params": p, "batch_stats": variables["batch_stats"]},
                              jnp.asarray(x), train=True, frozen_bn=frozen_bn,
                              mutable=["batch_stats"])
        return jnp.mean(out ** 2)

    g_j = flatten_tree(jax.grad(loss_j)(variables["params"]))
    torch.mean(z ** 2).backward()
    for k, p in model.named_parameters():
        close_grad(p.grad.numpy(), g_j[k], k)


def test_mlp_tree_carries_both_ways_and_refolds_on_head_statistics():
    """The port's tree is flax's (btlnk/{hidden_0, bn_0, out}, batch_stats
    btlnk/bn_0), the scale mapped by name; K1's fold cache is keyed on the
    head's BatchNorm statistics too."""
    jmodel, variables, model, x = stse_pair(seed=3)
    params, stats = to_jax_variables(model)
    assert sorted(params["btlnk"]) == ["bn_0", "hidden_0", "out"]
    assert sorted(params["btlnk"]["bn_0"]) == ["bias", "scale"]
    assert sorted(stats["btlnk"]["bn_0"]) == ["mean", "var"]
    for tree, want in ((params, variables["params"]), (stats, variables["batch_stats"])):
        got_flat, want_flat = flatten_tree(tree), flatten_tree(jax.device_get(want))
        assert sorted(got_flat) == sorted(want_flat)
        for k in want_flat:
            np.testing.assert_array_equal(got_flat[k], want_flat[k], err_msg=k)
    # scale and bias of the head's BatchNorm are not interchangeable
    assert not np.array_equal(params["btlnk"]["bn_0"]["scale"], params["btlnk"]["bn_0"]["bias"])

    _, packed = model.folded()
    assert model.folded()[1] is packed
    with torch.no_grad():
        model.btlnk.bn_0.mean.add_(0.1)
    assert model.folded()[1] is not packed


def test_reg_loss_counts_the_heads_tensors_as_jax_does():
    """hidden_0.kernel, bn_0.scale and out.kernel enter the regularizer's
    mean; 28 encoder tensors + 3 at the paper's width."""
    paper = dict(input_dim=2, layer_channels=(32, 16, 32), hidden_dimension=64,
                 latent_dim=16, n_frames=12, n_joints=17)
    model = STSE(projector="mlp", **paper)
    counted = [k for k, _ in model.named_parameters() if not k.endswith(".bias")]
    assert len(counted) == 31
    assert {"btlnk.hidden_0.kernel", "btlnk.bn_0.scale", "btlnk.out.kernel"} <= set(counted)
    assert model.btlnk.hidden_0.kernel.shape == (13056, 16)

    _, variables, model, _ = stse_pair(seed=4)
    want = float(jobjectives.reg_loss(variables["params"]))
    np.testing.assert_allclose(objectives.reg_loss(model).item(), want, rtol=1e-5)


def test_fused_train_on_refuses_the_mlp_projector():
    """As in JAX: 'on' raises, 'auto' trains on the module path."""
    rng = np.random.default_rng(5)
    ds = SegmentDataset(rng.normal(size=(8, 3, 6, 5)).astype(np.float32),
                        np.ones((8, 4), np.int64), np.ones((8, 6), np.int32), num_transform=1)
    jcfg = jconfig.Config(
        model=jconfig.ModelConfig(variant="hyperbolic", channels=(4,), h_dim=4, latent_dim=2,
                                  projector="mlp"),
        data=jconfig.DataConfig(seg_len=6, n_joints_override=5, batch_size=8, num_transform=1),
        run=jconfig.RunConfig(fused_train="auto", ghost_size=4))
    assert not Trainer(port_config(jcfg), ds, device="cpu")._fused_compat
    on = dataclasses.replace(jcfg, run=dataclasses.replace(jcfg.run, fused_train="on"))
    with pytest.raises(ValueError, match="fused_train='on'"):
        Trainer(port_config(on), ds, device="cpu")
