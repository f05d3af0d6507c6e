"""The training slice: the port's train-mode model, objectives and Trainer
against the JAX package's, from the same initial weights (carried across by
`interop`) and the same index stream.

Tolerances: the train forward and its running statistics rtol=2e-4,
atol=2e-5 (fp32 reassociation); gradients err < 1e-3 * max(scale, 1) + 1e-6
(tests/test_fused_train_kernel.py); losses rtol=1e-5. The lockstep `fit`
uses the JAX lockstep test's early bands (tests/test_lockstep_parity.py:538):
per-step losses under Adam rtol 1e-3, parameters under SGD rtol 3e-4 (Adam
amplifies the noise of the pre-BN biases' analytically zero gradient to
+-lr, SGD does not)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from coskad_tpu import config as jconfig
from coskad_tpu.data.windows import SegmentDataset as JaxSegmentDataset
from coskad_tpu.models import STSE as JaxSTSE
from coskad_tpu.parallel import create_mesh
from coskad_tpu.train import objectives as jobjectives
from coskad_tpu.train.loop import Trainer as JaxTrainer
from coskad_tpu.utils.logging import MetricLogger as JaxLogger
from coskad_tpu_torch import config as tconfig
from coskad_tpu_torch.data.windows import SegmentDataset
from coskad_tpu_torch.interop import flatten_tree, load_jax_variables, to_jax_variables
from coskad_tpu_torch.models import STSE
from coskad_tpu_torch.train import objectives
from coskad_tpu_torch.train.loop import Trainer
from coskad_tpu_torch.utils.logging import MetricLogger
from test_torch_stse_train import close_grad, jax_variables

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-5)
NARROW = dict(input_dim=2, layer_channels=(8, 4, 8), hidden_dimension=16, latent_dim=4,
              n_frames=6, n_joints=5)
IDENTITY = dict(input_dim=4, layer_channels=(8, 8), hidden_dimension=8, latent_dim=3,
                n_frames=6, n_joints=5)


def pair(kw, batch=32, seed=0):
    jmodel = JaxSTSE(projector="linear", **kw)
    x = np.random.default_rng(seed + 11).normal(
        size=(batch, kw["input_dim"], kw["n_frames"], kw["n_joints"])).astype(np.float32)
    variables = jax_variables(jmodel, jnp.asarray(x[:2]), seed)
    model = STSE(**kw)
    load_jax_variables(model, variables["params"], variables["batch_stats"])
    return jmodel, variables, model, x


@pytest.mark.parametrize("kw", [NARROW, IDENTITY], ids=["narrow", "identity"])
def test_live_bn_train_forward_matches_flax(kw):
    jmodel, variables, model, x = pair(kw)
    z_j, mutated = jmodel.apply(variables, jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
    model.train()
    z = model(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(z_j), **TOL)
    want = flatten_tree(jax.device_get(mutated["batch_stats"]))
    got = flatten_tree(to_jax_variables(model)[1])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)

    def loss_j(p):
        out, _ = jmodel.apply({"params": p, "batch_stats": variables["batch_stats"]},
                              jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.mean(out ** 2)

    g_j = flatten_tree(jax.grad(loss_j)(variables["params"]))
    torch.mean(z ** 2).backward()
    for k, p in model.named_parameters():
        close_grad(p.grad.numpy(), g_j[k], k)


def test_frozen_bn_trains_through_the_folded_affine():
    jmodel, variables, model, x = pair(NARROW, seed=1)

    def loss_j(p):
        out = jmodel.apply({"params": p, "batch_stats": variables["batch_stats"]},
                           jnp.asarray(x), train=True, frozen_bn=True)
        return jnp.mean(out ** 2), out

    (_, z_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(variables["params"])
    before = {k: b.clone() for k, b in model.named_buffers()}
    z = model(torch.from_numpy(x), train=True, frozen_bn=True)
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(z_j), **TOL)
    torch.mean(z ** 2).backward()
    g_j = flatten_tree(g_j)
    for k, p in model.named_parameters():
        close_grad(p.grad.numpy(), g_j[k], k)
    for k, b in model.named_buffers():
        assert torch.equal(b, before[k]), f"{k} changed under frozen_bn"


def test_reg_loss_counts_the_flagships_non_bias_parameters():
    model = STSE(input_dim=2, layer_channels=(32, 16, 32), hidden_dimension=64,
                 latent_dim=16, n_frames=12, n_joints=18)
    counted = [k for k, _ in model.named_parameters() if not k.endswith(".bias")]
    assert len(counted) == 29
    want = sum(0.5 * float(torch.sum(p.detach().double() ** 2))
               for k, p in model.named_parameters() if k in counted) / 29
    assert abs(objectives.reg_loss(model).item() - want) <= 1e-6 * want


@pytest.mark.parametrize("distance", ["euclidean", "mahalanobis"])
def test_compute_loss_matches_jax(distance):
    jmodel, variables, model, x = pair(NARROW, seed=2)
    rng = np.random.default_rng(3)
    z = rng.normal(size=(32, 4)).astype(np.float32)
    center = rng.normal(size=(4,)).astype(np.float32)
    a = rng.normal(size=(4, 4))
    inv_cov = (a @ a.T + 4 * np.eye(4)).astype(np.float32)
    cfg = jconfig.Config(model=jconfig.ModelConfig(variant="euclidean_dynamic",
                                                   distance=distance))
    loss_j, metrics_j = jobjectives.compute_loss(
        cfg, jnp.asarray(z), jnp.asarray(x), variables["params"], jnp.asarray(center),
        jnp.asarray(inv_cov))
    loss, metrics = objectives.compute_loss(
        port_config(cfg), torch.from_numpy(z), torch.from_numpy(x), model,
        torch.from_numpy(center), torch.from_numpy(inv_cov))
    assert sorted(metrics) == sorted(metrics_j)
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(metrics_j[k]), rtol=1e-5)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    # the hyperbolic loss is ported (tests/test_torch_hyperbolic.py); the VAE's
    # waits for its variant
    with pytest.raises(NotImplementedError, match="Queue 1 item 3a"):
        objectives.compute_loss(port_config(dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, variant="vae"))),
            torch.from_numpy(z), torch.from_numpy(x), model, torch.from_numpy(center),
            torch.from_numpy(inv_cov))


def test_k1_fold_cache_refolds_after_an_optimizer_step_and_a_bn_update():
    _, _, model, x = pair(NARROW, seed=4)
    _, packed = model.folded()
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    model.train()
    loss = torch.mean(model(torch.from_numpy(x), train=True) ** 2)  # BN buffers move
    _, p_bn = model.folded()
    assert p_bn is not packed
    loss.backward()
    opt.step()
    _, p_step = model.folded()
    assert p_step is not p_bn and not torch.equal(p_step.weights, p_bn.weights)
    assert model.folded()[1] is p_step


# ---------------------------------------------------------------- lockstep


def port_config(cfg):
    """The JAX Config, field for field, as the port's Config."""
    return tconfig.Config(
        model=tconfig.ModelConfig(**dataclasses.asdict(cfg.model)),
        data=tconfig.DataConfig(**dataclasses.asdict(cfg.data)),
        opt=tconfig.OptConfig(**dataclasses.asdict(cfg.opt)),
        eval=tconfig.EvalConfig(**dataclasses.asdict(cfg.eval)),
        run=tconfig.RunConfig(**dataclasses.asdict(cfg.run)),
    )


def _capturing(base):
    class Capture(base):
        def __init__(self):
            super().__init__(every_n_steps=1)
            self.losses = []

        def log(self, metrics, step, force=False):
            if "loss" in metrics:
                self.losses.append(float(metrics["loss"]))

    return Capture()


@pytest.mark.parametrize("fused_train,optimizer", [("off", "adam"), ("on", "adam"),
                                                   ("on", "sgd")])
def test_lockstep_fit_matches_jax_trainer(fused_train, optimizer):
    """Two epochs of Trainer.fit on both sides (euclidean_dynamic, 4 steps
    an epoch, ghost 8 when fused): the per-step losses, the center after each
    epoch and, under SGD, the parameters."""
    rng = np.random.default_rng(0)
    n_win = 64
    data = rng.normal(size=(n_win, 3, 6, 5)).astype(np.float32)
    meta = np.tile([1, 1, 1, 1], (n_win, 1)).astype(np.int64)
    fids = np.tile(np.arange(1, 7), (n_win, 1)).astype(np.int32)
    lr = 1e-3 if optimizer == "adam" else 0.05
    cfg = jconfig.Config(
        model=jconfig.ModelConfig(variant="euclidean_dynamic", channels=(8, 4), h_dim=8,
                                  latent_dim=4),
        data=jconfig.DataConfig(seg_len=6, n_joints_override=5, batch_size=32,
                                num_transform=2),
        opt=jconfig.OptConfig(lr=lr, epochs=2),
        run=jconfig.RunConfig(fused_train=fused_train, ghost_size=8),
    )
    jlog = _capturing(JaxLogger)
    jtrainer = JaxTrainer(cfg, JaxSegmentDataset(data, meta, fids, num_transform=2),
                          mesh=create_mesh(1, 1, devices=jax.devices()[:1]), logger=jlog)
    if optimizer == "sgd":
        jtrainer.tx = optax.sgd(lr)
    jstate = jtrainer.initialize_center(jtrainer.init_state())

    log = _capturing(MetricLogger)
    trainer = Trainer(port_config(cfg), SegmentDataset(data, meta, fids, num_transform=2),
                      device="cpu", logger=log)
    params0 = jax.device_get(jstate.params)
    load_jax_variables(trainer.model, params0, jax.device_get(jstate.batch_stats))
    if optimizer == "sgd":
        trainer.optimizer = torch.optim.SGD(trainer.model.parameters(), lr=lr)
    state = trainer.init_state().replace(center=torch.from_numpy(np.array(jstate.center)))
    assert trainer._fused_compat == (fused_train == "on")

    for epoch in range(2):
        jstate, jhist = jtrainer.fit(jstate, epochs=1)
        state, hist = trainer.fit(state, epochs=1)
        np.testing.assert_allclose(state.center.numpy(), np.asarray(jstate.center),
                                   rtol=1e-3, atol=1e-6, err_msg=f"center after epoch {epoch}")
    assert state.step == int(jstate.step) == 8
    assert len(log.losses) == len(jlog.losses) == 8
    np.testing.assert_allclose(log.losses, jlog.losses, rtol=3e-4 if optimizer == "sgd" else 1e-3)
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=1e-3)
    if optimizer == "sgd":
        want = flatten_tree(jax.device_get(jstate.params))
        got = flatten_tree(to_jax_variables(trainer.model)[0])
        moved = flatten_tree(params0)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=3e-4, atol=1e-6, err_msg=k)
            # the update itself, not just the weights it moved
            close_grad(got[k] - moved[k], want[k] - moved[k], k)
        want_bs = flatten_tree(jax.device_get(jstate.batch_stats))
        got_bs = flatten_tree(to_jax_variables(trainer.model)[1])
        for k in want_bs:
            np.testing.assert_allclose(got_bs[k], want_bs[k], rtol=1e-3, atol=1e-5, err_msg=k)


def test_fused_gate_and_unported_options():
    rng = np.random.default_rng(1)
    ds = SegmentDataset(rng.normal(size=(8, 3, 6, 5)).astype(np.float32),
                        np.ones((8, 4), np.int64), np.ones((8, 6), np.int32), num_transform=1)
    base = tconfig.Config(model=tconfig.ModelConfig(channels=(4,), h_dim=4, latent_dim=2),
                          data=tconfig.DataConfig(seg_len=6, n_joints_override=5, batch_size=8,
                                                  num_transform=1),
                          run=tconfig.RunConfig(fused_train="auto", ghost_size=4))
    assert Trainer(base, ds, device="cpu")._fused_compat
    drop = dataclasses.replace(base, model=dataclasses.replace(base.model, dropout=0.1))
    assert not Trainer(drop, ds, device="cpu")._fused_compat  # 'auto' falls back
    with pytest.raises(ValueError, match="fused_train='on'"):
        Trainer(dataclasses.replace(drop, run=dataclasses.replace(drop.run, fused_train="on")),
                ds, device="cpu")
    with pytest.raises(NotImplementedError, match="dropout"):
        Trainer(drop, ds, device="cpu").fit(epochs=1)
    con = dataclasses.replace(base, opt=dataclasses.replace(base.opt, contrastive_weight=0.5))
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        Trainer(con, ds, device="cpu").fit(epochs=1)
