"""The contrastive view: the port's device augmentations
(`coskad_tpu_torch/data/augment_device.py`), its host toolbox
(`data/augment.py`), the all-pairs Poincaré ops and InfoNCE loss
(`geometry/poincare.py`) and the Trainer's second view, against the JAX
package's, on the CPU.

The device ops are fed JAX's own draws: each JAX op's `jax.random` calls are
replayed from its key (strong_augment's six key splits for the chain), and
the values go to the port's op as explicit draws. Tolerances: crop, mask,
flip and noise exact; rotate, blur and the chain rtol 1e-5 with atol 1e-6
of the output's largest magnitude (trig and 15-tap sums in another order);
the host toolbox exact (the same numpy calls on the same rng); the Poincaré
ops and the loss rtol 1e-5 / atol 1e-6, gradients by `close_grad` (error
below 1e-3 of max(scale, 1) plus 1e-6); the contrastive epoch in lockstep
per-step metrics rtol 1e-3 and, under SGD, the weights rtol 3e-4 / atol 1e-6
and their updates by `close_grad` (tests/test_torch_train.py's bands). The
epoch runs at SGD lr 1e-3: the reference's hyp_c = 0 logits are raw dot
products, which grow the latents without bound at larger rates.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from coskad_tpu import config as jconfig
from coskad_tpu.data import augment as jaug
from coskad_tpu.data import augment_device as jad
from coskad_tpu.data.windows import SegmentDataset as JaxSegmentDataset
from coskad_tpu.geometry import poincare as jp
from coskad_tpu.parallel import create_mesh
from coskad_tpu.train.loop import Trainer as JaxTrainer
from coskad_tpu_torch.data import augment as aug
from coskad_tpu_torch.data import augment_device as ad
from coskad_tpu_torch.data.windows import SegmentDataset
from coskad_tpu_torch.geometry import poincare as tp
from coskad_tpu_torch.interop import flatten_tree, load_jax_variables, to_jax_variables
from coskad_tpu_torch.train.loop import CONTRASTIVE_TAG, Trainer
from test_torch_stse_train import close_grad
from test_torch_train import port_config

torch.set_num_threads(1)

SHAPE = (16, 2, 12, 5)


def _pose(seed=0, shape=SHAPE):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def close(got, want, exact=False):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * max(1.0, float(np.abs(want).max())))


def _t(draws):
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


# JAX's draws, replayed from each op's key exactly as the op splits it.

def jax_crop_draws(key, shape, padding_ratio=6):
    pad = shape[2] // padding_ratio
    return {"starts": jax.random.randint(key, (shape[0],), 0, 2 * pad + 1)}


def jax_rotate_draws(key, shape):
    b = shape[0]
    k_main, k0, k1 = jax.random.split(key, 3)
    big = [jax.random.uniform(k, (b,), minval=0.0, maxval=30.0) for k in (k0, k1)]
    small = [jax.random.uniform(jax.random.fold_in(k, 1), (b,), minval=0.0, maxval=1.0)
             for k in (k0, k1)]
    return {"main_axis": jax.random.randint(k_main, (b,), 0, 3), "big": jnp.stack(big),
            "small": jnp.stack(small)}


def jax_noise_draws(key, shape):
    k_apply, k_noise = jax.random.split(key)
    return {"u": jax.random.uniform(k_apply, (shape[0],)),
            "normal": jax.random.normal(k_noise, shape)}


def jax_blur_draws(key, shape):
    k_apply, k_sigma = jax.random.split(key)
    return {"u": jax.random.uniform(k_apply, (shape[0],)),
            "sigma": jax.random.uniform(k_sigma, (shape[0],), minval=0.1, maxval=2.0)}


def jax_mask_draws(key, shape):
    k_apply, k_axis = jax.random.split(key)
    return {"u": jax.random.uniform(k_apply, (shape[0],)),
            "axis": jax.random.randint(k_axis, (shape[0],), 0, 2)}


def jax_flip_draws(key, shape):
    return {"u": jax.random.uniform(key, (shape[0],))}


def jax_strong_draws(key, shape):
    keys = jax.random.split(key, 6)
    makers = (jax_crop_draws, jax_rotate_draws, jax_noise_draws, jax_blur_draws,
              jax_mask_draws, jax_flip_draws)
    return {op: _t(make(k, shape)) for op, make, k in zip(ad.STRONG_OPS, makers, keys)}


OPS = [
    ("crop", jad.random_temporal_crop, ad.random_temporal_crop, jax_crop_draws, True),
    ("rotate", jad.random_rotate, ad.random_rotate, jax_rotate_draws, False),
    ("noise", jad.gaussian_noise, ad.gaussian_noise, jax_noise_draws, True),
    ("blur", jad.temporal_gaussian_blur, ad.temporal_gaussian_blur, jax_blur_draws, False),
    ("mask", jad.axis_mask, ad.axis_mask, jax_mask_draws, True),
    ("flip", jad.random_time_flip, ad.random_time_flip, jax_flip_draws, True),
]


@pytest.mark.parametrize("name,jfn,fn,jdraws,exact", OPS, ids=[o[0] for o in OPS])
@pytest.mark.parametrize("channels", [2, 3])
def test_device_op_with_jax_draws_matches_jax(name, jfn, fn, jdraws, exact, channels):
    shape = (SHAPE[0], channels) + SHAPE[2:]
    pose = _pose(1, shape)
    key = jax.random.PRNGKey(3)
    want = jfn(jnp.asarray(pose), key)
    draws = _t(jdraws(key, shape))
    close(fn(torch.from_numpy(pose), draws), want, exact)
    if "u" in draws:  # both branches of the p = 0.5 gate were taken
        assert 0 < int((draws["u"] < 0.5).sum()) < shape[0]


def test_strong_and_weak_augment_with_jax_draws_match_jax():
    pose = _pose(2)
    key = jax.random.PRNGKey(11)
    want = jad.strong_augment(jnp.asarray(pose), key)
    close(ad.strong_augment(torch.from_numpy(pose), jax_strong_draws(key, SHAPE)), want)
    want_weak = jad.weak_augment(jnp.asarray(pose), key)
    close(ad.weak_augment(torch.from_numpy(pose), _t(jax_crop_draws(key, SHAPE))), want_weak,
          exact=True)


def test_draws_have_the_stated_layout_and_follow_the_generator():
    shape = (64, 2, 12, 18)
    draws = ad.draw_strong_augment(torch.Generator().manual_seed(5), shape, "cpu")
    again = ad.draw_strong_augment(torch.Generator().manual_seed(5), shape, "cpu")
    assert sorted(draws) == sorted(ad.STRONG_OPS)
    for op in draws:
        for k in draws[op]:
            assert torch.equal(draws[op][k], again[op][k]), (op, k)
    assert draws["crop"]["starts"].min() >= 0 and draws["crop"]["starts"].max() <= 4
    assert set(draws["rotate"]["main_axis"].tolist()) == {0, 1, 2}
    assert draws["rotate"]["big"].shape == draws["rotate"]["small"].shape == (2, 64)
    assert 0 <= float(draws["rotate"]["big"].min()) and float(draws["rotate"]["big"].max()) < 30
    assert float(draws["rotate"]["small"].max()) < 1
    assert draws["noise"]["normal"].shape == shape
    sigma = draws["blur"]["sigma"]
    assert 0.1 <= float(sigma.min()) and float(sigma.max()) < 2.0
    assert set(draws["mask"]["axis"].tolist()) == {0, 1}
    pose = torch.from_numpy(_pose(3, shape))
    out = ad.strong_augment(pose, draws)
    assert out.shape == shape and torch.isfinite(out).all()
    assert torch.equal(out, ad.strong_augment(pose, again))


# ------------------------------------------------------------ host toolbox


HOST = [
    ("temporal_crop", {}), ("shear", {}), ("random_time_flip", {}),
    ("random_rotate", {}), ("gaussian_noise", {}), ("gaussian_blur", {}),
    ("axis_mask", {}), ("resample", {}), ("savgol_smooth", {}), ("limbs_mask", {}),
    ("temporal_shift", {}), ("weak_augment", {}), ("strong_augment", {}),
    ("random_spatial_flip", {}),
]


@pytest.mark.parametrize("name,kw", HOST, ids=[h[0] for h in HOST])
def test_host_augment_matches_jax_with_the_same_rng(name, kw):
    pose = _pose(4, (3, 30, 25))  # 25 joints: the NTU flip and limb tables apply
    for seed in range(6):  # both sides of every p gate
        want = getattr(jaug, name)(pose, rng=np.random.default_rng(seed), **kw)
        got = getattr(aug, name)(pose, rng=np.random.default_rng(seed), **kw)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=str(seed))


@pytest.mark.parametrize("stream", ["joint", "motion", "bone", "2s", "3s"])
def test_process_stream_and_batched_crop_match_jax(stream):
    data = _pose(5, (2, 3, 10, 25, 1))
    np.testing.assert_array_equal(aug.process_stream(data, stream),
                                  jaug.process_stream(data, stream))
    pose = _pose(6)
    starts = np.random.default_rng(0).integers(0, 5, SHAPE[0])
    got = aug.batched_temporal_crop(torch.from_numpy(pose), torch.from_numpy(starts))
    want = jaug.batched_temporal_crop(jnp.asarray(pose), jnp.asarray(starts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------- Poincaré, InfoNCE


def _points(seed, n, d=4, scale=0.3):
    return (np.random.default_rng(seed).normal(size=(n, d)) * scale).astype(np.float32)


def test_mobius_addition_batch_and_dist_matrix_match_jax():
    x, y = _points(0, 6), _points(1, 9)
    for k in (-1.0, -0.5):
        np.testing.assert_allclose(
            tp.mobius_addition_batch(torch.from_numpy(x), torch.from_numpy(y), k).numpy(),
            np.asarray(jp.mobius_addition_batch(jnp.asarray(x), jnp.asarray(y), k)),
            rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            tp.dist_matrix(torch.from_numpy(x), torch.from_numpy(y), k).numpy(),
            np.asarray(jp.dist_matrix(jnp.asarray(x), jnp.asarray(y), k)), rtol=1e-5, atol=1e-6)

    def jloss(a, b):
        return jnp.sum(jp.dist_matrix(a, b) ** 2)

    gx, gy = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    a, b = torch.tensor(x, requires_grad=True), torch.tensor(y, requires_grad=True)
    torch.sum(tp.dist_matrix(a, b) ** 2).backward()
    close_grad(a.grad.numpy(), np.asarray(gx), "x")
    close_grad(b.grad.numpy(), np.asarray(gy), "y")


@pytest.mark.parametrize("hyp_c", [0.0, 1.0])
def test_contrastive_loss_and_gradients_match_jax(hyp_c):
    x, pos, neg = _points(2, 16), _points(3, 16), _points(4, 16)

    def jloss(*args):
        return jp.contrastive_loss(*args, tau=0.2, hyp_c=hyp_c)

    (lj, logits_j), grads_j = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (x, pos, neg)))
    args = [torch.tensor(a, requires_grad=True) for a in (x, pos, neg)]
    loss, logits = tp.contrastive_loss(*args, tau=0.2, hyp_c=hyp_c)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(lj), rtol=1e-5)
    assert logits.shape == (16, 32)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j), rtol=1e-5,
                               atol=1e-6 * float(np.abs(np.asarray(logits_j)).max()))
    for name, a, g in zip(("x", "pos", "neg"), args, grads_j):
        close_grad(a.grad.numpy(), np.asarray(g), name)


@pytest.mark.parametrize("hyp_c", [0.0, 1.0])
def test_the_trainers_call_form_matches_jax(hyp_c):
    """contrastive_loss(z, z, z2): pos is x itself. At hyp_c > 0 the masked
    diagonal's distance is the norm of a Möbius sum that is 0 or ~1e-8, and
    the reference's unfloored norm gives non-finite gradients there; the port
    keeps the reference's arithmetic, so its gradient is non-finite there
    too (ROADMAP.md, Queue 3). z2's gradient is finite and equal."""
    z, z2 = _points(5, 16), _points(6, 16)

    def jloss(a, b):
        return jp.contrastive_loss(a, a, b, tau=0.2, hyp_c=hyp_c)[0]

    lj, (gz_j, gz2_j) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(z),
                                                                  jnp.asarray(z2))
    a, b = torch.tensor(z, requires_grad=True), torch.tensor(z2, requires_grad=True)
    loss, _ = tp.contrastive_loss(a, a, b, tau=0.2, hyp_c=hyp_c)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(lj), rtol=1e-5)
    gz, gz_j = a.grad.numpy(), np.asarray(gz_j)
    # which rows are non-finite depends on which Möbius sums round to 0
    assert np.isfinite(gz).all() == np.isfinite(gz_j).all() == (hyp_c == 0)
    fin = np.isfinite(gz) & np.isfinite(gz_j)
    assert fin.any()
    close_grad(gz[fin], gz_j[fin], "z")
    close_grad(b.grad.numpy(), np.asarray(gz2_j), "z2")


# -------------------------------------------------------------- the Trainer


def _windows(n=64, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n, 2, 12, 5)).astype(np.float32)
    return (data, np.tile([1, 1, 1, 1], (n, 1)).astype(np.int64),
            np.tile(np.arange(1, 13), (n, 1)).astype(np.int32))


def _jax_config(fused_train="off", **run):
    return jconfig.Config(
        model=jconfig.ModelConfig(variant="euclidean_dynamic", channels=(8, 4), h_dim=8,
                                  latent_dim=4),
        data=jconfig.DataConfig(seg_len=12, n_joints_override=5, batch_size=32,
                                num_transform=2),
        opt=jconfig.OptConfig(lr=1e-3, epochs=1, contrastive_weight=0.5),
        run=jconfig.RunConfig(fused_train=fused_train, ghost_size=8, **run),
    )


@pytest.mark.parametrize("fused_train", ["off", "on"])
def test_contrastive_epoch_in_lockstep_with_jax(fused_train):
    """One epoch of train_step under SGD, each step's augmentation fed
    through `contrastive_draws` with the draws JAX's step makes from its own
    state.rng (split, fold_in(., 1), split, strong_augment's splits)."""
    windows = _windows()
    cfg = _jax_config(fused_train)
    jtrainer = JaxTrainer(cfg, JaxSegmentDataset(*windows, num_transform=2),
                          mesh=create_mesh(1, 1, devices=jax.devices()[:1]))
    jtrainer.tx = optax.sgd(1e-3)
    jstate = jtrainer.initialize_center(jtrainer.init_state())
    trainer = Trainer(port_config(cfg), SegmentDataset(*windows, num_transform=2), device="cpu")
    moved = flatten_tree(jax.device_get(jstate.params))
    load_jax_variables(trainer.model, jax.device_get(jstate.params),
                       jax.device_get(jstate.batch_stats))
    trainer.optimizer = torch.optim.SGD(trainer.model.parameters(), lr=1e-3)
    state = trainer.init_state().replace(center=torch.from_numpy(np.array(jstate.center)))
    forwards = []
    forward = trainer._forward
    trainer._forward = lambda *a, **k: forwards.append(1) or forward(*a, **k)
    order = np.random.default_rng(7).permutation(len(trainer.train_ds)).reshape(-1, 32)
    for step, idx in enumerate(order):
        _, step_rng = jax.random.split(jstate.rng)
        k_aug, _ = jax.random.split(jax.random.fold_in(step_rng, 1))
        fed = jax_strong_draws(k_aug, (32, 2, 12, 5))
        jstate, jm = jtrainer._train_step(jstate, jtrainer.train_data,
                                          jnp.asarray(idx, jnp.int32))
        state, m = trainer.train_step(state, trainer.train_data, torch.from_numpy(idx),
                                      contrastive_draws=fed)
        assert sorted(m) == sorted(jm) and "contrastive_loss" in m
        for k in m:
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-3,
                                       err_msg=f"{k} at step {step}")
    assert len(forwards) == 2 * len(order)
    want = flatten_tree(jax.device_get(jstate.params))
    got = flatten_tree(to_jax_variables(trainer.model)[0])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=3e-4, atol=1e-6, err_msg=k)
        close_grad(got[k] - moved[k], want[k] - moved[k], k)  # the update itself
    want_bs = flatten_tree(jax.device_get(jstate.batch_stats))
    got_bs = flatten_tree(to_jax_variables(trainer.model)[1])
    for k in want_bs:  # both views updated the running statistics
        np.testing.assert_allclose(got_bs[k], want_bs[k], rtol=1e-3, atol=1e-5, err_msg=k)


def test_frozen_bn_reaches_the_second_view():
    """freeze_bn_after must freeze both forwards of the contrastive step
    (tests/test_train.py's case), while unfrozen both update the running
    statistics."""
    windows = _windows(seed=1)
    cfg = port_config(_jax_config(freeze_bn_after=0))
    trainer = Trainer(cfg, SegmentDataset(*windows, num_transform=2), device="cpu")
    before = {k: b.clone() for k, b in trainer.model.named_buffers()}
    state, history = trainer.fit(epochs=1)  # epoch 0 >= freeze_bn_after: frozen
    assert np.isfinite(history["loss"]).all()
    for k, b in trainer.model.named_buffers():
        assert torch.equal(b, before[k]), f"{k} changed under frozen_bn"

    live = Trainer(dataclasses.replace(cfg, run=dataclasses.replace(cfg.run, freeze_bn_after=-1)),
                   SegmentDataset(*windows, num_transform=2), device="cpu")
    one_view = Trainer(dataclasses.replace(
        cfg, run=dataclasses.replace(cfg.run, freeze_bn_after=-1),
        opt=dataclasses.replace(cfg.opt, contrastive_weight=0.0)),
        SegmentDataset(*windows, num_transform=2), device="cpu")
    idx = torch.arange(32)
    calls = []
    forward = live._forward
    live._forward = lambda *a, **k: calls.append(k["frozen_bn"]) or forward(*a, **k)
    live.model.train()
    one_view.model.train()
    live.train_step(live.init_state(), live.train_data, idx)
    one_view.train_step(one_view.init_state(), one_view.train_data, idx)
    assert calls == [False, False]
    moved = [k for k, b in live.model.named_buffers()
             if not torch.equal(b, dict(one_view.model.named_buffers())[k])]
    assert moved  # the second view's statistics reached the running buffers


def test_contrastive_generator_is_the_steps_and_the_tag():
    windows = _windows(seed=2)
    cfg = port_config(_jax_config())
    a = Trainer(cfg, SegmentDataset(*windows, num_transform=2), device="cpu")
    b = Trainer(cfg, SegmentDataset(*windows, num_transform=2), device="cpu")
    _, ha = a.fit(epochs=1)
    _, hb = b.fit(epochs=1)
    assert ha["loss"] == hb["loss"]  # one seed, one stream
    g = a._generator(3, CONTRASTIVE_TAG)
    assert torch.equal(torch.rand(4, generator=g),
                       torch.rand(4, generator=a._generator(3, CONTRASTIVE_TAG)))
    assert not torch.equal(torch.rand(4, generator=a._generator(3, CONTRASTIVE_TAG)),
                           torch.rand(4, generator=a._generator(3, 0x60)))
