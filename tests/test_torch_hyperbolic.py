"""The hyperbolic variant: the port's Poincaré-ball geometry, objectives and
Trainer against the JAX package's, on the same seeded inputs and weights.

Tolerances:
- the geometry's values against JAX rtol 1e-5, atol 1e-6 on random
  points, rtol 1e-4, atol 1e-5 on points within 1e-3 of the boundary;
  gradients against `jax.grad` rtol 1e-5 with atol 1e-6 of the gradient's
  largest magnitude on random points, and rtol 1e-4 with atol 1e-3 of it
  near the boundary, where float32 itself (either package, against a
  float64 evaluation of the same formulas) is off by 3e-4 to 9e-3 of it in
  dist, the midpoints and project; and each gradient's error against that
  float64 evaluation at most 1.5 times JAX's own, plus 1e-6 of the scale;
- the loss and its metrics rtol 1e-5; window scores rtol 1e-3, atol 1e-6
  (PERF.md §2); centers rtol 1e-4, atol 1e-6;
- the 2-epoch lockstep `fit`: per-step losses rtol 1e-3 (the lockstep
  band, tests/test_torch_train.py), epoch centers rtol 1e-4, atol 1e-6,
  and under SGD scores rtol 1e-3, atol 1e-6 and frame AUC within 1e-4.
  Under Adam the scores are not compared: the pre-BN biases (the encoder's
  dense layers and the head's hidden_0) have an analytically zero gradient
  whose rounding noise Adam normalizes into steps of +-lr, which the
  running statistics then carry into the eval forward (SGD leaves it at
  the noise's size)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from coskad_tpu import config as jconfig
from coskad_tpu.data.windows import SegmentDataset as JaxSegmentDataset
from coskad_tpu.geometry import poincare as jhyp
from coskad_tpu.parallel import create_mesh
from coskad_tpu.train import objectives as jobjectives
from coskad_tpu.train.loop import Trainer as JaxTrainer
from coskad_tpu.utils.logging import MetricLogger as JaxLogger
from coskad_tpu_torch.data.windows import SegmentDataset
from coskad_tpu_torch.geometry import poincare as hyp
from coskad_tpu_torch.interop import load_jax_variables
from coskad_tpu_torch.train import objectives
from coskad_tpu_torch.train.loop import Trainer
from coskad_tpu_torch.utils.logging import MetricLogger
from test_torch_train import _capturing, port_config

torch.set_num_threads(1)

RANDOM_TOL = dict(rtol=1e-5, atol=1e-6)
BOUNDARY_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = {"random": dict(rtol=1e-5, atol=1e-6), "boundary": dict(rtol=1e-4, atol=1e-3)}
SCORE_TOL = dict(rtol=1e-3, atol=1e-6)
CENTER_TOL = dict(rtol=1e-4, atol=1e-6)


def ball_points(rng, n, d, where, radius=1.0):
    """Points of the ball: 'random' norms in (0, 0.9), 'boundary' norms
    within 1e-3 of `radius` (1, the ball's edge, or 0.996, the edge of the
    projected ball that holds every latent and center)."""
    u = rng.normal(size=(n, d))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    r = rng.uniform(0.0, 0.9, (n, 1)) if where == "random" else radius - rng.uniform(
        1e-6, 1e-3, (n, 1))
    return (u * r).astype(np.float32)


def projected(rng, n, d, where):
    return ball_points(rng, n, d, where, radius=1.0 - hyp.BALL_EPS_F32)


def tangent(rng, n, d, where):
    """Tangent vectors: moderate norms, or large ones whose exp map lands
    within float32 rounding of the boundary."""
    scale = 1.0 if where == "random" else 4.0
    return (rng.normal(size=(n, d)) * scale).astype(np.float32)


# name -> (a function making the inputs, call on a geometry module)
FUNCTIONS = {
    "artanh": (lambda rng, w: [(rng.uniform(-1.2, 1.2, (64,)) if w == "random" else
                                np.sign(rng.normal(size=64)) * (1 - rng.uniform(0, 1e-3, 64))
                                ).astype(np.float32)],
               lambda m, a: m.artanh(a)),
    "project": (lambda rng, w: [ball_points(rng, 32, 8, w) * 1.01],
                lambda m, x: m.project(x)),
    "lambda_x": (lambda rng, w: [ball_points(rng, 32, 8, w)], lambda m, x: m.lambda_x(x)),
    "mobius_add": (lambda rng, w: [ball_points(rng, 32, 8, w), ball_points(rng, 32, 8, w)],
                   lambda m, x, y: m.mobius_add(x, y)),
    "expmap0": (lambda rng, w: [tangent(rng, 32, 8, w)], lambda m, u: m.expmap0(u)),
    "logmap0": (lambda rng, w: [ball_points(rng, 32, 8, w)], lambda m, y: m.logmap0(y)),
    # the loss and the scores measure between projected points
    "dist": (lambda rng, w: [projected(rng, 32, 8, w), projected(rng, 32, 8, w)],
             lambda m, x, y: m.dist(x, y)),
    "dist0": (lambda rng, w: [ball_points(rng, 32, 8, w)], lambda m, x: m.dist0(x)),
    "poincare_to_klein": (lambda rng, w: [ball_points(rng, 32, 8, w)],
                          lambda m, x: m.poincare_to_klein(x)),
    "klein_to_poincare": (lambda rng, w: [ball_points(rng, 32, 8, w)],
                          lambda m, x: m.klein_to_poincare(x)),
    "lorenz_factor": (lambda rng, w: [ball_points(rng, 32, 8, w)],
                      lambda m, x: m.lorenz_factor(x)),
    # the center is the midpoint of projected latents
    "weighted_midpoint": (lambda rng, w: [projected(rng, 32, 8, w),
                                          rng.uniform(0.1, 1.0, 32).astype(np.float32)],
                          lambda m, x, wt: m.weighted_midpoint(x, weights=wt)),
    "midpoint_stats": (lambda rng, w: [projected(rng, 32, 8, w)],
                       lambda m, x: m.midpoint_from_stats(*m.streaming_midpoint_stats(x))),
    "latent_to_ball": (lambda rng, w: [tangent(rng, 32, 8, w)],
                       lambda m, z: m.project(m.expmap0(z))),
}


@pytest.mark.parametrize("where", ["random", "boundary"])
@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_geometry_and_its_gradient_match_jax(name, where):
    build, call = FUNCTIONS[name]
    rng = np.random.default_rng(sorted(FUNCTIONS).index(name) + (100 if where != "random" else 0))
    args = build(rng, where)
    tol = RANDOM_TOL if where == "random" else BOUNDARY_TOL
    want = np.asarray(call(jhyp, *map(jnp.asarray, args)))
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    got = call(hyp, *targs)
    np.testing.assert_allclose(got.detach().numpy(), want, **tol)
    assert got.dtype == torch.float32

    weights = rng.normal(size=want.shape).astype(np.float32)
    jgrads = jax.grad(lambda *a: jnp.sum(call(jhyp, *a) * weights),
                      argnums=tuple(range(len(args))))(*map(jnp.asarray, args))
    torch.sum(got * torch.from_numpy(weights)).backward()
    exact = [torch.tensor(a, dtype=torch.float64, requires_grad=True) for a in args]
    torch.sum(call(hyp, *exact) * torch.from_numpy(weights).double()).backward()
    gtol = GRAD_TOL[where]
    for i, (t, g, e) in enumerate(zip(targs, jgrads, exact)):
        g, e = np.asarray(g), e.grad.numpy()
        scale = max(float(np.abs(g).max()), 1.0)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=gtol["rtol"],
                                   atol=gtol["atol"] * scale, err_msg=f"d/d arg {i}")
        err_port = float(np.abs(t.grad.numpy() - e).max())
        err_jax = float(np.abs(g - e).max())
        assert err_port <= 1.5 * err_jax + 1e-6 * scale, (i, err_port, err_jax)


def test_ball_constants_follow_the_dtype():
    x = np.full((1, 4), 0.9, np.float64)
    np.testing.assert_allclose(hyp.project(torch.from_numpy(x)).norm().item(), 1 - 1e-5)
    np.testing.assert_allclose(hyp.project(torch.from_numpy(x.astype(np.float32))).norm().item(),
                               1 - 4e-3, rtol=1e-6)
    # artanh's clip: the same finite value at and beyond 1, and a zero slope
    a = torch.tensor([1.0, 2.0], requires_grad=True)
    y = hyp.artanh(a)
    y.sum().backward()
    assert torch.isfinite(y).all() and y[0] == y[1] and (a.grad == 0).all()


# ---------------------------------------------------------------- objectives


def hyperbolic_config(**model):
    return jconfig.Config(model=jconfig.ModelConfig(variant="hyperbolic", **model))


def test_loss_scores_and_statistics_match_jax():
    """compute_loss's metrics (poincare_loss, hyperlatent_norm,
    regularization), window_scores, and the midpoint statistics one batch
    adds to the accumulators."""
    from test_torch_mlp_head import stse_pair

    _, variables, model, x = stse_pair(seed=6)
    rng = np.random.default_rng(7)
    # latents inside the projection radius: at it, a midpoint weight's
    # 1 - |x_Klein|^2 keeps ~1e-5 of its float32 value (the boundary cases
    # of test_geometry_and_its_gradient_match_jax hold those)
    z = (rng.normal(size=(32, 4)) * 0.5).astype(np.float32)
    center = (ball_points(rng, 1, 4, "random")[0] * 0.5).astype(np.float32)
    eye = np.eye(4, dtype=np.float32)
    cfg = hyperbolic_config(projector="mlp")
    loss_j, metrics_j = jobjectives.compute_loss(cfg, jnp.asarray(z), jnp.asarray(x),
                                                 variables["params"], jnp.asarray(center),
                                                 jnp.asarray(eye))
    loss, metrics = objectives.compute_loss(port_config(cfg), torch.from_numpy(z),
                                            torch.from_numpy(x), model,
                                            torch.from_numpy(center), torch.from_numpy(eye))
    assert sorted(metrics) == sorted(metrics_j) == ["hyperlatent_norm", "loss", "poincare_loss",
                                                    "regularization"]
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(metrics_j[k]), rtol=1e-5, err_msg=k)

    s_j = jobjectives.window_scores(cfg, jnp.asarray(z), jnp.asarray(center), jnp.asarray(eye),
                                    jnp.zeros(4))
    s = objectives.window_scores(port_config(cfg), torch.from_numpy(z),
                                 torch.from_numpy(center), torch.from_numpy(eye), torch.zeros(4))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), **SCORE_TOL)

    acc0 = (np.full(4, 0.5, np.float32), np.float32(3.0), np.zeros((4, 4), np.float32))
    want = jobjectives.accumulate_stats(tuple(map(jnp.asarray, acc0)), "hyperbolic", "euclidean",
                                        jnp.asarray(z), jnp.asarray(center))
    got = objectives.accumulate_stats(tuple(torch.tensor(a) for a in acc0), "hyperbolic",
                                      "euclidean", torch.from_numpy(z), torch.from_numpy(center))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **RANDOM_TOL)


# ---------------------------------------------------------------- trainers


def lockstep_setup(variant, seed=0):
    """64 random training windows x 2 transforms (4 steps of 32 an epoch)
    and a validation set of 2 clips with ground truth, the narrow MLP model
    at 17 joints, validation on."""
    rng = np.random.default_rng(seed)
    n_win, t, v = 64, 6, 17
    data = rng.normal(size=(n_win, 3, t, v)).astype(np.float32)
    meta = np.tile([1, 1, 1, 1], (n_win, 1)).astype(np.int64)
    fids = np.tile(np.arange(1, t + 1), (n_win, 1)).astype(np.int32)
    # validation: 2 clips x 40 windows at stride 1, an anomalous stretch in
    # clip 2 made of louder windows
    n_val = 40
    vdata = rng.normal(size=(2 * n_val, 3, t, v)).astype(np.float32)
    vdata[n_val + 10:n_val + 25, :2] *= 3.0
    clip = np.repeat([1, 2], n_val)
    start = np.tile(np.arange(n_val), 2)
    vmeta = np.stack([np.ones_like(clip), clip, np.ones_like(clip), start], -1).astype(np.int64)
    vfids = (start[:, None] + np.arange(t)).astype(np.int32)
    gt = np.zeros(n_val + t, np.int64)
    gts = {(1, 1): gt.copy(), (1, 2): gt.copy()}
    gts[(1, 2)][12:30] = 1
    cfg = jconfig.Config(
        model=jconfig.ModelConfig(variant=variant, channels=(8, 4), h_dim=8, latent_dim=4,
                                  projector="mlp"),
        data=jconfig.DataConfig(seg_len=t, n_joints_override=v, batch_size=32, num_transform=2,
                                kp18_format=False),
        opt=jconfig.OptConfig(lr=1e-3, epochs=2, validation=True),
        run=jconfig.RunConfig(fused_train="auto"),
    )
    return (data, meta, fids), (vdata, vmeta, vfids), gts, cfg


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
@pytest.mark.parametrize("variant", ["hyperbolic", "euclidean_dynamic"])
def test_lockstep_fit_matches_jax_trainer(variant, optimizer):
    """Two epochs of Trainer.fit on both sides from the same weights and
    center: per-step losses, the center after each epoch (the midpoint for
    hyperbolic, which stays in the ball) and the center-norm logs; under
    SGD also the validation AUC of each epoch and the scores at the end."""
    train, val, gts, cfg = lockstep_setup(variant)
    lr = cfg.opt.lr if optimizer == "adam" else 0.05
    jlog = _capturing(JaxLogger)
    jtrainer = JaxTrainer(cfg, JaxSegmentDataset(*train, num_transform=2),
                          JaxSegmentDataset(*val, num_transform=2), gts,
                          mesh=create_mesh(1, 1, devices=jax.devices()[:1]), logger=jlog)
    if optimizer == "sgd":
        jtrainer.tx = optax.sgd(lr)
    jstate = jtrainer.initialize_center(jtrainer.init_state())

    log = _capturing(MetricLogger)
    centers = []
    log_all = log.log

    def keep_centers(metrics, step, force=False):
        if "center/eucl" in metrics:
            centers.append((metrics["center/eucl"], metrics["center/hyp"]))
        log_all(metrics, step, force)

    log.log = keep_centers
    trainer = Trainer(port_config(cfg), SegmentDataset(*train, num_transform=2),
                      SegmentDataset(*val, num_transform=2), gts, device="cpu", logger=log)
    assert not trainer._fused_compat
    load_jax_variables(trainer.model, jax.device_get(jstate.params),
                       jax.device_get(jstate.batch_stats))
    if optimizer == "sgd":
        trainer.optimizer = torch.optim.SGD(trainer.model.parameters(), lr=lr)
    state = trainer.initialize_center(trainer.init_state())
    np.testing.assert_allclose(state.center.numpy(), np.asarray(jstate.center), **CENTER_TOL)

    aucs, jaucs = [], []
    for epoch in range(2):
        jstate, jhist = jtrainer.fit(jstate, epochs=1)
        state, hist = trainer.fit(state, epochs=1)
        np.testing.assert_allclose(state.center.numpy(), np.asarray(jstate.center),
                                   **CENTER_TOL, err_msg=f"center after epoch {epoch}")
        if variant == "hyperbolic":
            assert float(state.center.norm()) < 1.0
        aucs += hist["validation_auc"]
        jaucs += jhist["validation_auc"]
    assert len(log.losses) == len(jlog.losses) == 8
    np.testing.assert_allclose(log.losses, jlog.losses, rtol=1e-3)
    assert len(aucs) == len(jaucs) == 2
    if optimizer == "sgd":
        assert np.abs(np.subtract(aucs, jaucs)).max() <= 1e-4, (aucs, jaucs)
        js, _ = jtrainer.score_all(jstate, jtrainer.val_ds, jtrainer.val_data)
        s, _ = trainer.score_all(state, trainer.val_ds, trainer.val_data)
        np.testing.assert_allclose(s, js, **SCORE_TOL)
    if variant == "hyperbolic":
        c = np.asarray(jstate.center)
        assert len(centers) == 2
        np.testing.assert_allclose(centers[-1], [np.linalg.norm(c), float(jhyp.dist0(c))],
                                   rtol=1e-4)
    else:
        assert centers == []


def test_center_leaving_the_ball_raises():
    train, _, _, cfg = lockstep_setup("hyperbolic")
    trainer = Trainer(port_config(cfg), SegmentDataset(*train, num_transform=2), device="cpu")
    trainer.embed_all = lambda *a, **k: np.full((8, 4), np.nan, np.float32)
    with pytest.raises(ValueError, match="left the Poincaré ball"):
        trainer.initialize_center(trainer.init_state())
    # the VAE scores by cosine distance to its anchor, as JAX does
    vae = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, variant="vae"))
    z = np.random.default_rng(1).normal(size=(2, 4)).astype(np.float32)
    anchor = np.array([1.0, 0.5, 0.0, -1.0], np.float32)
    got = objectives.window_scores(port_config(vae), torch.from_numpy(z), torch.zeros(4),
                                   torch.eye(4), torch.from_numpy(anchor))
    want = jobjectives.window_scores(vae, jnp.asarray(z), jnp.zeros(4), jnp.eye(4),
                                     jnp.asarray(anchor))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCORE_TOL)
