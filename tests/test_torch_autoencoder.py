"""The autoencoder variant (STSAE): the port's model, objective, Trainer,
scores and eval CLI against the JAX package's, from the same weights
(carried across by `interop`) and the same seeded inputs, on the CPU.

Tolerances:
- forwards, running statistics: rtol 2e-4, atol 2e-5 at float32 (fp32
  reassociation), element by element in eval and frozen_bn; in live-BN
  train mode the reconstruction passes eight batch-normalized layers, and
  JAX's float32 result itself is up to ~2e-4 off a float64 evaluation of
  the same function on near-zero elements (the port's ~1e-5), so there
  the band is rtol 2e-4 of the output's scale plus atol 2e-5, and each
  output's and statistic's error against the port's float64 evaluation is
  at most 1.5 times JAX's own plus 1e-6 of the scale (the form of
  tests/test_torch_hyperbolic.py), also under frozen_bn where the MLP
  head's BatchNorm stays live; gradients err < 1e-3 * max(scale, 1) +
  1e-6 (tests/test_torch_stse_train.py); at bf16 err <= 2^-5 * max(scale, 1)
  and gradients by cosine > 0.98, the dense biases under live BatchNorm
  (analytically zero, rounding noise on both sides) within 2^-5 of the
  largest gradient (the bands of tests/test_torch_bf16.py, PERF.md §2), as
  are the PReLU slopes, scalars whose cosine is only their sign; a leaf of
  latent_dim elements or fewer summed over the batch (the VAE heads'
  biases) can fall below 0.98 on both sides alike, so one that does
  passes only if its cosine to JAX's float32 gradient is within 0.01 of
  JAX's bf16 one's; a larger leaf must clear 0.98;
- losses and their metrics rtol 1e-5;
- the 2-epoch lockstep fit under SGD: per-step losses and the center after
  each epoch rtol 1e-3 (the lockstep band), validation AUC, which scores
  the autoencoder by reconstruction error, within 1e-4;
- the window-loss helpers exactly, the window scores rtol 1e-6; cli.eval
  of one JAX-written checkpoint by both packages within 1e-4 AUC in each
  --rec-weight mode.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from coskad_tpu.cli import eval as jeval_cli
from coskad_tpu.cli import train as jtrain_cli
from coskad_tpu.data.windows import SegmentDataset as JaxSegmentDataset
from coskad_tpu.models.stse import build_model as jbuild_model
from coskad_tpu.parallel import create_mesh
from coskad_tpu.score import window_losses as jwl
from coskad_tpu.train import objectives as jobjectives
from coskad_tpu.train.loop import Trainer as JaxTrainer
from coskad_tpu.utils.logging import MetricLogger as JaxLogger
from coskad_tpu_torch.cli import eval as eval_cli
from coskad_tpu_torch.data.windows import SegmentDataset
from coskad_tpu_torch.interop import flatten_tree, load_jax_variables, to_jax_variables
from coskad_tpu_torch.kernels import stse_fused
from coskad_tpu_torch.models import STSAE, STSE, build_model
from coskad_tpu_torch.models.stsgcn import MLPHead
from coskad_tpu_torch.score import window_losses as wl
from coskad_tpu_torch.train import objectives
from coskad_tpu_torch.train.loop import Trainer
from coskad_tpu_torch.utils.logging import MetricLogger
from test_torch_bf16 import BAND, COSINE, assert_band, cpu_bf16_dots
from test_torch_cli import narrow_dataset
from test_torch_decoder_route import _OnCard, _Planner
from test_torch_hyperbolic import lockstep_setup
from test_torch_mlp_head import jittered
from test_torch_stse_train import close_grad
from test_torch_train import _capturing, port_config

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-5)
# the paper's layer schedule at a narrow width, 17 joints
NARROW = dict(input_dim=2, layer_channels=(8, 4, 8), hidden_dimension=8, latent_dim=4,
              n_frames=6, n_joints=17)
MODES = {"eval": (False, False), "train": (True, False), "frozen_bn": (True, True)}
# the largest gradient leaf the bf16 cosine fallback admits: a head's bias
SMALL_LEAF = NARROW["latent_dim"]


# ---------------------------------------------------------------- models


def variant_pair(projector, dtype="float32", seed=0, batch=16, **variant):
    """A JAX model from `build_model(**variant)` with jittered BatchNorm and
    PReLU, its port counterpart carrying the same variables, and inputs."""
    jmodel = jbuild_model(projector=projector, **variant, **NARROW,
                          dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    x = np.random.default_rng(seed + 11).normal(
        size=(batch, NARROW["input_dim"], NARROW["n_frames"], NARROW["n_joints"])
    ).astype(np.float32)
    keys = {"params": jax.random.PRNGKey(seed), "sample": jax.random.PRNGKey(seed + 1)}
    variables = jittered(jmodel.init(keys, jnp.asarray(x[:2])), seed)
    model = build_model(projector=projector, **variant, **NARROW,
                        dtype=torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    load_jax_variables(model, variables["params"], variables["batch_stats"])
    return jmodel, variables, model, x


def flat_outputs(out):
    """(z, recon) or (z, recon, (z_mean, z_var)) -> [z, recon, ...]."""
    z, recon, *dist = out
    return [z, recon, *(dist[0] if dist else ())]


def forward_pair(jmodel, variables, model, x, mode, **call):
    """Both models' outputs in `mode`, and in train modes the running
    statistics after it and the parameters' gradients of the sum of the
    outputs' mean squares; in live-BN train mode also the port's float64
    outputs and statistics. `call` (the VAE's draws) goes to both as given
    (numpy arrays). JAX runs jitted at float32 (one compile is cheaper than
    its eager op-by-op dispatch) and eagerly at bf16, where a jitted
    program's fusions round otherwise."""
    train, frozen_bn = MODES[mode]
    jit = jax.jit if model.dtype == torch.float32 else (lambda f: f)
    jcall = {k: tuple(map(jnp.asarray, v)) for k, v in call.items()}
    tcall = {k: tuple(map(torch.from_numpy, v)) for k, v in call.items()}
    if not train:
        want = jit(jmodel.apply)(variables, jnp.asarray(x), **jcall)
        with torch.no_grad():
            got = model.eval()(torch.from_numpy(x), **tcall)
        return ([o.numpy() for o in flat_outputs(got)],
                [np.asarray(o) for o in flat_outputs(want)], None)
    exact = None
    live_bn = not frozen_bn or isinstance(model.btlnk, MLPHead)
    if live_bn and model.dtype == torch.float32:
        m64 = copy.deepcopy(model).double().train()
        with torch.no_grad():
            out64 = m64(torch.from_numpy(x).double(), train=True,
                        **{k: tuple(torch.from_numpy(a).double() for a in v)
                           for k, v in call.items()})
        exact = ([o.numpy() for o in flat_outputs(out64)],
                 {k: v.numpy() for k, v in m64.state_dict().items()
                  if k in dict(m64.named_buffers())})

    def jloss(params, jm=jmodel):
        out, mutated = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                jnp.asarray(x), train=True, frozen_bn=frozen_bn,
                                mutable=["batch_stats"], **jcall)
        outs = flat_outputs(out)
        return sum(jnp.mean(o.astype(jnp.float32) ** 2) for o in outs), (outs, mutated)

    (_, (want, mutated)), jgrads = jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    ref = None
    if model.dtype == torch.bfloat16:  # JAX's float32 gradients, for the small leaves
        ref = flatten_tree(jax.device_get(jax.grad(
            lambda p: jloss(p, jmodel.clone(dtype=jnp.float32))[0])(variables["params"])))
    model.train()
    got = flat_outputs(model(torch.from_numpy(x), train=True, frozen_bn=frozen_bn, **tcall))
    sum(torch.mean(o ** 2) for o in got).backward()
    jflat = flatten_tree(jax.device_get(jgrads))
    grads = {k: (p.grad.numpy(), jflat[k], None if ref is None else ref[k])
             for k, p in model.named_parameters()}
    stats = (flatten_tree(to_jax_variables(model)[1]),
             flatten_tree(jax.device_get(mutated["batch_stats"])))
    return ([o.detach().numpy() for o in got], [np.asarray(o, np.float32) for o in want],
            (stats, grads, exact))


def zero_bias(name, frozen_bn):
    """A dense bias ahead of a live BatchNorm (the STS-GCN stacks' unless
    `frozen_bn`, the MLP head's always): its gradient is zero analytically,
    rounding noise on both sides."""
    if name.startswith("btlnk.hidden_"):
        return name.endswith(".bias")
    return (not frozen_bn and name.split(".")[0] in ("encoder", "decoder")
            and name.endswith("_dense.bias"))


def assert_float32(got, want, exact, name):
    """TOL element by element; with `exact` (a float64 evaluation, live BN)
    TOL of the scale, and the port's error against `exact` at most 1.5
    times JAX's own (see the module docstring)."""
    if exact is None:
        np.testing.assert_allclose(got, want, **TOL, err_msg=name)
        return
    scale = float(np.abs(exact).max())
    err = float(np.abs(got - want).max())
    assert err <= TOL["atol"] + TOL["rtol"] * scale, (name, err, scale)
    port, jax_ = (float(np.abs(a - exact).max()) for a in (got, want))
    assert port <= 1.5 * jax_ + 1e-6 * scale, (name, port, jax_)


def assert_pair(got, want, extra, dtype, frozen_bn=False):
    """Outputs, then statistics and gradients, within the dtype's band."""
    exact = extra[2] if extra is not None else None
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        if dtype == "float32":
            assert_float32(g, w, None if exact is None else exact[0][i], f"output {i}")
        else:
            assert_band(g, w, f"output {i}")
    if extra is None:
        return
    (got_stats, want_stats), grads, _ = extra
    assert sorted(got_stats) == sorted(want_stats)
    for k in want_stats:
        if dtype == "float32":
            assert_float32(got_stats[k], want_stats[k], None if exact is None else exact[1][k], k)
        else:
            assert_band(got_stats[k], want_stats[k], k)
    top = max(float(np.abs(w).max()) for _, w, _ in grads.values())
    for k, (g, w, ref) in grads.items():
        if dtype == "float32":
            close_grad(g, w, k)
        elif g.size == 1 or zero_bias(k, frozen_bn):
            err = float(np.abs(g - w if g.size == 1 else g).max())
            assert err <= BAND * top, (k, err, top)
        elif cosine(g, w) <= COSINE:
            assert g.size <= SMALL_LEAF, (k, cosine(g, w))
            assert cosine(g, ref) >= cosine(w, ref) - 0.01, (k, cosine(g, w), cosine(g, ref),
                                                              cosine(w, ref))


def cosine(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    assert np.all(np.isfinite(a))
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("projector", ["linear", "mlp"])
def test_stsae_matches_flax_at_float32(projector, mode):
    jmodel, variables, model, x = variant_pair(projector, use_decoder=True)
    assert isinstance(model, STSAE) and not hasattr(model, "fc_mean")
    got, want, extra = forward_pair(jmodel, variables, model, x, mode)
    assert got[1].shape == x.shape
    assert_pair(got, want, extra, "float32")


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_stsae_matches_flax_at_bf16(mode):
    jmodel, variables, model, x = variant_pair("mlp", "bfloat16", seed=1, use_decoder=True)
    with cpu_bf16_dots():
        got, want, extra = forward_pair(jmodel, variables, model, x, mode)
    assert_pair(got, want, extra, "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_k1_decode_route_matches_flax_decode(monkeypatch, dtype):
    """`STSAE.decode`'s eval route on K1 (the reverse projector's
    channel-major hidden state through the decoder's packed stack), taken
    for a latent that claims to be on the card with a planner that takes
    the layout, so that the custom op's CPU implementation (the kernel's
    plain version) runs where the kernel would and the module decoder does
    not: flax's `decode` of the same weights and latents, in the file's
    bands."""
    jmodel, variables, model, _ = variant_pair("mlp", dtype, seed=5, use_decoder=True)
    monkeypatch.setattr(stse_fused, "_library", lambda: _Planner())
    model.eval().requires_grad_(False)
    assert model.decoder_kernel_takes()
    monkeypatch.setattr(model.decoder, "forward", None)  # the modules must not run
    z = np.random.default_rng(7).normal(size=(16, NARROW["latent_dim"])).astype(np.float32)
    with cpu_bf16_dots():
        want = np.asarray(jmodel.apply(variables, jnp.asarray(z), method=type(jmodel).decode))
    with torch.no_grad():
        got = model.decode(torch.from_numpy(z).as_subclass(_OnCard)).as_subclass(torch.Tensor)
    assert got.shape == want.shape == (16, 2, NARROW["n_frames"], NARROW["n_joints"])
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    else:
        assert_band(got.numpy(), want, "reconstruction")


def test_build_model_dispatches_as_jax():
    kw = dict(NARROW, distribution="ps", kappa_floor=1.0, decoder_channels=(4, 8))
    assert type(build_model(**kw)) is STSE
    ae = build_model(use_decoder=True, **kw)
    assert type(ae) is STSAE
    # decoder_channels narrows the decoder: 8 -> 4 -> 8 -> 2
    assert [getattr(ae.decoder, f"layer_{i}").tcn_dense.kernel.shape for i in range(3)] == [
        (8, 4), (4, 8), (8, 2)]
    assert type(build_model(use_vae=True, **kw)).__name__ == "STSVAE"


def test_ae_fold_equals_the_encoder_only_fold_and_ignores_the_decoder():
    """K1's fold of an AE's state is the fold of the STSE with the same
    encoder and projector, and its cache survives decoder updates (it is
    keyed on encoder.* and btlnk.* alone)."""
    _, variables, ae, _ = variant_pair("linear", use_decoder=True, seed=2)
    stse = STSE(**NARROW)
    own = stse.state_dict()
    stse.load_state_dict({k: v for k, v in ae.state_dict().items() if k in own})
    f_ae, p_ae = ae.folded()
    f_se, p_se = stse.folded()
    assert torch.equal(p_ae.weights, p_se.weights) and np.array_equal(p_ae.layout, p_se.layout)
    assert torch.equal(f_ae.w_proj, f_se.w_proj) and torch.equal(f_ae.b_proj, f_se.b_proj)
    with torch.no_grad():
        ae.decoder.layer_0.tcn_bn.var.mul_(2.0)
        ae.rev_btlnk.kernel.add_(0.1)
    assert ae.folded()[1] is p_ae
    with torch.no_grad():
        ae.encoder.layer_1.tcn_bn.var.mul_(2.0)
    assert ae.folded()[1] is not p_ae
    # the fold reads the encoder's layers alone: the encoder-only plain path
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(5, 2, 6, 17)).astype(np.float32))
    with torch.no_grad():
        h = stse_fused.fused_stse_hidden(x, ae.folded()[0])
        np.testing.assert_allclose(h.reshape(5, -1).numpy(),
                                   ae.encode(x)[1].reshape(5, -1).numpy(), **TOL)


# ---------------------------------------------------------------- objectives


def test_compute_loss_and_scores_match_jax():
    from coskad_tpu import config as jconfig

    _, variables, model, x = variant_pair("mlp", use_decoder=True, seed=4)
    rng = np.random.default_rng(5)
    z = rng.normal(size=(16, 4)).astype(np.float32)
    recon = rng.normal(size=x.shape).astype(np.float32)
    center = rng.normal(size=4).astype(np.float32)
    eye = np.eye(4, dtype=np.float32)
    cfg = jconfig.Config(model=jconfig.ModelConfig(variant="autoencoder", projector="mlp"),
                         opt=jconfig.OptConfig(lambda_=0.3))
    loss_j, metrics_j = jobjectives.compute_loss(
        cfg, (jnp.asarray(z), jnp.asarray(recon)), jnp.asarray(x), variables["params"],
        jnp.asarray(center), jnp.asarray(eye))
    loss, metrics = objectives.compute_loss(
        port_config(cfg), (torch.from_numpy(z), torch.from_numpy(recon)), torch.from_numpy(x),
        model, torch.from_numpy(center), torch.from_numpy(eye))
    assert sorted(metrics) == sorted(metrics_j) == ["hypersphere_loss", "loss",
                                                    "reconstruction_loss", "regularization"]
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(metrics_j[k]), rtol=1e-5, err_msg=k)
    assert objectives.latent_of("autoencoder", (z, recon)) is z
    s = objectives.window_scores(port_config(cfg), torch.from_numpy(z),
                                 torch.from_numpy(center), torch.from_numpy(eye), torch.zeros(4))
    s_j = jobjectives.window_scores(cfg, jnp.asarray(z), jnp.asarray(center), jnp.asarray(eye),
                                    jnp.zeros(4))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=1e-5)


@pytest.mark.parametrize("weight", [0.0, 50.0, 1000.0])
def test_window_losses_match_jax(weight):
    """The numpy helpers bit for bit; the window scores, jnp in JAX, within
    rtol 1e-6: XLA divides by a constant through its reciprocal, numpy
    rounds the quotient once, 1 ulp apart."""
    rng = np.random.default_rng(int(weight))
    x = rng.normal(size=(6, 2, 5, 4)).astype(np.float32)
    recon = rng.normal(size=x.shape).astype(np.float32)
    z = rng.normal(size=(6, 3)).astype(np.float32)
    c = rng.normal(size=3).astype(np.float32)
    assert wl.mode_from_rec_weight(weight) == jwl.mode_from_rec_weight(weight)
    np.testing.assert_allclose(
        wl.reconstruction_window_scores(x, recon, z, c, weight),
        np.asarray(jwl.reconstruction_window_scores(x, recon, z, c, weight)), rtol=1e-6)
    poses = rng.normal(size=(3, 7, 4))
    poses[1, 2] = 0.0
    poses[:, 5] = 0.0
    for method in ("unique", "mean", "median"):
        for got, want in zip(wl.extract_single_pose(poses, method, return_std=True),
                             jwl.extract_single_pose(poses, method, return_std=True)):
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(wl.calculate_loss(x[:, 0, 0], recon[:, 0, 0], True),
                                  jwl.calculate_loss(x[:, 0, 0], recon[:, 0, 0], True))
    frames = np.stack([np.arange(1, 6) + i for i in range(6)])
    np.testing.assert_array_equal(wl.compute_fig_matrix(x, frames, 12),
                                  jwl.compute_fig_matrix(x, frames, 12))


# ---------------------------------------------------------------- trainers


def lockstep_pair(variant, lr=0.05):
    """The JAX Trainer and the port's on lockstep_setup's data for
    `variant`, both under SGD(lr) from the same weights; the VAE on its
    posterior mean (`vae_sample = False` on both sides)."""
    train, val, gts, cfg = lockstep_setup(variant)
    jlog = _capturing(JaxLogger)
    jtrainer = JaxTrainer(cfg, JaxSegmentDataset(*train, num_transform=2),
                          JaxSegmentDataset(*val, num_transform=2), gts,
                          mesh=create_mesh(1, 1, devices=jax.devices()[:1]), logger=jlog)
    jtrainer.tx = optax.sgd(lr)
    log = _capturing(MetricLogger)
    trainer = Trainer(port_config(cfg), SegmentDataset(*train, num_transform=2),
                      SegmentDataset(*val, num_transform=2), gts, device="cpu", logger=log)
    jtrainer.vae_sample = trainer.vae_sample = False
    jstate = jtrainer.initialize_center(jtrainer.init_state())
    load_jax_variables(trainer.model, jax.device_get(jstate.params),
                       jax.device_get(jstate.batch_stats))
    trainer.optimizer = torch.optim.SGD(trainer.model.parameters(), lr=lr)
    state = trainer.initialize_center(trainer.init_state())
    return (jtrainer, jlog, jstate), (trainer, log, state)


def lockstep_fit(variant, epochs=2):
    """`epochs` of fit on both sides: per-step losses, the center and the
    anchor after each epoch, each epoch's validation AUC."""
    (jtrainer, jlog, jstate), (trainer, log, state) = lockstep_pair(variant)
    assert not trainer._fused_compat and trainer.cfg.model.use_decoder
    np.testing.assert_allclose(state.center.numpy(), np.asarray(jstate.center), rtol=1e-3,
                               atol=1e-6)
    aucs, jaucs = [], []
    for epoch in range(epochs):
        jstate, jhist = jtrainer.fit(jstate, epochs=1)
        state, hist = trainer.fit(state, epochs=1)
        for name in ("center", "mean_vector"):
            np.testing.assert_allclose(getattr(state, name).numpy(),
                                       np.asarray(getattr(jstate, name)), rtol=1e-3, atol=1e-6,
                                       err_msg=f"{name} after epoch {epoch}")
        aucs += hist["validation_auc"]
        jaucs += jhist["validation_auc"]
    assert len(log.losses) == len(jlog.losses) == 4 * epochs
    np.testing.assert_allclose(log.losses, jlog.losses, rtol=1e-3)
    assert len(aucs) == len(jaucs) == epochs
    assert np.abs(np.subtract(aucs, jaucs)).max() <= 1e-4, (aucs, jaucs)
    return (jtrainer, jstate), (trainer, state)


def test_lockstep_fit_matches_jax_trainer():
    (jtrainer, jstate), (trainer, state) = lockstep_fit("autoencoder")
    assert not np.any(state.mean_vector.numpy())  # the AE keeps no anchor
    # validation scores the reconstruction error; score_all also the latent distance
    js, jrec = jtrainer.score_all(jstate, jtrainer.val_ds, jtrainer.val_data)
    s, rec = trainer.score_all(state, trainer.val_ds, trainer.val_data)
    np.testing.assert_allclose(s, js, rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(rec, jrec, rtol=1e-3, atol=1e-6)
    assert float(rec.min()) > 0
    z, zrec = trainer.embed_all(state, trainer.val_ds, trainer.val_data, return_rec=True)
    np.testing.assert_array_equal(zrec, rec)
    assert z.shape == (len(trainer.val_ds), 4)


def test_jax_checkpoint_through_the_port_cli_eval_in_each_rec_weight_mode(tmp_path):
    """A JAX cli.train of the narrow autoencoder (validation off: its
    last.ckpt is the one evaluated), then both packages' cli.eval of that
    checkpoint with --rec-weight 0 (latent distance), 50 (both) and 1000
    (reconstruction error)."""
    cfg_path, _ = narrow_dataset(str(tmp_path), use_decoder=True, validation=False)
    jtrain_cli.main(["--config", cfg_path, "--epochs", "1"])
    for weight in ("0", "50", "1000"):
        want = jeval_cli.main(["--config", cfg_path, "--rec-weight", weight])
        got = eval_cli.main(["--config", cfg_path, "--rec-weight", weight, "--device", "cpu"])
        assert abs(got.result.auc - want.auc) <= 1e-4, (weight, got.result.auc, want.auc)
        np.testing.assert_allclose(got.result.per_transform_auc, want.per_transform_auc,
                                   atol=1e-4)
    assert os.path.exists(os.path.join(os.path.dirname(cfg_path), "checkpoints"))
