"""The spherical VAE variant (STSVAE): the port's model ('ps' and 'normal'
latents, MLP and linear projector), objective, Trainer, scores, eval CLI
and checkpoints against the JAX package's, from the same weights and the
same seeded inputs and draws, on the CPU.

Tolerances: the model bands of tests/test_torch_autoencoder.py (float32
rtol 2e-4, atol 2e-5; bf16 2^-5 * max(scale, 1), gradients by cosine >
0.98); losses, metrics and cosine scores rtol 1e-5; the 2-epoch lockstep
fit under SGD on the posterior mean: per-step losses, the center and the
anchor mean_vector after each epoch rtol 1e-3, validation AUC within 1e-4;
one sampled epoch of train_step with fed draws: metrics and accumulators
rtol 1e-3, weights in the float32 model band against a float64 run;
cli.eval of one JAX-written checkpoint by both packages within 1e-4 AUC;
a port checkpoint restored by JAX: every array equal, latents rtol 2e-4,
atol 2e-5."""

import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coskad_tpu import config as jconfig
from coskad_tpu.cli import eval as jeval_cli
from coskad_tpu.cli import train as jtrain_cli
from coskad_tpu.data.windows import SegmentDataset as JaxSegmentDataset
from coskad_tpu.parallel import create_mesh
from coskad_tpu.train import checkpoint as jcheckpoint
from coskad_tpu.train import objectives as jobjectives
from coskad_tpu.train.loop import Trainer as JaxTrainer
from coskad_tpu_torch.cli import eval as eval_cli
from coskad_tpu_torch.data.windows import SegmentDataset
from coskad_tpu_torch.interop import flatten_tree, to_jax_variables
from coskad_tpu_torch.models import STSVAE
from coskad_tpu_torch.serve import AnomalyScorer
from coskad_tpu_torch.train import checkpoint, msgpack, objectives
from coskad_tpu_torch.train.loop import Trainer
from test_torch_autoencoder import (NARROW, assert_float32, assert_pair, forward_pair,
                                    lockstep_fit, lockstep_pair, variant_pair)
from test_torch_bf16 import cpu_bf16_dots
from test_torch_cli import narrow_dataset
from test_torch_hyperbolic import lockstep_setup
from test_torch_train import port_config

torch.set_num_threads(1)

LATENT_TOL = dict(rtol=2e-4, atol=2e-5)


def draws(distribution, batch, d=4, seed=0):
    """Fed sample draws: (z01, v_raw) for 'ps', (eps,) for 'normal'."""
    rng = np.random.default_rng(seed + 100)
    if distribution == "ps":
        return (rng.uniform(0.05, 0.95, size=batch).astype(np.float32),
                rng.normal(size=(batch, d - 1)).astype(np.float32))
    return (rng.normal(size=(batch, d)).astype(np.float32),)


# ---------------------------------------------------------------- models


@pytest.mark.parametrize("mode", ["eval", "frozen_bn", "train"])
@pytest.mark.parametrize("projector", ["linear", "mlp"])
@pytest.mark.parametrize("distribution", ["ps", "normal"])
def test_stsvae_matches_flax_at_float32(distribution, projector, mode):
    jmodel, variables, model, x = variant_pair(projector, use_vae=True,
                                               distribution=distribution)
    assert isinstance(model, STSVAE)
    # the linear projector is the identity: no btlnk, in JAX's tree as here
    assert (model.btlnk is None) == (projector == "linear")
    got, want, extra = forward_pair(jmodel, variables, model, x, mode,
                                    sample_draws=draws(distribution, len(x)))
    assert got[3].shape == ((len(x), 1) if distribution == "ps" else (len(x), 4))
    assert_pair(got, want, extra, "float32", frozen_bn=mode == "frozen_bn")
    if distribution == "ps":
        np.testing.assert_allclose(np.linalg.norm(got[2], axis=-1), 1.0, rtol=1e-6)


@pytest.mark.parametrize("distribution,projector,mode", [
    ("ps", "mlp", "eval"), ("ps", "mlp", "train"), ("normal", "linear", "train")])
def test_stsvae_matches_flax_at_bf16(distribution, projector, mode):
    jmodel, variables, model, x = variant_pair(projector, "bfloat16", seed=1, use_vae=True,
                                               distribution=distribution)
    with cpu_bf16_dots():
        got, want, extra = forward_pair(jmodel, variables, model, x, mode,
                                        sample_draws=draws(distribution, len(x)))
    assert_pair(got, want, extra, "bfloat16")


def test_sampling_paths():
    """sample=False is the mean; sampling needs a generator, whose seed
    fixes the draw; kappa_floor lifts the concentration."""
    _, _, model, x = variant_pair("mlp", use_vae=True, seed=2)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        z, _, (mean, var) = model.eval()(xt, sample=False)
        assert torch.equal(z, mean) and float(var.min()) > 1.0
        with pytest.raises(ValueError, match="Generator"):
            model(xt)
        a = model(xt, generator=torch.Generator().manual_seed(1))[0]
        b = model(xt, generator=torch.Generator().manual_seed(1))[0]
        assert torch.equal(a, b) and not torch.equal(a, mean)
        np.testing.assert_allclose(torch.linalg.vector_norm(a, dim=-1).numpy(), 1.0,
                                   atol=1e-5)
    floored = STSVAE(**NARROW, projector="mlp", kappa_floor=32.0)
    floored.load_state_dict(model.state_dict())
    with torch.no_grad():
        assert torch.allclose(floored.eval()(xt, sample=False)[2][1], var + 31.0)


# ---------------------------------------------------------------- objectives


@pytest.mark.parametrize("anchor", ["zero", "set"])
@pytest.mark.parametrize("distribution", ["ps", "normal"])
def test_compute_loss_and_scores_match_jax(distribution, anchor):
    """The ELBO's metrics with the opt-in contraction term on: gated off
    while the anchor is zero (the first epoch), live once it is set."""
    _, variables, model, x = variant_pair("mlp", use_vae=True, distribution=distribution,
                                          seed=3)
    rng = np.random.default_rng(4)
    b, d = len(x), 4
    z = rng.normal(size=(b, d)).astype(np.float32)
    mean = rng.normal(size=(b, d)).astype(np.float32)
    if distribution == "ps":
        mean /= np.linalg.norm(mean, axis=-1, keepdims=True)
    var = rng.uniform(1.0, 5.0, size=(b, 1 if distribution == "ps" else d)).astype(np.float32)
    recon = rng.normal(size=x.shape).astype(np.float32)
    mv = (rng.normal(size=d) if anchor == "set" else np.zeros(d)).astype(np.float32)
    center, eye = np.zeros(d, np.float32), np.eye(d, dtype=np.float32)
    cfg = jconfig.Config(
        model=jconfig.ModelConfig(variant="vae", projector="mlp", distribution=distribution),
        opt=jconfig.OptConfig(phi=0.7, beta=0.05, gamma=0.2, vae_contraction=0.5))
    jout = (jnp.asarray(z), jnp.asarray(recon), (jnp.asarray(mean), jnp.asarray(var)))
    loss_j, metrics_j = jobjectives.compute_loss(cfg, jout, jnp.asarray(x), variables["params"],
                                                 jnp.asarray(center), jnp.asarray(eye),
                                                 mean_vector=jnp.asarray(mv))
    out = (torch.from_numpy(z), torch.from_numpy(recon),
           (torch.from_numpy(mean), torch.from_numpy(var)))
    loss, metrics = objectives.compute_loss(port_config(cfg), out, torch.from_numpy(x), model,
                                            torch.from_numpy(center), torch.from_numpy(eye),
                                            mean_vector=torch.from_numpy(mv))
    assert sorted(metrics) == sorted(metrics_j)
    assert "vae_contraction_loss" in metrics
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(metrics_j[k]), rtol=1e-5, err_msg=k)
    if anchor == "zero":  # the gate keeps the term out of the loss
        np.testing.assert_allclose(
            metrics["loss"].item(),
            (0.7 * metrics["reconstruction_loss"] + 1e-6 * metrics["regularization"]
             + 0.05 * metrics["kl_loss"] + 0.2 * metrics["exp_dist_loss"]).item(), rtol=1e-6)
    assert objectives.latent_of("vae", out) is out[0]
    s = objectives.window_scores(port_config(cfg), torch.from_numpy(z), torch.from_numpy(center),
                                 torch.from_numpy(eye), torch.from_numpy(mv))
    s_j = jobjectives.window_scores(cfg, jnp.asarray(z), jnp.asarray(center), jnp.asarray(eye),
                                    jnp.asarray(mv))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- trainers


def test_lockstep_fit_matches_jax_trainer():
    (jtrainer, jstate), (trainer, state) = lockstep_fit("vae")
    assert float(np.linalg.norm(state.mean_vector.numpy())) > 0
    js, jrec = jtrainer.score_all(jstate, jtrainer.val_ds, jtrainer.val_data)
    s, rec = trainer.score_all(state, trainer.val_ds, trainer.val_data)
    np.testing.assert_allclose(s, js, rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(rec, jrec, rtol=1e-3, atol=1e-6)


def test_sampled_train_steps_match_jax_with_fed_draws():
    """The sampled ELBO step, as spherical_vae.yaml trains (vae_sample on in
    training and eval): one epoch of train_step under SGD from the same
    weights, each step fed the same (z01, v_raw) draws through the
    `vae_draws` hook, by JAX, the port and the port in float64. Per-step
    metrics and the epoch's accumulators of the sampled latents rtol 1e-3;
    the weights and running statistics by the live-BN form of
    test_torch_autoencoder.assert_float32: JAX's BatchNorm takes the batch
    variance in one pass (E[x^2] - E[x]^2), which on one of these batches
    puts its first-layer gradient ~5% off float64 where the port's is
    within 1e-6."""
    (jtrainer, _, jstate), (trainer, _, state) = lockstep_pair("vae")
    jtrainer.vae_sample = trainer.vae_sample = True
    assert trainer.cfg.eval.vae_sample  # the steps accumulate the samples
    t64 = copy.deepcopy(trainer)
    t64.model.double()
    t64.train_data, t64.trans_table = t64.train_data.double(), t64.trans_table.double()
    state64 = state
    order = np.random.default_rng(5).permutation(len(trainer.train_ds)).reshape(-1, 32)
    for step, idx in enumerate(order):
        fed = draws("ps", len(idx), seed=step)
        jstate, jm = jtrainer._train_step(jstate, jtrainer.train_data,
                                          jnp.asarray(idx, jnp.int32),
                                          vae_draws=tuple(map(jnp.asarray, fed)))
        state, m = trainer.train_step(state, trainer.train_data, torch.from_numpy(idx),
                                      vae_draws=tuple(map(torch.from_numpy, fed)))
        state64, _ = t64.train_step(state64, t64.train_data, torch.from_numpy(idx),
                                    vae_draws=tuple(torch.from_numpy(a).double() for a in fed))
        assert sorted(m) == sorted(jm)
        for k in m:
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-3,
                                       err_msg=f"{k} at step {step}")
    for tree, jtree, exact in zip(to_jax_variables(trainer.model),
                                  (jstate.params, jstate.batch_stats),
                                  to_jax_variables(t64.model)):
        got, want, exact = (flatten_tree(t) for t in (tree, jax.device_get(jtree), exact))
        assert sorted(got) == sorted(want)
        for k in got:
            assert_float32(got[k], want[k], exact[k], k)
    for name in ("acc_vec", "acc_weight"):
        np.testing.assert_allclose(getattr(state, name).numpy(),
                                   np.asarray(getattr(jstate, name)), rtol=1e-3, err_msg=name)
    # the fed draws move the latents off the posterior means: the steps above
    # were not the mean path
    with torch.no_grad():
        x = trainer._gather(trainer.train_data, torch.from_numpy(order[0]))
        z, _, (mean, _) = trainer.model.eval()(x, sample_draws=tuple(
            map(torch.from_numpy, draws("ps", 32))))
    assert float((z - mean).abs().max()) > 1e-3


def sampling_trainer(train, cfg):
    return Trainer(port_config(cfg), SegmentDataset(*train, num_transform=2), device="cpu")


def test_sampled_training_is_the_seeds_and_resumes_as_straight(tmp_path):
    """With sampling on (train and eval), two runs from one seed give the
    same bits, and fit 1 + save + restore + fit 1 gives what fit 2 does:
    the draws are seeded from (seed, step)."""
    train, _, _, cfg = lockstep_setup("vae")
    runs = []
    for _ in range(2):
        tr = sampling_trainer(train, cfg)
        state, hist = tr.fit(epochs=2)
        runs.append((tr, state, hist))
    (tr, state, hist), (_, state2, hist2) = runs
    assert hist["loss"] == hist2["loss"] and torch.equal(state.mean_vector, state2.mean_vector)
    first = sampling_trainer(train, cfg)
    half, _ = first.fit(epochs=1)
    path = str(tmp_path / "last.ckpt")
    checkpoint.save(path, first, half, extra={"epoch": 0, **first.schedule_state()})
    resumed = sampling_trainer(train, cfg)
    rstate, _, extra = checkpoint.restore(path, resumed)
    resumed.restore_schedule_state(extra)
    rstate, rhist = resumed.fit(rstate, epochs=1)
    assert rhist["loss"][0] == hist["loss"][1]
    assert torch.equal(rstate.mean_vector, state.mean_vector)
    # a sampled eval pass is the state's: the same scores twice
    s1, _ = tr.score_all(state, tr.train_ds, tr.train_data)
    s2, _ = tr.score_all(state, tr.train_ds, tr.train_data)
    np.testing.assert_array_equal(s1, s2)


def test_port_checkpoint_restores_into_jax(tmp_path):
    """A sampled port run's checkpoint read by the JAX package: the same
    arrays, the same posterior-mean latents."""
    train, _, _, cfg = lockstep_setup("vae")
    tr = sampling_trainer(train, cfg)
    state, _ = tr.fit(epochs=1)
    path = str(tmp_path / "port.ckpt")
    checkpoint.save(path, tr, state, tr.cfg, extra={"epoch": 0, **tr.schedule_state()})
    jtr = JaxTrainer(cfg, JaxSegmentDataset(*train, num_transform=2),
                     mesh=create_mesh(1, 1, devices=jax.devices()[:1]))
    jstate, _, _ = jcheckpoint.restore(path, jtr.init_state())
    jstate = jtr.attach_state(jstate)
    params, stats = to_jax_variables(tr.model)
    for tree, jtree in ((params, jstate.params), (stats, jstate.batch_stats)):
        want = flatten_tree(jax.device_get(jtree))
        got = flatten_tree(tree)
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(np.asarray(jstate.mean_vector), state.mean_vector.numpy())
    jtr.vae_sample = tr.vae_sample = False
    z_j = jtr.embed_all(jstate, jtr.train_ds, jtr.train_data)
    z = tr.embed_all(state, tr.train_ds, tr.train_data)
    np.testing.assert_allclose(z, z_j, **LATENT_TOL)


def zero_anchor_copy(path):
    """A copy of the checkpoint at `path` with mean_vector zeroed, as a
    checkpoint converted from the reference carries it."""
    payload = checkpoint.read_payload(path)
    payload["state"]["mean_vector"] = np.zeros_like(payload["state"]["mean_vector"])
    out = path.replace(".ckpt", "_no_anchor.ckpt")
    with open(out, "wb") as f:
        f.write(msgpack.packb(payload))
    with open(path + ".config.json") as src, open(out + ".config.json", "w") as dst:
        dst.write(src.read())
    return out


def test_jax_checkpoint_through_the_port_cli_eval_and_the_anchor_refusal(tmp_path):
    """A JAX cli.train of the narrow VAE scored on the posterior mean
    (vae_sample false; validation off, so its last.ckpt is the one
    evaluated), then both packages' cli.eval of that checkpoint; the same
    checkpoint without its anchor is refused by the port's eval and serving
    (JAX's eval recomputes it from the test split)."""
    cfg_path, ckpt_dir = narrow_dataset(str(tmp_path), use_vae=True, vae_sample=False,
                                        validation=False)
    jtrain_cli.main(["--config", cfg_path, "--epochs", "1"])
    want = jeval_cli.main(["--config", cfg_path])
    got = eval_cli.main(["--config", cfg_path, "--device", "cpu"])
    assert abs(got.result.auc - want.auc) <= 1e-4, (got.result.auc, want.auc)
    np.testing.assert_allclose(got.result.per_transform_auc, want.per_transform_auc, atol=1e-4)
    served = AnomalyScorer.from_checkpoint(os.path.join(ckpt_dir, "last.ckpt"), device="cpu")
    assert served.cfg.model.variant == "vae" and not served.cfg.eval.vae_sample

    bare = zero_anchor_copy(os.path.join(ckpt_dir, "last.ckpt"))
    with pytest.raises(ValueError, match="anchor mean_vector is missing"):
        eval_cli.main(["--config", cfg_path, "--ckpt", bare, "--device", "cpu"])
    with pytest.raises(ValueError, match="anchor mean_vector is missing"):
        AnomalyScorer.from_checkpoint(bare, device="cpu")
    cfg = dataclasses.replace(served.cfg, model=dataclasses.replace(served.cfg.model,
                                                                    variant="autoencoder"))
    checkpoint.require_vae_anchor(cfg, served.state.replace(
        mean_vector=torch.zeros(4)), bare)  # other variants keep no anchor
