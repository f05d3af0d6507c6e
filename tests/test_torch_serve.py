"""The serving slice as a whole: the port's Trainer and AnomalyScorer against
the JAX package's, with shared weights, on the same AlphaPose clips.

Tolerances: scores rtol=1e-3, atol=1e-6 (scores square latent differences,
and the latents agree to fp32 reassociation); frame AUC within 1e-4. The
comparisons also run the port's own copies of the host modules: alphapose
parsing, windowing, normalization and score/* aggregation."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coskad_tpu.config import from_reference_yaml
from coskad_tpu.data.alphapose import load_alphapose_split
from coskad_tpu.data.normalize import normalize_robust as jnormalize_robust
from coskad_tpu.serve import AnomalyScorer as JaxScorer
from coskad_tpu.train.loop import Trainer as JaxTrainer
from coskad_tpu_torch import config as tconfig
from coskad_tpu_torch.data.windows import SegmentDataset
from coskad_tpu_torch.interop import load_jax_variables
from coskad_tpu_torch.serve import AnomalyScorer
from coskad_tpu_torch.train import checkpoint
from coskad_tpu_torch.train.loop import Trainer
from fixtures import make_synthetic_dataset

torch.set_num_threads(1)

SCORE_TOL = dict(rtol=1e-3, atol=1e-6)


def _port_config(cfg):
    """The JAX Config, field for field, as the port's Config."""
    return tconfig.Config(
        model=tconfig.ModelConfig(**dataclasses.asdict(cfg.model)),
        data=tconfig.DataConfig(**dataclasses.asdict(cfg.data)),
        opt=tconfig.OptConfig(**dataclasses.asdict(cfg.opt)),
        eval=tconfig.EvalConfig(**dataclasses.asdict(cfg.eval)),
        run=tconfig.RunConfig(**dataclasses.asdict(cfg.run)),
    )


def _port_ds(ds):
    return SegmentDataset(data=ds.data, meta=ds.meta, frame_ids=ds.frame_ids,
                          num_transform=ds.num_transform)


def _jitter_stats(batch_stats, seed=0):
    rng = np.random.default_rng(seed)

    def jitter(path, v):
        name = path[-1].key
        lo, hi = (-0.5, 0.5) if name == "mean" else (0.5, 2.0)
        return jnp.asarray(rng.uniform(lo, hi, np.shape(v)), jnp.float32)

    return jax.tree_util.tree_map_with_path(jitter, batch_stats)


@pytest.fixture(scope="module")
def slice_pair(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("slice"))
    cfg_path = make_synthetic_dataset(root, n_train_clips=1, n_test_clips=1, n_frames=200)
    cfg = from_reference_yaml(cfg_path)
    cfg = dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, channels=(8, 4), h_dim=8, latent_dim=4),
        data=dataclasses.replace(cfg.data, batch_size=64),
    )
    d = cfg.data
    load = dict(seg_len=d.seg_len, seg_stride=d.seg_stride, num_transform=d.num_transform,
                vid_res=d.vid_res, normalization_strategy=d.normalization_strategy)
    train_ds = load_alphapose_split(d.pose_dirs["train"], **load)
    val_ds = load_alphapose_split(d.pose_dirs["test"], **load)
    gt = {(1, 1): np.load(os.path.join(root, "gt", "01_0001.npy"))}

    jtrainer = JaxTrainer(cfg, train_ds, val_ds=val_ds, ground_truths=gt)
    jstate = jtrainer.init_state()
    jstate = jstate.replace(batch_stats=_jitter_stats(jstate.batch_stats))
    jstate = jtrainer.attach_state(jstate)
    jstate = jtrainer.initialize_center(jstate)

    tcfg = _port_config(cfg)
    trainer = Trainer(tcfg, _port_ds(train_ds), val_ds=_port_ds(val_ds),
                      ground_truths=gt, device="cpu")
    load_jax_variables(trainer.model, jax.device_get(jstate.params),
                       jax.device_get(jstate.batch_stats))
    state = trainer.initialize_center(trainer.init_state())
    clip = os.path.join(d.pose_dirs["test"], sorted(os.listdir(d.pose_dirs["test"]))[0])
    return dict(cfg=cfg, jtrainer=jtrainer, jstate=jstate, trainer=trainer, state=state,
                train_ds=train_ds, val_ds=val_ds, gt=gt, clip=clip)


def test_initialize_center_matches(slice_pair):
    p = slice_pair
    np.testing.assert_allclose(p["state"].center.numpy(), np.asarray(p["jstate"].center),
                               rtol=1e-4, atol=1e-6)
    assert (p["state"].center.abs() >= p["cfg"].opt.center_tolerance).all()


def test_embed_all_matches(slice_pair):
    p = slice_pair
    jz = p["jtrainer"].embed_all(p["jstate"], p["val_ds"], p["jtrainer"].val_data)
    z = p["trainer"].embed_all(p["state"], p["trainer"].val_ds, p["trainer"].val_data)
    assert z.shape == jz.shape == (len(p["val_ds"]), 4)
    np.testing.assert_allclose(z, jz, rtol=2e-4, atol=2e-5)


def test_score_all_matches(slice_pair):
    p = slice_pair
    js, _ = p["jtrainer"].score_all(p["jstate"], p["val_ds"], p["jtrainer"].val_data)
    s, rec = p["trainer"].score_all(p["state"], p["trainer"].val_ds, p["trainer"].val_data)
    assert s.shape == js.shape and np.isfinite(s).all() and not rec.any()
    np.testing.assert_allclose(s, js, **SCORE_TOL)


def test_validate_auc_matches(slice_pair):
    p = slice_pair
    jres = p["jtrainer"].validate(p["jstate"])
    res = p["trainer"].validate(p["state"])
    assert 0.0 <= res.auc <= 1.0
    assert abs(res.auc - jres.auc) <= 1e-4
    np.testing.assert_allclose(res.per_transform_auc, jres.per_transform_auc, atol=1e-4)


def test_score_clip_json_matches(slice_pair):
    p = slice_pair
    n_frames = len(p["gt"][(1, 1)])
    jscorer = JaxScorer(p["cfg"], p["jstate"], trainer=p["jtrainer"])
    scorer = AnomalyScorer(p["trainer"].cfg, p["state"], trainer=p["trainer"])
    ref = jscorer.score_clip_json(p["clip"], n_frames=n_frames)
    out = scorer.score_clip_json(p["clip"], n_frames=n_frames)
    assert out.shape == (n_frames,)
    np.testing.assert_allclose(out, ref, **SCORE_TOL)
    raw = scorer.score_clip_json(p["clip"], smooth=False)
    np.testing.assert_allclose(raw, jscorer.score_clip_json(p["clip"], smooth=False),
                               **SCORE_TOL)


def test_score_windows_matches(slice_pair):
    p = slice_pair
    windows = np.random.default_rng(0).normal(size=(20, 3, 12, 18)).astype(np.float32)
    jscorer = JaxScorer(p["cfg"], p["jstate"], trainer=p["jtrainer"])
    scorer = AnomalyScorer(p["trainer"].cfg, p["state"], trainer=p["trainer"])
    np.testing.assert_allclose(scorer.score_windows(windows),
                               jscorer.score_windows(windows), **SCORE_TOL)
    assert scorer.score_windows(windows[:0]).shape == (0,)


def test_mahalanobis_scores_match(slice_pair):
    p = slice_pair
    cfg = dataclasses.replace(p["cfg"], model=dataclasses.replace(
        p["cfg"].model, distance="mahalanobis"))
    jtrainer = JaxTrainer(cfg, p["train_ds"], val_ds=p["val_ds"], ground_truths=p["gt"])
    jstate = jtrainer.initialize_center(p["jstate"])
    trainer = Trainer(_port_config(cfg), _port_ds(p["train_ds"]), device="cpu")
    trainer.model.load_state_dict(p["trainer"].model.state_dict())
    state = trainer.initialize_center(trainer.init_state())
    # The inverse covariance amplifies fp32 latent differences by cond(cov).
    np.testing.assert_allclose(state.inv_cov.numpy(), np.asarray(jstate.inv_cov),
                               rtol=1e-2, atol=1e-3)
    js, _ = jtrainer.score_all(jstate, p["train_ds"], jtrainer.train_data)
    s, _ = trainer.score_all(state, trainer.train_ds, trainer.train_data)
    np.testing.assert_allclose(s, js, rtol=1e-2, atol=1e-5)


def test_preprocess_refuses_robust_and_checkpoints_wait(slice_pair, tmp_path):
    """Robust preprocessing takes the training scaler only (it refuses to
    fit one per request) and then matches the JAX scorer's; a checkpoint
    loads through from_checkpoint and scores as the scorer it came from."""
    p = slice_pair
    tcfg = p["trainer"].cfg
    cfg = dataclasses.replace(tcfg, data=dataclasses.replace(
        tcfg.data, normalization_strategy="robust"))
    raw = np.random.default_rng(1).uniform(1, 800, size=(4, 12, 17, 3))
    scorer = AnomalyScorer(cfg, p["state"], trainer=p["trainer"])
    with pytest.raises(ValueError, match="training-fitted scaler"):
        scorer.preprocess_windows(raw)
    jcfg = dataclasses.replace(p["cfg"], data=dataclasses.replace(
        p["cfg"].data, normalization_strategy="robust"))
    jscorer = JaxScorer(jcfg, p["jstate"], trainer=p["jtrainer"])
    _, jscorer.scaler = jnormalize_robust(np.random.default_rng(2).uniform(
        1, 800, size=(30, 12, 18, 3)), vid_res=jcfg.data.vid_res)
    scorer.scaler = jscorer.scaler
    np.testing.assert_array_equal(scorer.preprocess_windows(raw),
                                  jscorer.preprocess_windows(raw))

    with pytest.raises(FileNotFoundError):
        AnomalyScorer.from_checkpoint(str(tmp_path / "x.ckpt"), device="cpu")
    path = str(tmp_path / "s.ckpt")
    checkpoint.save(path, p["trainer"], p["state"], tcfg)
    loaded = AnomalyScorer.from_checkpoint(path, device="cpu")
    windows = np.random.default_rng(0).normal(size=(20, 3, 12, 18)).astype(np.float32)
    np.testing.assert_array_equal(loaded.score_windows(windows),
                                  AnomalyScorer(tcfg, p["state"], trainer=p["trainer"]
                                                ).score_windows(windows))
    assert loaded.scaler is None and dataclasses.asdict(loaded.cfg) == dataclasses.asdict(tcfg)
