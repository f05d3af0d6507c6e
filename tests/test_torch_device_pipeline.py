"""The device pipeline (`coskad_tpu_torch/data/device_pipeline.py`): the
TrajectoryStore, its gathers and normalizations, and the Trainer and CLIs
running on it, against the JAX package's `data/device_pipeline.py` and the
port's own windows pipeline, on the CPU.

Tolerances: index tables, metadata, frame ids and the resident trajectories
equal JAX's exactly; a gather equals advanced indexing exactly; the
float32 normalizations and gathered batches are within rtol 1e-5 and an
atol of 1e-6 times the output's largest magnitude of JAX's (the same float32
arithmetic, reduction order aside: 'stan' subtracts the time mean of a
confidence channel of ~800, where one float32 ulp is 6e-5) and
within rtol 1e-4 / atol 5e-4 of the host loader, which normalizes in
float64 (tests/test_device_pipeline.py's band); the 2-epoch lockstep fit
uses tests/test_torch_train.py's bands (per-step losses rtol 1e-3, centers
rtol 1e-3 / atol 1e-6)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from coskad_tpu import config as jconfig
from coskad_tpu.data import alphapose as jalphapose
from coskad_tpu.data import device_pipeline as jdp
from coskad_tpu.data.transforms import canonical_transforms as jcanonical
from coskad_tpu.data.windows import PersonTrajectory
from coskad_tpu.parallel import create_mesh
from coskad_tpu.train.loop import Trainer as JaxTrainer
from coskad_tpu.utils.logging import MetricLogger as JaxLogger
from coskad_tpu_torch.cli import eval as eval_cli
from coskad_tpu_torch.cli import train as train_cli
from coskad_tpu_torch.data import alphapose
from coskad_tpu_torch.data import device_pipeline as dp
from coskad_tpu_torch.data.normalize import RobustScalerState
from coskad_tpu_torch.data.transforms import canonical_transforms, gather_batch
from coskad_tpu_torch.interop import load_jax_variables
from coskad_tpu_torch.train.loop import Trainer
from coskad_tpu_torch.utils.logging import MetricLogger
from fixtures import make_synthetic_dataset
from test_torch_train import _capturing, port_config

torch.set_num_threads(1)



def close_to_jax(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * max(1.0, float(np.nanmax(np.abs(want)))))

HOST_TOL = dict(rtol=1e-4, atol=5e-4)


def _clip_files(tmp_path, rng, n_clips=2, n_frames=60):
    """Clips with two persons, person 2 with gaps (the continuity rule)."""
    paths = []
    for c in range(1, n_clips + 1):
        clip = {}
        for pid in ("1", "2"):
            frames = {}
            for f in range(int(pid), n_frames):
                if pid == "2" and f % 19 == 0:
                    continue
                frames[f"{f:04d}"] = {"keypoints": rng.uniform(10, 800, size=51).tolist()}
            clip[pid] = frames
        p = tmp_path / f"01_{c:04d}_t.json"
        p.write_text(json.dumps(clip))
        paths.append((1, c, str(p)))
    return paths


def _clips(paths):
    return [(s, c, alphapose.parse_clip_json(p)) for s, c, p in paths]


def _robust_scaler(rng, v):
    return RobustScalerState(center=rng.normal(100, 20, size=v * 2),
                             scale=rng.uniform(50, 200, size=v * 2))


def _assert_tables_equal(store, jstore):
    for k in ("window_person", "window_start", "meta", "frame_ids"):
        np.testing.assert_array_equal(getattr(store, k), getattr(jstore, k), err_msg=k)
        assert getattr(store, k).dtype == getattr(jstore, k).dtype, k
    assert store.kp_shape == tuple(jstore.kp_shape)
    assert store.traj.dtype == torch.float32 and store.traj.device.type == "cpu"
    np.testing.assert_array_equal(store.traj.numpy(), np.asarray(jstore.traj))
    assert len(store) == len(jstore) and store.num_windows == jstore.num_windows


NORMS = [("markovitz", True), ("markovitz", False), ("stan", True), ("bbox", True),
         ("robust", True), ("none", True)]


@pytest.mark.parametrize("norm,sub_mean", NORMS,
                         ids=["markovitz", "markovitz_nomean", "stan", "bbox", "robust", "none"])
def test_store_matches_jax_and_the_host_loader(tmp_path, rng, norm, sub_mean):
    paths = _clip_files(tmp_path, rng)
    kp18 = norm != "robust"
    scaler = _robust_scaler(rng, 17) if norm == "robust" else None
    kw = dict(seg_len=12, seg_stride=4, kp18_format=kp18, normalization=norm,
              vid_res=(856, 480), sub_mean=sub_mean, scaler=scaler)
    store = dp.build_store(_clips(paths), device="cpu", **kw)
    jstore = jdp.build_store([(s, c, jalphapose.parse_clip_json(p)) for s, c, p in paths],
                             **kw)
    _assert_tables_equal(store, jstore)
    got = dp.to_segment_dataset_host(store)
    want = jdp.to_segment_dataset_host(jstore)
    close_to_jax(got.data, want.data)
    if norm == "none":
        return
    host = alphapose.load_alphapose_split(
        str(tmp_path), seg_len=12, seg_stride=4, kp18_format=kp18,
        normalization_strategy=norm, vid_res=[856, 480], sub_mean=sub_mean, scaler=scaler)
    np.testing.assert_array_equal(store.meta, host.meta)
    np.testing.assert_array_equal(store.frame_ids, host.frame_ids)
    np.testing.assert_allclose(got.data, host.data, **HOST_TOL)


@pytest.mark.parametrize("norm,sub_mean", NORMS,
                         ids=["markovitz", "markovitz_nomean", "stan", "bbox", "robust", "none"])
def test_normalizations_match_jax(rng, norm, sub_mean):
    win = rng.uniform(0, 800, size=(8, 12, 17, 3)).astype(np.float32)
    win[0, 3, 5, :2] = 0.0  # the robust rule's missing keypoint
    skw = {}
    if norm == "robust":
        skw = dict(scaler_center=rng.normal(size=(17, 2)).astype(np.float32),
                   scaler_scale=rng.uniform(0.5, 2.0, size=(17, 2)).astype(np.float32))
    for symm in (False, True):
        args = (norm, (856, 480), symm, sub_mean)
        full = dp.normalize_windows_device(torch.from_numpy(win), *args, **skw)
        xy = dp.normalize_xy_device(torch.from_numpy(win), *args, **skw)
        assert full.dtype == xy.dtype == torch.float32 and xy.shape == (8, 12, 17, 2)
        np.testing.assert_array_equal(xy.numpy(), full.numpy()[..., :2])
        want = jdp.normalize_windows_device(jnp.asarray(win), *args, **skw)
        close_to_jax(full.numpy(), want)
        want_xy = jdp.normalize_xy_device(jnp.asarray(win), *args, **skw)
        close_to_jax(xy.numpy(), want_xy)
    with pytest.raises(ValueError, match="Unsupported device normalization"):
        dp.normalize_windows_device(torch.from_numpy(win), "zscore", (856, 480), True, True)


def test_gather_windows_equals_advanced_indexing(rng):
    p, f, v, c, t, b = 7, 40, 18, 3, 12, 64
    traj4 = rng.uniform(10, 800, size=(p, f, v, c)).astype(np.float32)
    person = rng.integers(0, p, b).astype(np.int32)
    start = rng.integers(0, f - t + 1, b).astype(np.int32)
    want = traj4[person[:, None], start[:, None] + np.arange(t)[None, :]]
    got = dp.gather_windows(torch.from_numpy(traj4.reshape(p, f, v * c)),
                            torch.from_numpy(person), torch.from_numpy(start), t, (v, c))
    assert got.shape == (b, t, v, c)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("num_coords", [2, 3])
def test_gather_batch_from_store_matches_jax_and_the_windows_pipeline(tmp_path, rng,
                                                                      num_coords):
    paths = _clip_files(tmp_path, rng)
    store = dp.build_store(_clips(paths), seg_len=12, seg_stride=4, device="cpu")
    jstore = jdp.build_store([(s, c, jalphapose.parse_clip_json(p)) for s, c, p in paths],
                             seg_len=12, seg_stride=4)
    host = alphapose.load_alphapose_split(str(tmp_path), seg_len=12, seg_stride=4)
    idx = np.random.default_rng(0).permutation(store.num_windows * 5)[:32]
    table = torch.as_tensor(canonical_transforms(5))
    got = dp.gather_batch_from_store(
        store, store.traj, torch.as_tensor(store.window_person, dtype=torch.int64),
        torch.as_tensor(store.window_start, dtype=torch.int64), torch.as_tensor(idx),
        table, num_coords)
    want = jdp.gather_batch_from_store(
        jstore, jstore.traj, jnp.asarray(jstore.window_person),
        jnp.asarray(jstore.window_start), jnp.asarray(idx), jnp.asarray(jcanonical(5)),
        num_coords)
    assert got.shape == (32, num_coords, 12, 18)
    close_to_jax(got.numpy(), want)
    windows = gather_batch(torch.from_numpy(host.data), torch.as_tensor(idx), table,
                           num_coords)
    np.testing.assert_allclose(got.numpy(), windows.numpy(), **HOST_TOL)


def _traj(rng, pid, n):
    return PersonTrajectory(person_id=pid, frame_keys=list(range(1, n + 1)),
                            keypoints=rng.normal(size=(n, 5, 3)))


def test_store_drops_windowless_trajectories_as_jax():
    rng = np.random.default_rng(0)
    long_a, short, long_b = _traj(rng, 1, 40), _traj(rng, 2, 4), _traj(rng, 3, 30)
    kw = dict(seg_len=6, seg_stride=1, kp18_format=False, normalization="none",
              num_transform=1)
    store = dp.build_store([(1, 1, [long_a, short, long_b])], device="cpu", **kw)
    jstore = jdp.build_store([(1, 1, [long_a, short, long_b])], **kw)
    _assert_tables_equal(store, jstore)
    assert store.traj.shape[0] == 2 and store.window_person.max() == 1
    batch = dp.gather_batch_from_store(
        store, store.traj, torch.as_tensor(store.window_person, dtype=torch.int64),
        torch.as_tensor(store.window_start, dtype=torch.int64),
        torch.tensor([0, store.num_windows - 1]), torch.as_tensor(canonical_transforms(1)))
    start_b = int(store.window_start[-1])
    np.testing.assert_array_equal(batch[1].numpy().transpose(1, 2, 0),
                                  long_b.keypoints[start_b:start_b + 6, :, :2].astype(np.float32))


def test_out_of_bounds_window_raises_as_jax():
    """A negative start_offset enumerates a window starting before its
    trajectory; the host-side check refuses it on both sides."""
    clips = [(1, 1, [_traj(np.random.default_rng(1), 1, 10)])]
    kw = dict(seg_len=4, seg_stride=1, start_offset=-2, kp18_format=False)
    with pytest.raises(ValueError, match="exceeds trajectory length") as got:
        dp.build_store(clips, device="cpu", **kw)
    with pytest.raises(ValueError, match="exceeds trajectory length") as want:
        jdp.build_store(clips, **kw)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="no valid windows"):
        dp.build_store([(1, 1, [_traj(np.random.default_rng(1), 1, 3)])], seg_len=6,
                       device="cpu")


def test_load_alphapose_store_matches_jax(tmp_path, rng):
    _clip_files(tmp_path, rng)
    kw = dict(seg_len=12, seg_stride=1, kp18_format=True, normalization_strategy="markovitz",
              num_transform=3)
    store = alphapose.load_alphapose_store(str(tmp_path), device="cpu", **kw)
    _assert_tables_equal(store, jalphapose.load_alphapose_store(str(tmp_path), **kw))
    host = alphapose.load_alphapose_split(str(tmp_path), **kw)
    assert store.num_windows == host.num_windows and len(store) == len(host)
    assert store.scaler is None
    scaler = _robust_scaler(rng, 18)
    robust = alphapose.load_alphapose_store(str(tmp_path), normalization_strategy="robust",
                                            scaler=scaler, device="cpu")
    np.testing.assert_array_equal(robust.scaler.center, scaler.center)
    with pytest.raises(ValueError, match="pre-fitted"):
        alphapose.load_alphapose_store(str(tmp_path), normalization_strategy="robust",
                                       device="cpu")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            alphapose.load_alphapose_store(str(tmp_path))


# ---------------------------------------------------------------- Trainer


def _train_store(tmp_path, rng, num_transform=2):
    paths = _clip_files(tmp_path, rng, n_clips=1, n_frames=120)
    kw = dict(seg_len=6, seg_stride=2, kp18_format=False, vid_res=(856, 480),
              num_transform=num_transform)
    store = dp.build_store(_clips(paths), device="cpu", **kw)
    jstore = jdp.build_store([(s, c, jalphapose.parse_clip_json(p)) for s, c, p in paths], **kw)
    host = alphapose.load_alphapose_split(
        str(tmp_path), seg_len=6, seg_stride=2, kp18_format=False,
        normalization_strategy="markovitz", vid_res=[856, 480], num_transform=num_transform)
    return store, jstore, host


def _jax_config(fused_train="off", **opt):
    return jconfig.Config(
        model=jconfig.ModelConfig(variant="euclidean_dynamic", channels=(8, 4), h_dim=8,
                                  latent_dim=4),
        data=jconfig.DataConfig(seg_len=6, n_joints_override=17, kp18_format=False,
                                batch_size=32, num_transform=2),
        opt=jconfig.OptConfig(lr=1e-3, epochs=2, **opt),
        run=jconfig.RunConfig(fused_train=fused_train, ghost_size=8),
    )


def test_trainer_on_a_store_equals_the_windows_pipeline(tmp_path, rng):
    store, _, host = _train_store(tmp_path, rng)
    cfg = port_config(_jax_config())
    tr_store = Trainer(cfg, store, store, device="cpu")
    tr_win = Trainer(cfg, host, device="cpu")
    assert tr_store._pipeline == "store" and tr_win._pipeline == "windows"
    assert tr_store._window_shape_of(store) is None
    s1 = tr_store.initialize_center(tr_store.init_state())
    s2 = tr_win.initialize_center(tr_win.init_state())
    np.testing.assert_allclose(s1.center.numpy(), s2.center.numpy(), rtol=1e-4, atol=1e-5)
    sc1, _ = tr_store.score_all(s1, store, tr_store.train_data)
    sc2, _ = tr_win.score_all(s2, host, tr_win.train_data)
    np.testing.assert_allclose(sc1, sc2, rtol=1e-3, atol=1e-5)
    with pytest.raises(ValueError, match="same pipeline kind"):
        Trainer(cfg, store, host, device="cpu")
    with pytest.raises(ValueError, match="num_transform"):
        Trainer(cfg, dataclasses.replace(store, num_transform=4), device="cpu")


@pytest.mark.parametrize("fused_train", ["off", "on"])
def test_lockstep_fit_through_the_store_matches_jax_trainer(tmp_path, rng, fused_train):
    """Two epochs of fit through the store on both sides, from JAX's
    initial weights: per-step losses and the center after each epoch."""
    store, jstore, _ = _train_store(tmp_path, rng)
    cfg = _jax_config(fused_train)
    jlog = _capturing(JaxLogger)
    jtrainer = JaxTrainer(cfg, jstore, mesh=create_mesh(1, 1, devices=jax.devices()[:1]),
                          logger=jlog)
    jstate = jtrainer.initialize_center(jtrainer.init_state())
    log = _capturing(MetricLogger)
    trainer = Trainer(port_config(cfg), store, device="cpu", logger=log)
    load_jax_variables(trainer.model, jax.device_get(jstate.params),
                       jax.device_get(jstate.batch_stats))
    state = trainer.initialize_center(trainer.init_state())
    np.testing.assert_allclose(state.center.numpy(), np.asarray(jstate.center),
                               rtol=1e-4, atol=1e-6)
    assert trainer._fused_compat == (fused_train == "on")
    for epoch in range(2):
        jstate, jhist = jtrainer.fit(jstate, epochs=1)
        state, hist = trainer.fit(state, epochs=1)
        np.testing.assert_allclose(state.center.numpy(), np.asarray(jstate.center),
                                   rtol=1e-3, atol=1e-6, err_msg=f"center after epoch {epoch}")
    steps = 2 * (len(store) // 32)
    assert state.step == int(jstate.step) == steps
    assert len(log.losses) == len(jlog.losses) == steps
    np.testing.assert_allclose(log.losses, jlog.losses, rtol=1e-3)
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=1e-3)


# -------------------------------------------------------------------- CLI


def test_cli_device_pipeline_matches_windows_pipeline(tmp_path):
    """cli.train + cli.eval with device_pipeline: true (the store) against
    the windows pipeline, from the same seeded weights and index streams:
    the same losses and AUC within the float32-vs-float64 normalization
    noise (tests/test_cli_e2e.py's device-pipeline case holds two separate
    JAX runs to 0.05)."""
    cfg_path = make_synthetic_dataset(str(tmp_path), n_train_clips=1, n_test_clips=1)
    with open(cfg_path) as f:
        raw = yaml.safe_load(f)
    raw.update(channels=[8, 4, 8], h_dim=16, latent_dim=4, dataset_batch_size=64)
    with open(cfg_path, "w") as f:
        yaml.safe_dump(raw, f)
    base_run = train_cli.main(["--config", cfg_path, "--epochs", "2", "--device", "cpu"])
    base = eval_cli.main(["--config", cfg_path, "--device", "cpu"])
    raw.update(device_pipeline=True, dir_name="smoke_dev")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(raw, f)
    run = train_cli.main(["--config", cfg_path, "--epochs", "2", "--device", "cpu"])
    assert isinstance(run.trainer.train_ds, dp.TrajectoryStore)
    ev = eval_cli.main(["--config", cfg_path, "--device", "cpu"])
    assert os.path.exists(os.path.join(str(tmp_path), "checkpoints", "Synthetic", "smoke_dev",
                                       "best.ckpt"))
    np.testing.assert_allclose(run.loss, base_run.loss, rtol=1e-3)
    assert np.isfinite(ev.result.auc) and ev.result.auc > 0.6
    assert abs(ev.result.auc - base.result.auc) < 1e-3
