"""Ingest: the port's robust normalization, AlphaPose and Morais-CSV loaders,
reference-config reader and scaler pickles against the JAX package's, on
the same files.

Tolerances: float64 normalization within 1e-12 (the same numpy operations
in the same order); windows, metadata and frame ids equal; configs equal
field for field."""

import dataclasses
import glob
import json
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from coskad_tpu import config as jconfig
from coskad_tpu.cli import common as jcommon
from coskad_tpu.data import alphapose as jalphapose
from coskad_tpu.data import normalize as jnormalize
from coskad_tpu.data import robust as jrobust
from coskad_tpu_torch import config as tconfig
from coskad_tpu_torch.cli import common
from coskad_tpu_torch.data import alphapose, normalize, robust
from fixtures import make_synthetic_dataset
from test_robust_pipeline import _write_csv_tree

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "config", "*", "*.yaml")))
NORM_TOL = dict(rtol=1e-12, atol=1e-12)


def raw_windows(seed=0, n=40):
    """[N, T, V, 3] pixel keypoints with some exact zeros (missing joints)."""
    rng = np.random.default_rng(seed)
    pose = np.concatenate([rng.uniform(10, 800, size=(n, 12, 18, 2)),
                           rng.uniform(0.2, 1, size=(n, 12, 18, 1))], -1)
    pose[..., :2][rng.random((n, 12, 18, 2)) < 0.1] = 0.0
    return pose


@pytest.mark.parametrize("fitted", [False, True], ids=["fit", "given_scaler"])
def test_normalize_robust_matches_jax(fitted):
    pose = raw_windows()
    jscaler = None
    if fitted:  # the scaler of other windows, as a test split gets the training one
        _, jscaler = jnormalize.normalize(raw_windows(1), "robust", vid_res=(856, 480))
    scaler = None if jscaler is None else normalize.RobustScalerState(jscaler.center,
                                                                      jscaler.scale)
    got, got_scaler = normalize.normalize(pose, "robust", vid_res=(856, 480), scaler=scaler)
    want, want_scaler = jnormalize.normalize(pose, "robust", vid_res=(856, 480),
                                             scaler=jscaler)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_allclose(got, want, **NORM_TOL)
    np.testing.assert_allclose(got_scaler.center, want_scaler.center, **NORM_TOL)
    np.testing.assert_allclose(got_scaler.scale, want_scaler.scale, **NORM_TOL)
    flat = got[..., :2].reshape(-1, 36)
    np.testing.assert_allclose(got_scaler.inverse_transform(got_scaler.transform(flat)), flat,
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("strategy", ["markovitz", "robust", "stan", "bbox"])
def test_load_alphapose_split_matches_jax(tmp_path, strategy):
    make_synthetic_dataset(str(tmp_path), n_frames=120)
    pose_dir = str(tmp_path / "pose" / "training")
    kw = dict(seg_len=12, seg_stride=3, normalization_strategy=strategy, kp_threshold=0.6,
              num_transform=5)
    got = alphapose.load_alphapose_split(pose_dir, **kw)
    want = jalphapose.load_alphapose_split(pose_dir, **kw)
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.meta, want.meta)
    np.testing.assert_array_equal(got.frame_ids, want.frame_ids)
    assert (got.scaler is None) == (want.scaler is None) == (strategy != "robust")
    # a given scaler is used as is, e.g. the training scaler on a test split
    if strategy == "robust":
        test_dir = str(tmp_path / "pose" / "testing")
        got_t = alphapose.load_alphapose_split(test_dir, scaler=got.scaler, **kw)
        want_t = jalphapose.load_alphapose_split(test_dir, scaler=want.scaler, **kw)
        assert got_t.scaler is got.scaler
        np.testing.assert_array_equal(got_t.data, want_t.data)
    assert alphapose.scene_clip_from_filename("03_0017_alphapose.json") == (3, 17)


@pytest.mark.parametrize("include_global", [False, True], ids=["local", "global"])
def test_load_robust_split_matches_jax(tmp_path, include_global):
    """Train split (fits and pickles the scalers) and test split (reads
    them), each package in its own experiment directory; then the port's
    test split from the JAX package's pickles."""
    root = str(tmp_path)
    _write_csv_tree(root, split="training", n_frames=40)
    _write_csv_tree(root, split="testing", n_frames=40, seed=3)
    kw = dict(seg_len=6, seg_stride=2, vid_res=[856, 480], include_global=include_global,
              num_transform=2)
    for split in ("train", "test"):
        got = robust.load_robust_split(root, split=split, exp_dir=str(tmp_path / "port"), **kw)
        want = jrobust.load_robust_split(root, split=split, exp_dir=str(tmp_path / "jax"), **kw)
        np.testing.assert_array_equal(got.data, want.data)
        np.testing.assert_array_equal(got.meta, want.meta)
        np.testing.assert_array_equal(got.frame_ids, want.frame_ids)
        np.testing.assert_array_equal(got.scaler.center, want.scaler.center)
    cross = robust.load_robust_split(root, split="test", exp_dir=str(tmp_path / "jax"), **kw)
    np.testing.assert_array_equal(cross.data, want.data)
    assert type(cross.scaler) is normalize.RobustScalerState
    assert not robust.load_robust_split(root, split="train", exp_dir=str(tmp_path / "none"),
                                        is_primary=False, **kw).scaler
    assert not os.path.exists(tmp_path / "none")


def port_config(cfg):
    return tconfig.Config(
        model=tconfig.ModelConfig(**dataclasses.asdict(cfg.model)),
        data=tconfig.DataConfig(**dataclasses.asdict(cfg.data)),
        opt=tconfig.OptConfig(**dataclasses.asdict(cfg.opt)),
        eval=tconfig.EvalConfig(**dataclasses.asdict(cfg.eval)),
        run=tconfig.RunConfig(**dataclasses.asdict(cfg.run)),
    )


def yaml_safe_json(raw) -> str:
    """JSON whose exponent floats carry a dot (1.0e-06): PyYAML, which the
    JAX package reads JSON with, takes a dotless 1e-06 for a string."""
    return re.sub(r"(?<![\d.])(\d+)e([-+]\d+)", r"\1.0e\2", json.dumps(raw))


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.relpath(p, ROOT) for p in CONFIGS])
def test_reference_configs_read_as_jax_reads_them(tmp_path, path, monkeypatch):
    want = dataclasses.asdict(jconfig.from_reference_yaml(path))
    assert dataclasses.asdict(tconfig.from_reference_yaml(path)) == want
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    as_json = str(tmp_path / "config.json")
    with open(as_json, "w") as f:
        f.write(yaml_safe_json(raw))
    assert dataclasses.asdict(jconfig.from_reference_yaml(as_json)) == want
    assert dataclasses.asdict(tconfig.from_reference_yaml(as_json)) == want
    # without pyyaml, JSON still loads and YAML is refused naming it
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert dataclasses.asdict(tconfig.from_reference_yaml(as_json)) == want
    with pytest.raises(ImportError, match="pyyaml"):
        tconfig.from_reference_yaml(path)


def test_reference_dict_derives_the_validation_layout(tmp_path):
    data_dir = str(tmp_path)
    os.makedirs(os.path.join(data_dir, "validating", "test_frame_mask"))
    for raw in ({"dataset_choice": "UBnormal", "data_dir": data_dir, "validation": True},
                {"dataset_choice": "HR-Avenue", "data_dir": data_dir, "validation": True,
                 "use_hr": True, "static_center": False, "debug": True},
                {"use_vae": True, "distance": "poincare", "dataset_double_item": True}):
        assert dataclasses.asdict(tconfig.from_reference_dict(raw)) == \
            dataclasses.asdict(jconfig.from_reference_dict(raw))
    # a JSON config's dotless exponent is the number it says
    path = str(tmp_path / "c.json")
    with open(path, "w") as f:
        json.dump({"alpha": 1e-6, "opt_lr": 2e-5}, f)
    cfg = tconfig.from_reference_yaml(path)
    assert (cfg.opt.alpha, cfg.opt.lr) == (1e-6, 2e-5)


def test_jax_robust_pkl_loads_without_the_jax_package(tmp_path):
    """cli.common's robust.pkl written by the JAX package: the port reads it
    in a process that then holds neither coskad_tpu nor jax, and the test
    split it normalizes equals the JAX package's."""
    cfg_path = make_synthetic_dataset(str(tmp_path), n_frames=120)
    cfg = jconfig.from_reference_yaml(cfg_path)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, normalization_strategy="robust"))
    jtrain = jcommon.load_split(cfg, "train")
    pkl = os.path.join(cfg.ckpt_dir, "robust.pkl")
    assert os.path.exists(pkl)
    got = common.load_split(port_config(cfg), "test", stride=1)
    want = jcommon.load_split(cfg, "test", stride=1)
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.scaler.center, jtrain.scaler.center)

    code = (
        "import sys\n"
        "from coskad_tpu_torch.data.robust import load_scaler\n"
        f"s = load_scaler({pkl!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'coskad_tpu'))\n"
        "print(type(s).__module__, s.center.shape, ','.join(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["coskad_tpu_torch.data.normalize",
                                  f"({jtrain.scaler.center.shape[0]},)"]


def test_scaler_pickle_naming_another_global_is_refused(tmp_path):
    class Evil:
        def __reduce__(self):
            return (os.getcwd, ())

    path = str(tmp_path / "evil.pkl")
    with open(path, "wb") as f:
        pickle.dump(Evil(), f)
    with pytest.raises(pickle.UnpicklingError, match="may not name"):
        robust.load_scaler(path)
