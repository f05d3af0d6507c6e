"""Ingest: the port's robust normalization, AlphaPose and Morais-CSV loaders,
reference-config reader and scaler pickles against the JAX package's, on
the same files.

Tolerances: float64 normalization within 1e-12 (the same numpy operations
in the same order); windows, metadata and frame ids equal; configs equal
field for field; the YAML reader's dicts equal to yaml.safe_load's, value
type included, or a refusal naming the line."""

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
    # without pyyaml, JSON and YAML both load (the port never imports it)
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert dataclasses.asdict(tconfig.from_reference_yaml(as_json)) == want
    assert dataclasses.asdict(tconfig.from_reference_yaml(path)) == want


def test_shipped_yaml_reads_without_pyyaml_as_safe_load_and_jax_read_it():
    """In a process where `import yaml` fails, the port's reader gives each
    shipped file's yaml.safe_load dict, and its Config equals the JAX
    package's field by field."""
    code = (
        "import dataclasses, json, sys\n"
        "sys.modules['yaml'] = None\n"
        "from coskad_tpu_torch import config\n"
        "try:\n"
        "    import yaml\n"
        "    raise SystemExit('yaml imported')\n"
        "except ImportError:\n"
        "    pass\n"
        f"paths = {CONFIGS!r}\n"
        "out = {p: [config.parse_reference_yaml(open(p).read(), p),\n"
        "           dataclasses.asdict(config.from_reference_yaml(p))] for p in paths}\n"
        "print(json.dumps(out))\n"
    )
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
    assert run.returncode == 0, run.stderr
    got = json.loads(run.stdout)
    assert len(CONFIGS) == 8 and sorted(got) == CONFIGS
    import yaml

    for path in CONFIGS:
        raw, cfg = got[path]
        with open(path) as f:
            assert raw == json.loads(json.dumps(yaml.safe_load(f))), path
        want = json.loads(json.dumps(dataclasses.asdict(jconfig.from_reference_yaml(path))))
        assert sorted(cfg) == sorted(want)
        for section in want:
            for name, value in want[section].items():
                assert cfg[section][name] == value, (path, section, name)


# plain values as a config would write them; None marks one the subset refuses
YAML_VALUES = ["1.0e-06", "1e-06", "1.e-6", "1.0e6", "0.0001", "-1.5e+3", ".5", "-.5", "3.",
               "+1", "-1", "0", "-0", "on", "off", "yes", "No", "TRUE", "y", "~", "null", "",
               "+.inf", "-.inf", ".NaN", "0o7", "a#b", "/path/to/x # a comment", "C:/x",
               "-a", "HR-STC", "./checkpoints", "'it''s'", '"x y"', "[32, 16, 32]", "[]",
               "[856, 480]  # w, h", "[a, 1.5, off]",
               "012", "00", "1_000", "0x1f", "1:30", "2001-12-14", "a: b", "[1,,2]", "[[1]]",
               "&a x", "*a", "!!str x", "- a", "x:", "{a: 1}", "|", ">", "%x", "@x", "`x",
               "[1, 2", "'x' y", '"a\\nb"', "['a']"]


@pytest.mark.parametrize("value", YAML_VALUES)
def test_yaml_reader_reads_a_value_as_safe_load_or_refuses_it(value):
    import yaml

    text = f"# a config\n\nkey: {value}\n"
    try:
        want = yaml.safe_load(text)["key"]
    except yaml.YAMLError:
        want = None
    try:
        got = tconfig.parse_reference_yaml(text, "c.yaml")["key"]
    except tconfig.YamlSubsetError as e:
        assert str(e).startswith("c.yaml:3"), e
        return
    assert type(got) is type(want) and (got == want or (got != got and want != want)), \
        (got, want)


def test_yaml_reader_reads_what_safe_dump_writes(tmp_path):
    """Block lists and quoted strings as yaml.safe_dump writes them (the
    test fixtures' configs), to the dict written."""
    import yaml

    raw = yaml.safe_load(open(make_synthetic_dataset(str(tmp_path), n_frames=40)))
    raw.update(empty="", flag_word="yes", exponent="1e-06", none=None, neg=-3, words="a b")
    text = yaml.safe_dump(raw)
    assert "channels:\n- 32\n" in text
    assert tconfig.parse_reference_yaml(text) == raw


@pytest.mark.parametrize("text", [
    "a: 1\n  b: 2\n",  # nesting
    "a:\n- - 1\n",  # a list in a list
    "a:\n- 1\n  - 2\n",  # list items of two indents
    "a: 1\n- 2\n",  # a list item after a value
    "---\na: 1\n",  # a document marker
    "a: 1\na: 2\n",  # a key given twice
    "a: [1,\n  2]\n",  # a list over two lines
    "\ta: 1\n",  # a tab
    "a:1\n",  # no space after the colon
    "1: a\n",  # a key that is not an identifier
    "# nothing\n",  # no key
], ids=["nested", "list_in_list", "two_indents", "item_after_value", "document", "duplicate",
        "multiline_list", "tab", "no_space", "int_key", "empty"])
def test_yaml_reader_refuses_lines_outside_its_subset(text):
    with pytest.raises(tconfig.YamlSubsetError, match=r"^c\.yaml"):
        tconfig.parse_reference_yaml(text, "c.yaml")


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
