"""The port's native clip and CSV parser (`coskad_tpu_torch/data/native.py`,
built from `coskad_tpu_torch/data/csrc/`) against the port's own `json.load`
/ numpy paths and against the JAX package's parser, on the cases of
tests/test_native_parser.py. Every comparison is exact (array_equal):
both parsers read each number with strtod into float64, and CSVs go
float64 -> float32 as the JAX package's native path does."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from coskad_tpu.data import alphapose as jalphapose
from coskad_tpu.data import native as jnative
from coskad_tpu.data import trajectories as jtrajectories
from coskad_tpu_torch.data import alphapose, native, trajectories

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_extension_builds_into_the_ports_build_dir():
    native_dir = os.path.join(ROOT, "native")
    before = sorted(os.listdir(native_dir))
    assert native.native_available()
    assert os.path.dirname(native.SO) == os.path.join(ROOT, "build", "coskad_tpu_torch")
    assert os.path.basename(native.SO).startswith("_coskad_torch_native")
    assert os.path.exists(native.SO)
    assert native.SRC == os.path.join(ROOT, "coskad_tpu_torch", "data", "csrc",
                                      "coskad_native.cpp")
    assert native._load_native().__name__ == "_coskad_torch_native"
    assert sorted(os.listdir(native_dir)) == before


def _parse_all(path, monkeypatch, kp_threshold=0.0):
    """(port native, port json.load path, JAX) parses of one clip."""
    got = native.parse_clip_json_native(str(path), kp_threshold)
    assert got is not None
    via_entry = alphapose.parse_clip_json(str(path), kp_threshold)
    with monkeypatch.context() as m:
        m.setenv("COSKAD_NATIVE", "0")
        plain = alphapose.parse_clip_json(str(path), kp_threshold)
    ref = jalphapose.parse_clip_json(str(path), kp_threshold)
    for other in (via_entry, plain, ref):
        assert len(got) == len(other)
        for a, b in zip(got, other):
            assert a.person_id == b.person_id
            assert a.frame_keys == b.frame_keys
            assert a.keypoints.dtype == b.keypoints.dtype == np.float64
            np.testing.assert_array_equal(a.keypoints, b.keypoints)
    return got


def test_basic_clip(tmp_path, rng, monkeypatch):
    clip = {}
    for pid in ("1", "7", "12"):  # numeric person order, not lexicographic
        frames = {}
        for f in rng.permutation(range(3, 40))[:25]:
            frames[f"{f:04d}"] = {"keypoints": rng.uniform(-10, 900, size=51).tolist()}
        clip[pid] = frames
    path = tmp_path / "c.json"
    path.write_text(json.dumps(clip))
    got = _parse_all(path, monkeypatch)
    assert [t.person_id for t in got] == [1, 7, 12]


def test_list_person_form_and_extra_fields(tmp_path, rng, monkeypatch):
    kp1, kp2, kp2b = (rng.normal(size=51).tolist() for _ in range(3))
    clip = {"2": [
        {"0001": {"keypoints": kp1, "scores": [0.1, 0.2],
                  "box": {"x": 1, "y": [2, {"z": None}]},
                  "flag": True, "no": False, "note": "a \"quoted\" étape \\/"}},
        {"0002": {"keypoints": kp2}, "0001": {"keypoints": kp2b}},
    ]}
    path = tmp_path / "c.json"
    path.write_text(json.dumps(clip))
    got = _parse_all(path, monkeypatch)
    np.testing.assert_array_equal(got[0].keypoints[0].reshape(-1), kp2b)  # later key won


def test_number_formats(tmp_path, monkeypatch):
    vals = [1, -2.5, 1e-8, -3.25e4, 0.0, 12345678.9, 0.1, 1 / 3, 2.5e-310]
    kp = (vals * 6)[:51]
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"1": {"0005": {"keypoints": kp}}}))
    got = _parse_all(path, monkeypatch)
    np.testing.assert_array_equal(got[0].keypoints.reshape(-1), kp)


def test_kp_threshold(tmp_path, rng, monkeypatch):
    kp = rng.uniform(0, 1, size=(17, 3))
    kp[:, 2] = np.linspace(0, 1, 17)
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"1": {"0001": {"keypoints": kp.reshape(-1).tolist()}}}))
    got = _parse_all(path, monkeypatch, kp_threshold=0.5)
    assert (got[0].keypoints[0][kp[:, 2] < 0.5, :2] == 0).all()
    assert (got[0].keypoints[0][kp[:, 2] >= 0.5, :2] != 0).all()


def test_zero_detection_persons_are_skipped(tmp_path, rng, monkeypatch):
    kp = rng.normal(size=51).tolist()
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"3": {}, "4": [{}, {}], "5": {"0001": {"keypoints": kp}}}))
    got = _parse_all(path, monkeypatch)
    assert [t.person_id for t in got] == [5]


def test_duplicate_toplevel_person_matches_json_load(tmp_path, rng, monkeypatch):
    kp_a = json.dumps(rng.normal(size=51).tolist())
    kp_b = json.dumps(rng.normal(size=51).tolist())
    path = tmp_path / "dup.json"
    path.write_text('{"7": {"0001": {"keypoints": %s}}, "7": {"0002": {"keypoints": %s}}}'
                    % (kp_a, kp_b))
    got = _parse_all(path, monkeypatch)
    assert got[0].frame_keys == [2]  # only the last occurrence survives


def test_malformed_json_raises(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text('{"1": {"0001": {"keypoints": [1, 2, }}}')
    with pytest.raises(ValueError, match="offset"):
        native.parse_clip_json_native(str(path))
    with pytest.raises(ValueError):
        alphapose.parse_clip_json(str(path))


def test_coskad_native_0_takes_the_json_path(tmp_path, rng, monkeypatch):
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"1": {"0001": {"keypoints": rng.normal(size=51).tolist()}}}))

    def refuse(*_):
        raise AssertionError("the native parser ran under COSKAD_NATIVE=0")

    monkeypatch.setattr(native, "parse_clip_json_native", refuse)
    monkeypatch.setattr(native, "load_csv_files_native", refuse)
    monkeypatch.setenv("COSKAD_NATIVE", "0")
    assert alphapose.parse_clip_json(str(path))[0].person_id == 1
    folder = tmp_path / "traj" / "1-1"
    folder.mkdir(parents=True)
    (folder / "0001.csv").write_text("1,2.5,3\n2,4,5\n")
    assert list(trajectories.load_trajectories(str(tmp_path / "traj"))) == ["1-1_0001"]
    monkeypatch.delenv("COSKAD_NATIVE")
    with pytest.raises(AssertionError, match="COSKAD_NATIVE=0"):
        alphapose.parse_clip_json(str(path))


def test_load_split_same_with_and_without_native(tmp_path, rng, monkeypatch):
    d = tmp_path / "train"
    d.mkdir()
    clip = {pid: {f"{f:04d}": {"keypoints": rng.uniform(10, 400, size=51).tolist()}
                  for f in range(1, 40)} for pid in ("1", "2")}
    (d / "01_0001_t.json").write_text(json.dumps(clip))
    got = alphapose.load_alphapose_split(str(d), seg_len=12, seg_stride=4)
    monkeypatch.setenv("COSKAD_NATIVE", "0")
    plain = alphapose.load_alphapose_split(str(d), seg_len=12, seg_stride=4)
    for k in ("data", "meta", "frame_ids"):
        np.testing.assert_array_equal(getattr(got, k), getattr(plain, k))


# ------------------------------------------------------------------ CSVs


def test_csv_parser_matches_loadtxt_and_jax(tmp_path, rng):
    arr = rng.normal(size=(40, 35))
    arr[:, 0] = np.arange(1, 41)
    path = tmp_path / "t.csv"
    np.savetxt(path, arr, delimiter=",", fmt="%.8f")
    got = native.load_csv_native(str(path))
    np.testing.assert_array_equal(got, np.loadtxt(str(path), delimiter=",", ndmin=2))
    np.testing.assert_array_equal(got, jnative.load_csv_native(str(path)))


def test_csv_parser_scientific_and_blank_lines(tmp_path):
    (tmp_path / "t.csv").write_text("1,2.5e-3,-4\n\n2,3.25E2,0.0\n\r\n")
    out = native.load_csv_native(str(tmp_path / "t.csv"))
    np.testing.assert_array_equal(out, [[1, 2.5e-3, -4], [2, 325.0, 0.0]])


def test_csv_parser_ragged_raises(tmp_path):
    (tmp_path / "t.csv").write_text("1,2,3\n4,5\n")
    with pytest.raises(ValueError, match="ragged"):
        native.load_csv_native(str(tmp_path / "t.csv"))


def test_parse_csv_files_batched(tmp_path, rng):
    paths = []
    for i in range(7):
        n = 5 + i
        arr = np.concatenate([np.arange(1, n + 1)[:, None], rng.uniform(-5, 5, size=(n, 4))],
                             axis=1)
        p = tmp_path / f"{i:04d}.csv"
        np.savetxt(p, arr, delimiter=",", fmt="%.7g")
        paths.append(str(p))
    out = native.load_csv_files_native(paths, n_threads=3)
    ref = jnative.load_csv_files_native(paths, n_threads=2)
    assert len(out) == len(ref) == 7
    for p, a, b in zip(paths, out, ref):
        np.testing.assert_array_equal(a, np.loadtxt(p, delimiter=",", ndmin=2))
        np.testing.assert_array_equal(a, b)


def test_parse_csv_files_error_names_file(tmp_path):
    good = tmp_path / "good.csv"
    good.write_text("1,2\n3,4\n")
    bad = tmp_path / "bad.csv"
    bad.write_text("1,2\n3\n")
    with pytest.raises(ValueError, match="bad.csv"):
        native.load_csv_files_native([str(good), str(bad)])
    with pytest.raises(ValueError, match="missing.csv"):
        native.load_csv_files_native([str(tmp_path / "missing.csv")])


def _trajectory_tree(root, rng):
    for folder, n_files in (("1-1", 3), ("2-4", 2)):
        base = root / folder
        base.mkdir(parents=True)
        for i in range(n_files):
            n = 12 + i
            arr = np.concatenate([np.arange(1, n + 1)[:, None],
                                  rng.uniform(0, 800, size=(n, 34))], axis=1)
            np.savetxt(base / f"{i:04d}.csv", arr, delimiter=",", fmt="%.6f")


@pytest.mark.parametrize("route", ["batched", "loadtxt", "no_toolchain"])
def test_load_trajectories_matches_jax(tmp_path, rng, monkeypatch, route):
    """Each reading route equals the JAX package's native route exactly
    (float64 -> float32), in the same os.listdir order: the batched native
    reader, COSKAD_NATIVE=0, and an extension that did not build."""
    _trajectory_tree(tmp_path, rng)
    monkeypatch.delenv("COSKAD_NATIVE", raising=False)
    ref = jtrajectories.load_trajectories(str(tmp_path))
    if route == "loadtxt":
        monkeypatch.setenv("COSKAD_NATIVE", "0")
    elif route == "no_toolchain":
        monkeypatch.setattr(native, "load_csv_files_native", lambda paths: None)
    got = trajectories.load_trajectories(str(tmp_path))
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].coordinates.dtype == np.float32
        np.testing.assert_array_equal(got[k].coordinates, ref[k].coordinates)
        np.testing.assert_array_equal(got[k].frames, ref[k].frames)


def test_two_processes_building_at_once_both_load(tmp_path):
    """Two processes that find no library build at once into the same
    directory; each compiles to its own name and moves it into place, so
    both load the extension and parse."""
    clip = tmp_path / "c.json"
    clip.write_text(json.dumps({"1": {"0001": {"keypoints": [1.5] * 51}}}))
    build = tmp_path / "build"
    code = (
        "import os, sys\n"
        "from coskad_tpu_torch.data import native\n"
        f"native.BUILD_DIR = {str(build)!r}\n"
        "native.SO = os.path.join(native.BUILD_DIR, os.path.basename(native.SO))\n"
        f"t = native.parse_clip_json_native({str(clip)!r})\n"
        "assert t is not None and t[0].keypoints.shape == (1, 17, 3), t\n"
        "print('loaded', native._load_native().__name__)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=180)
        assert p.returncode == 0, err
        assert "loaded _coskad_torch_native" in out and "unavailable" not in err
    assert [f for f in os.listdir(build) if f.endswith(".tmp")] == []
    assert os.listdir(build) == [os.path.basename(native.SO)]
