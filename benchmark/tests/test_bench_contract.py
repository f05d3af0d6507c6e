"""BENCHMARK.json against the benchmark's contract and its own files.

Run: python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16 and all(PATH.match(p) for p in bench["paths"])
    assert 1 <= len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    for word in bench["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        if os.path.exists(os.path.join(ROOT, word)):
            assert any(word.startswith(p + "/") for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    cells = len(bench["workloads"])
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert 1 <= cells <= 24


def test_names_units_and_lines(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        names.append(("config", c["name"]))
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        names.append(("cell", w["name"]))
    metrics = bench["end_to_end"] + bench["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(("metric", m["name"]))
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
    assert len(names) == len(set(names))
    assert len({n for k, n in names if k == "metric"}) == len(metrics)


def test_every_cell_reports_what_it_must(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"] == cells
    for cell in cells:
        assert any(cell in v for k, v in e2e.items() if k != "setup_s")
        assert any(cell in m.get("workloads", cells) for m in bench["per_layer"])
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= e2e[m["moves"]]


def test_files_found_by_name_agree(bench):
    from benchmark import harness

    configs = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        cell = harness.Cell(w["name"])
        assert {k: cell.spec[k] for k in ("config", "traffic", "chips", "why")} == {
            k: w[k] for k in ("config", "traffic", "chips", "why")}
        assert cell.config["reduced"] == configs[w["config"]]["reduced"]
        assert cell.config["source"] == configs[w["config"]]["source"]
        assert cell.kind.ENTRY == cell.spec["entry"]
    for m in bench["per_layer"]:
        reader = harness.load_module(os.path.join(BENCH, "metrics", f"{m['name']}.py"), "r")
        assert (reader.LAYER, reader.UNIT, reader.MOVES) == (m["layer"], m["unit"], m["moves"])
    used = {w["config"] for w in bench["workloads"]}
    assert used == set(configs)


def test_hrstc_config_is_the_shipped_file_but_for_its_cuts():
    """The hrstc config builds the port's Config the shipped YAML builds,
    except for what `reduced` names."""
    import dataclasses

    from coskad_tpu_torch.config import from_reference_dict, from_reference_yaml

    with open(os.path.join(BENCH, "configs", "hrstc.json")) as f:
        conf = json.load(f)
    shipped = dataclasses.asdict(from_reference_yaml(
        os.path.join(ROOT, "config", "HR-STC", "euclidean_encoder.yaml")))
    ours = dataclasses.asdict(from_reference_dict(conf["reference"]))
    differ = {(s, k) for s in shipped for k in shipped[s] if shipped[s][k] != ours[s][k]}
    assert differ == {("data", "pose_dirs"), ("data", "path_to_robust"), ("data", "gt_dir"),
                      ("data", "val_gt_dir"), ("opt", "validation")}
    assert {"data_dir", "dataset_path_to_robust", "test_path", "validation"} <= set(conf["reduced"])


def _top_level_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600,
                         env=dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_no_jax_in_a_run():
    """A whole (small, CPU) run loads neither JAX nor the JAX package nor the
    chip check, compared by whole top-level module names."""
    code = (
        "import json, sys, time\n"
        "from benchmark import harness\n"
        "from benchmark.tests.small import SMALL\n"
        "harness.run_cell('hrstc-requests', 7, 0.2, False, time.monotonic(), device='cpu',"
        " patch=SMALL)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    tops = _top_level_after(code)
    assert "coskad_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "coskad_tpu", "chip_smoke"}


def test_reference_imports_nothing_of_the_program():
    code = ("import json, sys\nimport benchmark.reference.stse\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    tops = _top_level_after(code)
    assert not tops & {"coskad_tpu_torch", "coskad_tpu", "jax", "chip_smoke"}
