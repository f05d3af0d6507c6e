"""The benchmark's runner: one cell, one seed, one fresh process.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is found by name in files of its own:

  BENCHMARK.json                 the cells, the metrics and which cells report them
  benchmark/workloads/<cell>.json   config, traffic, chips, why, entry, limits
  benchmark/configs/<config>.json   source, reduced, assumed, the dataset and the
                                    port's config keys (`reference`)
  benchmark/traffic/<mix>.json      a traffic mix: its kind and parameters
  benchmark/traffic/<kind>.py       the generator and the loop of that kind
  benchmark/metrics/<metric>.py     a per-layer reader: LAYER, UNIT, MOVES, read(ctx)
  benchmark/work/<config>.py        the frozen operation and byte counts
  benchmark/peaks.json              the card's published peaks

A run: set-up (inputs and weights from the seed, the program built and
warmed on the cell's own shapes; `setup_s` runs from the process's start to
here), the measured window, with `--trace 1` a profiler window after it,
the device's peak memory, then the program freed and the plain reference
run to decide `correct`. The last line of standard output is the result.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from types import ModuleType
from typing import Optional

from benchmark import devtrace

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "coskad_tpu", "chip_smoke")


class BenchError(RuntimeError):
    """A run that cannot give a result."""


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise BenchError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def merged(base: dict, patch: Optional[dict]) -> dict:
    """base with patch's keys replaced, nested dicts merged key by key."""
    out = dict(base)
    for k, v in (patch or {}).items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


class Cell:
    """A cell's files, found by its name."""

    def __init__(self, name: str, patch: Optional[dict] = None):
        patch = patch or {}
        self.name = name
        self.bench = load_json(ROOT, "BENCHMARK.json")
        self.spec = merged(load_json(BENCH, "workloads", f"{name}.json"), patch.get("cell"))
        self.config = merged(load_json(BENCH, "configs", f"{self.spec['config']}.json"),
                             patch.get("config"))
        mix = load_json(BENCH, "traffic", f"{self.spec['traffic']}.json")
        self.mix = merged(mix, (patch.get("mix") or {}).get(mix["kind"]))
        self.kind = load_module(os.path.join(BENCH, "traffic", f"{self.mix['kind']}.py"),
                                f"bench_traffic_{self.mix['kind']}")
        self.work = load_module(os.path.join(BENCH, "work", f"{self.spec['config']}.py"),
                                f"bench_work_{self.spec['config']}")
        self.peaks = load_json(BENCH, "peaks.json")
        unknown = set(self.mix) - {"kind"} - set(self.kind.MIX_KEYS)
        if unknown:
            raise BenchError(f"traffic kind {self.mix['kind']} reads no "
                             f"{', '.join(sorted(unknown))} (mix {self.spec['traffic']})")
        if self.kind.ENTRY != self.spec["entry"]:
            raise BenchError(f"cell {name} drives {self.spec['entry']} but traffic kind "
                             f"{self.mix['kind']} drives {self.kind.ENTRY}")

    def faults(self) -> tuple:
        """The faults of benchmark/faults.py this cell can have."""
        return tuple(self.kind.faults(self.config))

    def metrics(self, section: str) -> list:
        """The BENCHMARK.json metrics of `section` this cell reports."""
        return [m for m in self.bench[section] if self.name in m.get("workloads", [self.name])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_cell(name: str, seed: int, seconds: float, trace: bool, started: float,
             device: str = "cuda", patch: Optional[dict] = None, limits: Optional[dict] = None
             ) -> dict:
    """One run of a cell; returns the result object. `device` "cpu" and a
    `patch` of the cell's files serve the benchmark's own tests, which
    drive every step but the look for a card at a small size: its
    "config" and "cell" parts are merged into every cell's files, its
    "mix" part holds a patch for each traffic kind by the kind's name."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = Cell(name, patch)
    chips = int(cell.spec["chips"])
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise BenchError(f"cell {name} needs {chips} CUDA device(s); "
                             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                             "available")
    run = cell.kind.Run(cell, seed, torch.device(device))
    run.setup()
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.monotonic() - started
    gc.collect()
    collections = sum(g["collections"] for g in gc.get_stats())
    stats = run.window(seconds)
    collections = sum(g["collections"] for g in gc.get_stats()) - collections
    ends = stats.get("parts_s", [])
    parts = sorted(b - a for a, b in zip([0.0] + ends, ends))
    if parts:
        print(f"window: {len(parts)} epochs or passes, shortest {parts[0]:.4f} s, median "
              f"{parts[len(parts) // 2]:.4f} s, longest {parts[-1]:.4f} s; "
              f"{collections} garbage collections", file=sys.stderr)
    traced = _trace(run) if trace else None
    memory_peak = int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0
    found = forbidden_modules()
    if found:
        raise BenchError("the process holds " + ", ".join(found) + " after the window")
    device_info = {
        "platform": "gpu" if device == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
        "count": chips, "memory_peak_bytes": memory_peak,
    }
    route = run.route()
    program = run.program_readings()
    run.free()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    reference = run.reference_readings("exact")
    numbers = run.compare(program, reference)
    limits = limits if limits is not None else cell.spec["limits"]
    for k, v in numbers.items():
        if k not in limits:
            print(f"reading {k}: {v!r} (not compared)", file=sys.stderr)
    checks = {k: {"value": numbers.get(k, math.nan), "limit": v} for k, v in limits.items()}
    correct = (stats["failed"] == 0
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in checks.values()))
    result = {"correct": bool(correct), "attempted": int(stats["attempted"]),
              "failed": int(stats["failed"])}
    if traced is None:
        values = dict(stats["end_to_end"], setup_s=setup_s)
        wanted = cell.metrics("end_to_end")
        missing = [m["name"] for m in wanted if m["name"] not in values]
        if missing:
            raise BenchError(f"cell {name} measured no {', '.join(missing)}")
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in wanted}
    else:
        trace_obj, units = traced[:2]
        ctx = dict(trace=trace_obj, units=units, window=stats,
                   config=cell.config, work=cell.work, peaks=cell.peaks)
        result["metrics"] = {}
        for m in cell.metrics("per_layer"):
            reader = load_module(os.path.join(BENCH, "metrics", f"{m['name']}.py"),
                                 f"bench_metric_{m['name'].replace('.', '_')}")
            value = reader.read(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=devtrace.busy_s(trace_obj), window_s=trace_obj.window_s)
        result["breakdown"] = devtrace.breakdown(trace_obj, traced[2])
    if device == "cuda":
        device_info["power"] = power_limit()
    result["device"] = device_info
    result["route"] = route
    result["checks"] = checks
    return result


def _trace(run):
    """The device's trace of one traced call, its units, and the host's
    trace of a second call."""
    fn, units = run.traced()
    device_trace = devtrace.capture(fn, host=False)
    host_fn, _ = run.traced()
    return device_trace, units, devtrace.capture(host_fn, host=True)


def report(result: dict) -> None:
    """Each compared number beside its limit, last on standard error, then
    the result as the last line of standard output."""
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
