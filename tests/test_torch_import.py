"""The port's import boundary: torch and numpy only, never jax or coskad_tpu,
and no silent CPU fallback for a default device="cuda" entry point."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN_TOP = ("jax", "jaxlib", "flax", "optax", "msgpack", "yaml", "coskad_tpu")


def test_import_pulls_in_no_jax_and_no_reference_package():
    code = (
        "import sys\n"
        "import coskad_tpu_torch, coskad_tpu_torch.serve, coskad_tpu_torch.train.loop\n"
        "import coskad_tpu_torch.kernels, coskad_tpu_torch.interop\n"
        "import coskad_tpu_torch.cli.train, coskad_tpu_torch.cli.eval\n"
        "import coskad_tpu_torch.train.checkpoint, coskad_tpu_torch.data.robust\n"
        "import coskad_tpu_torch.geometry.poincare, coskad_tpu_torch.config\n"
        "import coskad_tpu_torch.geometry.sphere, coskad_tpu_torch.score.window_losses\n"
        "import coskad_tpu_torch.models.encoders, coskad_tpu_torch.models.graph\n"
        "import coskad_tpu_torch.streaming, coskad_tpu_torch.http_server\n"
        "import coskad_tpu_torch.cli.serve, coskad_tpu_torch.cli.server\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN_TOP!r})\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"port imported {out.stdout.strip()}"


def _python_sources():
    paths = [os.path.join(ROOT, f) for f in ("chip_smoke.py", "k1_variants.py",
                                             "probe_variants.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "coskad_tpu_torch")):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(paths)


_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(jax|jaxlib|flax|optax|msgpack|yaml|coskad_tpu)(?![\w])",
    re.MULTILINE)


def test_static_scan_finds_no_forbidden_import():
    sources = _python_sources()
    assert len(sources) > 20 and sources[0].endswith("chip_smoke.py")
    offenders = []
    for path in sources:
        with open(path) as f:
            text = f.read()
        offenders += [f"{os.path.relpath(path, ROOT)}: {m.group(0).strip()}"
                      for m in _IMPORT.finditer(text)]
    assert offenders == []


def test_default_cuda_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without CUDA")
    from coskad_tpu_torch import resolve_device
    from coskad_tpu_torch.config import Config
    from coskad_tpu_torch.data.windows import SegmentDataset
    from coskad_tpu_torch.serve import AnomalyScorer
    from coskad_tpu_torch.train.loop import Trainer

    cfg = Config()
    ds = SegmentDataset(
        data=np.zeros((2, 2, cfg.data.seg_len, cfg.data.n_joints), np.float32),
        meta=np.zeros((2, 4), np.int64),
        frame_ids=np.zeros((2, cfg.data.seg_len), np.int32),
    )
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg, ds)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AnomalyScorer(cfg, None)
    assert Trainer(cfg, ds, device="cpu").device.type == "cpu"
