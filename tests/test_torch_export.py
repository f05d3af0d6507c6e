"""Scoring artifacts in the port (`coskad_tpu_torch/export_hlo.py`,
`cli/export.py`) and K1's custom op (`kernels/stse_fused.py`), on the CPU.

The cases of tests/test_export_hlo.py on the port: an artifact's scores
equal the library's `AnomalyScorer.score_windows` within rtol 5e-6 / atol
1e-6 (the JAX test's band) for every variant, the VAE sampling, and repeat
to the bit; against JAX's own artifact on the same weights within the
scores' band, rtol 1e-3 / atol 1e-6; the artifact loads and scores in a
process without the port's models/ or train/; the VAE's draw key; a
fixed-batch export; the layout, the version guard and scaler.npz; and
cli.export end to end. The custom op's CPU implementation is the plain
version exactly, `unpack_packed` inverts `pack_folded`, its fake
implementation gives the shape, and a module calling it exports with the op
in its graph. On the CPU every artifact takes the module route: K1 inside an
artifact runs on the card (chip_smoke.py's export phase)."""

import io
import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

from coskad_tpu_torch import config as tconfig
from coskad_tpu_torch.cli import export as export_cli
from coskad_tpu_torch.data.normalize import RobustScalerState
from coskad_tpu_torch.data.windows import SegmentDataset
from coskad_tpu_torch.export_hlo import (ARTIFACT_VERSION, ENCODE_MEMBER, META_MEMBER,
                                         SCALER_MEMBER, SCORING_MEMBER, export_scorer,
                                         load_artifact)
from coskad_tpu_torch.kernels import stse_fused
from coskad_tpu_torch.models import build_model
from coskad_tpu_torch.serve import AnomalyScorer
from coskad_tpu_torch.train import checkpoint
from coskad_tpu_torch.train.loop import Trainer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BAND = dict(rtol=5e-6, atol=1e-6)
VARIANTS = [("euclidean_static", "euclidean"), ("euclidean_static", "mahalanobis"),
            ("autoencoder", "euclidean"), ("vae", "euclidean"), ("hyperbolic", "euclidean")]


def port_scorer(variant="euclidean_static", distance="euclidean", seed=0, **run):
    """An AnomalyScorer over a fresh state with a non-trivial center,
    anchor and inverse covariance, on the CPU; tests/test_export_hlo.py's
    configuration."""
    cfg = tconfig.Config(
        model=tconfig.ModelConfig(variant=variant, num_coords=2, channels=(8,), h_dim=8,
                                  latent_dim=4, projector="linear", distance=distance),
        data=tconfig.DataConfig(seg_len=6, kp18_format=False, batch_size=32, num_transform=2,
                                n_joints_override=5),
        opt=tconfig.OptConfig(lr=1e-3, epochs=2), eval=tconfig.EvalConfig(),
        run=tconfig.RunConfig(seed=0, **run))
    ds = SegmentDataset(data=np.zeros((4, 3, 6, 5), np.float32),
                        meta=np.zeros((4, 4), np.int64), frame_ids=np.zeros((4, 6), np.int32),
                        num_transform=2)
    tr = Trainer(cfg, ds, device="cpu")
    rng = np.random.default_rng(seed)
    d = cfg.model.latent_dim
    center = rng.normal(size=d).astype(np.float32)
    if variant == "hyperbolic":
        center = 0.3 * center / np.linalg.norm(center)
    mean_vector = rng.normal(size=d).astype(np.float32)
    a = rng.normal(size=(d, d)).astype(np.float32)
    state = tr.init_state().replace(
        step=3, center=torch.from_numpy(center),
        mean_vector=torch.from_numpy(mean_vector / np.linalg.norm(mean_vector)),
        inv_cov=torch.from_numpy((a @ a.T / d + np.eye(d)).astype(np.float32)))
    return AnomalyScorer(cfg, state, trainer=tr)


def windows(n=50, c=3, t=6, v=5, seed=3):
    return np.random.default_rng(seed).normal(size=(n, c, t, v)).astype(np.float32)


@pytest.mark.parametrize("variant,distance", VARIANTS)
def test_exported_scores_match_the_library(tmp_path, variant, distance):
    """A symbolic-batch artifact: two chunks of 32 and a wrapped tail, the
    VAE's draws from the generator the library seeds, to the band and the
    same bits again."""
    scorer = port_scorer(variant, distance)
    w = windows(50)
    want = scorer.score_windows(w)
    path = str(tmp_path / "art.zip")
    meta = export_scorer(scorer, path)
    assert meta["batch_size"] is None and meta["variant"] == variant
    assert meta["encoder_route"] == "modules" and meta["device"] == "cpu"
    assert meta["vae_sample"] == (variant == "vae") and meta["draw_key"] == [0, 3, 7]
    with zipfile.ZipFile(path) as zf:
        assert (ENCODE_MEMBER in zf.namelist()) == (variant == "vae")
    art = load_artifact(path, device="cpu")
    got = art.score_windows(w)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **BAND)
    assert np.array_equal(got, art.score_windows(w))
    scores, rec = art.score_windows(w, return_rec=True)
    assert np.array_equal(scores, got) and rec.shape == (50,)
    if variant in ("autoencoder", "vae"):
        assert np.isfinite(rec).all() and (rec > 0).all()
    else:
        assert not rec.any()
    # a request under one batch is one chunk of its rows, as the library's
    np.testing.assert_allclose(art.score_windows(w[:7]), scorer.score_windows(w[:7]), **BAND)
    assert art.score_windows(w[:0]).shape == (0,)


def test_one_window_is_scored_as_a_chunk_of_two(tmp_path):
    scorer = port_scorer()
    path = str(tmp_path / "art.zip")
    export_scorer(scorer, path)
    art = load_artifact(path, device="cpu")
    w = windows(1)
    np.testing.assert_allclose(art.score_windows(w), scorer.score_windows(w), **BAND)
    np.testing.assert_array_equal(art.score_windows(w), art(np.concatenate([w, w]))[0][:1])


def test_vae_draw_key_contract(tmp_path):
    """The same draw key gives the same bits; another key other scores; the
    VAE with eval.vae_sample off is one program on its posterior mean."""
    scorer = port_scorer("vae")
    path = str(tmp_path / "art.zip")
    export_scorer(scorer, path)
    art = load_artifact(path, device="cpu")
    w = windows(8)
    first = art.score_windows(w)
    assert np.array_equal(first, art.score_windows(w, draw_key=[0, 3, 7]))
    assert not np.array_equal(first, art.score_windows(w, draw_key=[123, 456, 7]))
    raw, _ = art(w)  # one raw chunk, the meta's key: the pass of one chunk
    assert np.array_equal(raw, first)

    scorer.cfg.eval.vae_sample = False
    mean_path = str(tmp_path / "mean.zip")
    assert export_scorer(scorer, mean_path)["vae_sample"] is False
    with zipfile.ZipFile(mean_path) as zf:
        assert ENCODE_MEMBER not in zf.namelist()
    mean = load_artifact(mean_path, device="cpu")
    np.testing.assert_allclose(mean.score_windows(w), scorer.score_windows(w), **BAND)
    assert np.array_equal(mean.score_windows(w), mean.score_windows(w, draw_key=[1, 2, 3]))


def test_fixed_batch_export(tmp_path):
    scorer = port_scorer()
    bs = scorer.cfg.data.batch_size
    w = windows(50)
    path = str(tmp_path / "fixed.zip")
    assert export_scorer(scorer, path, batch_size=bs)["batch_size"] == bs
    art = load_artifact(path, device="cpu")
    np.testing.assert_allclose(art.score_windows(w), scorer.score_windows(w), **BAND)
    with pytest.raises(Exception):
        art(windows(bs + 1))


def test_layout_version_guard_and_scaler(tmp_path):
    scorer = port_scorer()
    scorer.scaler = RobustScalerState(center=np.arange(4, dtype=np.float64),
                                      scale=np.arange(1, 5, dtype=np.float64))
    path = str(tmp_path / "art.zip")
    meta = export_scorer(scorer, path)
    with zipfile.ZipFile(path) as zf:
        assert set(zf.namelist()) == {SCORING_MEMBER, META_MEMBER, SCALER_MEMBER}
        assert json.loads(zf.read(META_MEMBER)) == meta
    assert meta["artifact_version"] == ARTIFACT_VERSION and meta["torch_version"]
    assert meta["seg_len"] == 6 and meta["n_joints"] == 5 and meta["in_channels"] == 3
    assert not {"jax_version", "platforms", "base_key"} & set(meta)
    art = load_artifact(path, device="cpu")
    np.testing.assert_array_equal(art.scaler_arrays["center"], np.arange(4, dtype=np.float64))
    np.testing.assert_array_equal(art.scaler_arrays["scale"], np.arange(1, 5, dtype=np.float64))

    future = str(tmp_path / "future.zip")
    with zipfile.ZipFile(path) as src, zipfile.ZipFile(future, "w") as dst:
        for name in src.namelist():
            data = src.read(name)
            if name == META_MEMBER:
                data = json.dumps(dict(json.loads(data), artifact_version=ARTIFACT_VERSION + 1))
            dst.writestr(name, data)
    with pytest.raises(ValueError, match="version"):
        load_artifact(future, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load_artifact(path)


def test_artifact_scores_without_model_code(tmp_path):
    """A fresh process loads the artifact and scores with nothing of the
    port's models/ or train/ imported."""
    scorer = port_scorer("autoencoder")
    path = str(tmp_path / "art.zip")
    export_scorer(scorer, path)
    w = windows(20)
    np.save(tmp_path / "w.npy", w)
    code = (
        "import sys, numpy as np\n"
        "from coskad_tpu_torch.export_hlo import load_artifact\n"
        f"art = load_artifact({path!r}, device='cpu')\n"
        f"np.save({str(tmp_path / 's.npy')!r}, art.score_windows(np.load("
        f"{str(tmp_path / 'w.npy')!r})))\n"
        "print(sorted(m for m in sys.modules if m.startswith(('coskad_tpu_torch.models', "
        "'coskad_tpu_torch.train', 'coskad_tpu.', 'jax'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"
    np.testing.assert_allclose(np.load(tmp_path / "s.npy"), scorer.score_windows(w), **BAND)


@pytest.mark.parametrize("variant,distance", [v for v in VARIANTS if v[0] != "vae"])
def test_port_artifact_matches_jax_artifact(tmp_path, variant, distance):
    """JAX's artifact and the port's from one JAX checkpoint score alike
    (the scores' band; the VAE's draws come from different generators, so
    its sampled scores are held to the port's library above)."""
    from coskad_tpu.export_hlo import export_scorer as jexport_scorer
    from coskad_tpu.export_hlo import load_artifact as jload_artifact
    from coskad_tpu.train import checkpoint as jcheckpoint
    from test_export_hlo import _scorer as jax_scorer

    jscorer = jax_scorer(variant, distance)
    ckpt = str(tmp_path / "best.ckpt")
    jcheckpoint.save(ckpt, jscorer.state, cfg=jscorer.cfg)
    jexport_scorer(jscorer, str(tmp_path / "jax.czip"), platforms=("cpu",))
    # JAX's train set has 2 channels; the port's placeholder dataset 3
    export_scorer(AnomalyScorer.from_checkpoint(ckpt, device="cpu"), str(tmp_path / "p.zip"),
                  in_channels=2)
    w = windows(50, c=2)
    want = jload_artifact(str(tmp_path / "jax.czip")).score_windows(w)
    got = load_artifact(str(tmp_path / "p.zip"), device="cpu").score_windows(w)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6)


def test_bf16_artifact_matches_the_library(tmp_path):
    scorer = port_scorer("autoencoder", compute_dtype="bfloat16")
    assert scorer.trainer.model.dtype == torch.bfloat16
    path = str(tmp_path / "bf16.zip")
    assert export_scorer(scorer, path)["encoder_route"] == "modules"
    w = windows(40)
    got, rec = load_artifact(path, device="cpu").score_windows(w, return_rec=True)
    np.testing.assert_allclose(got, scorer.score_windows(w), **BAND)
    _, want_rec = scorer.trainer.score_all(
        scorer.state, SegmentDataset(data=w, meta=np.zeros((40, 4), np.int64),
                                     frame_ids=np.zeros((40, 6), np.int32), num_transform=1),
        torch.from_numpy(w.reshape(40, -1)))
    np.testing.assert_allclose(rec, want_rec, **BAND)


def test_export_cli_end_to_end(tmp_path, capsys):
    scorer = port_scorer()
    ckpt = str(tmp_path / "best.ckpt")
    checkpoint.save(ckpt, scorer.trainer, scorer.state, cfg=scorer.cfg)
    art = str(tmp_path / "model.zip")
    assert export_cli.main(["--ckpt", ckpt, "--out", art, "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report == {"artifact": art, "variant": "euclidean_static", "device": "cpu",
                      "encoder_route": "modules", "batch_size": None, "in_channels": 3}
    w = windows(20)
    want = AnomalyScorer.from_checkpoint(ckpt, device="cpu").score_windows(w)
    np.testing.assert_allclose(load_artifact(art, device="cpu").score_windows(w), want, **BAND)
    with pytest.raises(SystemExit):
        export_cli.main(["--ckpt", ckpt, "--out", art, "--platforms", "cpu,tpu"])
    assert "--device" in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            export_cli.main(["--ckpt", ckpt, "--out", art])


# ------------------------------------------------------------ K1's custom op


def folded_model(seed=0, **kw):
    dims = dict(input_dim=2, layer_channels=(8, 4, 8), hidden_dimension=12, latent_dim=5,
                n_frames=6, n_joints=5)
    dims.update(kw)
    model = build_model(**dims).eval()
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model


@pytest.mark.parametrize("layers", [(8, 4, 8), (3,), (16, 16)])
def test_unpack_inverts_pack(layers):
    folded, packed = folded_model(layer_channels=layers).folded()
    back = stse_fused.unpack_packed(*packed.op_args)
    assert back.w_proj is None and back.b_proj is None
    assert len(back.layers) == len(folded.layers)
    for got, want in zip(back.layers, folded.layers):
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w)
    again = stse_fused.pack_folded(back._replace(w_proj=folded.w_proj, b_proj=folded.b_proj))
    assert torch.equal(again.weights, packed.weights)
    assert np.array_equal(again.layout, packed.layout)


def test_custom_op_on_the_cpu_is_the_plain_version():
    folded, packed = folded_model(seed=2).folded()
    x = torch.from_numpy(windows(9, c=2))
    got = torch.ops.coskad_torch.stse_fused_hidden(x, *packed.op_args)
    assert torch.equal(got, stse_fused.fused_stse_hidden_reference(x, folded))
    assert torch.equal(stse_fused.fused_stse_hidden(x, folded, packed), got)
    torch.library.opcheck(stse_fused.stse_fused_hidden_op, (x, *packed.op_args),
                          test_utils=("test_schema", "test_faketensor"))


def test_custom_op_fake_shape_and_export():
    from torch._subclasses.fake_tensor import FakeTensorMode

    _, packed = folded_model(seed=3).folded()
    weights, layout, n, npad = packed.op_args
    with FakeTensorMode():
        out = torch.ops.coskad_torch.stse_fused_hidden(
            torch.empty(7, 2, 6, 5), torch.empty(weights.shape), layout, n, npad)
    assert tuple(out.shape) == (7, 30, 12) and out.dtype == torch.float32

    class Hidden(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.register_buffer("weights", weights.clone())

        def forward(self, x):
            return torch.ops.coskad_torch.stse_fused_hidden(x, self.weights, layout, n, npad)

    batch = torch.export.Dim("batch", min=2)
    ep = torch.export.export(Hidden(), (torch.zeros(4, 2, 6, 5),),
                             dynamic_shapes=({0: batch},))
    targets = [str(node.target) for node in ep.graph.nodes if node.op == "call_function"]
    assert targets == ["coskad_torch.stse_fused_hidden.default"]
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    buf.seek(0)
    x = torch.from_numpy(windows(5, c=2))
    assert torch.equal(torch.export.load(buf).module()(x), Hidden()(x))
