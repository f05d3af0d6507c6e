"""Reference checkpoint conversion in the port (`coskad_tpu_torch/interop.py`,
`cli/convert.py`, the sklearn pickle of `data/robust.py`) against the JAX
package's, on the CPU.

The reference state dicts are made here: JAX's `export_state_dict` of
seeded flax variables with BatchNorm statistics and buffers drawn away from
their init values, plus nonzero `num_batches_tracked` counters and a
`threshold_dist`. Conversions are held to JAX's exactly (`np.array_equal`,
the same dtype and shape, leaf for leaf), a round trip to the reference
format is the identity, both packages' checkpoint files hold the same
arrays, and the two evals of the CLI's converted checkpoints agree within
1e-4 frame AUC (PERF.md §2). sklearn runs here only: the card's machine has
none, and the port never imports it."""

import os
import pickle
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coskad_tpu import config as jconfig
from coskad_tpu import interop as jinterop
from coskad_tpu.cli import convert as jconvert_cli
from coskad_tpu.cli import eval as jeval_cli
from coskad_tpu.cli.common import load_config as jload_config
from coskad_tpu.models import build_model as jbuild_model
from coskad_tpu.train.loop import model_kwargs_from_config as jmodel_kwargs
from coskad_tpu_torch import interop
from coskad_tpu_torch.cli import convert as convert_cli
from coskad_tpu_torch.cli import eval as eval_cli
from coskad_tpu_torch.cli.common import load_config
from coskad_tpu_torch.data import robust
from coskad_tpu_torch.data.normalize import RobustScalerState
from coskad_tpu_torch.interop import flatten_tree, nest_flat
from coskad_tpu_torch.models import build_model
from coskad_tpu_torch.train import checkpoint
from test_torch_cli import narrow_dataset
from test_torch_train import port_config

torch.set_num_threads(1)

DIMS = dict(input_dim=2, layer_channels=(8, 4, 8), hidden_dimension=8, latent_dim=4,
            n_frames=6, n_joints=5)
KINDS = {
    "sts_gcn": dict(),
    "mlp_head": dict(projector="mlp", projector_hidden_layers=[6]),
    "mahalanobis": dict(distance="mahalanobis"),
    "learnable_gcn": dict(encoder_type="learnable_gcn"),
    "static_gcn": dict(encoder_type="static_gcn"),
    "stsae": dict(use_decoder=True),
    "stsvae_ps": dict(use_vae=True, distribution="ps"),
    "stsvae_normal_mlp": dict(use_vae=True, distribution="normal", projector="mlp",
                              projector_hidden_layers=[6]),
}


def numpy_tree(tree):
    return nest_flat({k: np.asarray(v) for k, v in flatten_tree(tree).items()})


def reference(kind, seed=0):
    """(JAX model, port model, reference state dict, distance) for `kind`."""
    kw = dict(KINDS[kind])
    distance = kw.pop("distance", "euclidean")
    jmodel = jbuild_model(**DIMS, **kw)
    model = build_model(**DIMS, **kw)
    x = jnp.zeros((2, DIMS["input_dim"], DIMS["n_frames"], DIMS["n_joints"]), jnp.float32)
    variables = jmodel.init({"params": jax.random.PRNGKey(seed + 5),
                             "sample": jax.random.PRNGKey(seed + 6)}, x)
    rng = np.random.default_rng(seed)
    params = numpy_tree(variables["params"])
    stats = nest_flat({k: (rng.normal(0.0, 0.3, v.shape) if k.endswith("mean")
                           else rng.uniform(0.5, 2.0, v.shape)).astype(np.float32)
                       for k, v in flatten_tree(variables.get("batch_stats", {})).items()})
    latent = DIMS["latent_dim"]
    buffers = {"center": rng.normal(size=latent).astype(np.float32)}
    if distance == "mahalanobis":
        a = rng.normal(size=(latent, latent))
        buffers["inv_cov"] = (a @ a.T / latent + np.eye(latent)).astype(np.float32)
    if kw.get("distribution") == "normal":
        buffers["mean_vector"] = rng.normal(size=latent).astype(np.float32)
    sd = jinterop.export_state_dict(jmodel, params, stats, buffers, distance=distance)
    for i, k in enumerate(sorted(k for k in sd if k.endswith("num_batches_tracked"))):
        sd[k] = np.asarray(40 + i, np.int64)
    if "threshold_dist" in sd:
        sd["threshold_dist"] = np.asarray(0.25, np.float32)
    return jmodel, model, sd, distance


def assert_same_tree(got, want):
    got, want = flatten_tree(got), flatten_tree(want)
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype, g.shape, w.shape)
        assert np.array_equal(g, w), k


@pytest.mark.parametrize("kind", list(KINDS))
def test_convert_state_dict_matches_jax(kind):
    jmodel, model, sd, _ = reference(kind)
    want = jinterop.convert_state_dict(dict(sd), jmodel)
    got = interop.convert_state_dict(dict(sd), model)
    for g, w in zip(got, want):
        assert_same_tree(numpy_tree(g), numpy_tree(w))
    assert sorted(got[3]) == sorted(k for k in sd if k.endswith("num_batches_tracked")
                                    or k in ("threshold_dist", "encoder.Adj"))


@pytest.mark.parametrize("kind", list(KINDS))
def test_export_after_convert_is_the_identity(kind):
    _, model, sd, distance = reference(kind, seed=1)
    params, stats, buffers, passthrough = interop.convert_state_dict(dict(sd), model)
    back = interop.export_state_dict(model, params, stats, buffers, distance=distance)
    back.update(passthrough)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        assert np.array_equal(back[k], v), k


def _raised(fn):
    with pytest.raises(ValueError) as info:
        fn()
    assert type(info.value).__name__ == "ConversionError"
    return str(info.value)


@pytest.mark.parametrize("fault", ["missing", "leftover", "st_gcn"])
def test_conversion_errors_match_jax(fault):
    jmodel, model, sd, _ = reference("stsae")
    if fault == "missing":
        key = "decoder.model.1.tcn.1.running_var"
        del sd[key]
    elif fault == "leftover":
        key = "encoder.model.9.gcn.A"
        sd[key] = np.zeros(3, np.float32)
    else:
        key = "st_gcn"
        kw = dict(DIMS, encoder_type="st_gcn", n_joints=17)
        jmodel, model = jbuild_model(**kw), build_model(**kw)
    want = _raised(lambda: jinterop.convert_state_dict(dict(sd), jmodel))
    got = _raised(lambda: interop.convert_state_dict(dict(sd), model))
    assert key in want and key in got


def jax_config(variant="euclidean_static", **model):
    return jconfig.Config(
        model=jconfig.ModelConfig(variant=variant, num_coords=2, channels=(8, 4, 8), h_dim=8,
                                  latent_dim=4, **model),
        data=jconfig.DataConfig(seg_len=6, kp18_format=False, n_joints_override=5,
                                normalization_strategy="robust"),
        opt=jconfig.OptConfig(lr=3e-4), eval=jconfig.EvalConfig(),
        run=jconfig.RunConfig(seed=11))


def lightning_file(path, sd, epoch=3):
    torch.save({"state_dict": {f"model.{k}": torch.tensor(v) for k, v in sd.items()},
                "epoch": epoch}, path)
    return path


def sklearn_pickle(path, seed=0, n_features=34):
    from sklearn.preprocessing import RobustScaler

    x = np.random.default_rng(seed).normal(size=(200, n_features))
    with open(path, "wb") as f:
        pickle.dump(RobustScaler(quantile_range=(10.0, 90.0)).fit(x), f)
    return path


def test_robust_config_without_scaler_raises(tmp_path):
    cfg = port_config(jax_config())
    _, model, sd, _ = reference("sts_gcn")
    ckpt = lightning_file(str(tmp_path / "ref.ckpt"), sd)
    with pytest.raises(interop.ConversionError, match="--scaler"):
        interop.convert_checkpoint(ckpt, cfg, out_path=str(tmp_path / "c.ckpt"))
    out = interop.convert_checkpoint(ckpt, cfg, out_path=str(tmp_path / "c.ckpt"),
                                     allow_missing_scaler=True)
    assert "scaler" not in checkpoint.read_payload(out)


@pytest.mark.parametrize("variant,kind", [("euclidean_static", "sts_gcn"),
                                          ("autoencoder", "stsae")])
def test_convert_checkpoint_matches_jax(tmp_path, variant, kind):
    """Both packages' converted checkpoints hold the same tree: the trees,
    the buffers, a zero Adam state in optax's flat layout, PRNGKey(seed),
    the scaler and extra {epoch, converted_from, torch_passthrough}."""
    jcfg = jax_config(variant)
    _, _, sd, _ = reference(kind)
    ckpt = lightning_file(str(tmp_path / "ref.ckpt"), sd)
    scaler = sklearn_pickle(str(tmp_path / "robust.pkl"))
    want = jinterop.convert_checkpoint(ckpt, jcfg, out_path=str(tmp_path / "j.ckpt"),
                                       scaler_path=scaler)
    got = interop.convert_checkpoint(ckpt, port_config(jcfg), out_path=str(tmp_path / "p.ckpt"),
                                     scaler_path=scaler)
    assert_same_tree(checkpoint.read_payload(got), checkpoint.read_payload(want))


def test_export_checkpoint_matches_jax(tmp_path):
    """A converted checkpoint with a scaler, exported by both packages: the
    same tensors in the torch files (the passthrough counters included), and
    robust.pkl files that sklearn reads as RobustScalers transforming alike."""
    jcfg = jax_config("vae", distribution="normal", projector="mlp",
                      projector_hidden_layers=[6])
    _, _, sd, _ = reference("stsvae_normal_mlp")
    ckpt = lightning_file(str(tmp_path / "ref.ckpt"), sd)
    converted = interop.convert_checkpoint(ckpt, port_config(jcfg),
                                           out_path=str(tmp_path / "c.ckpt"),
                                           scaler_path=sklearn_pickle(str(tmp_path / "r.pkl")))
    want = jinterop.export_checkpoint(converted, jcfg, str(tmp_path / "j.pt"))
    got = interop.export_checkpoint(converted, port_config(jcfg), str(tmp_path / "p.pt"))
    a, b = (torch.load(p, map_location="cpu", weights_only=False) for p in (got, want))
    assert a["epoch"] == b["epoch"] == 3
    assert sorted(a["state_dict"]) == sorted(b["state_dict"]) == sorted(f"model.{k}" for k in sd)
    for k, v in b["state_dict"].items():
        assert a["state_dict"][k].dtype == v.dtype and torch.equal(a["state_dict"][k], v), k
        assert np.array_equal(v.numpy(), sd[k[len("model."):]]), k
    x = np.random.default_rng(3).normal(size=(20, 34))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the port's pickle names no sklearn version
        with open(got + ".robust.pkl", "rb") as f:
            ours = pickle.load(f)
        with open(want + ".robust.pkl", "rb") as f:
            theirs = pickle.load(f)
    assert type(ours).__name__ == "RobustScaler" and type(ours) is type(theirs)
    assert ours.quantile_range == theirs.quantile_range == (10.0, 90.0)
    assert ours.n_features_in_ == theirs.n_features_in_ == 34
    np.testing.assert_array_equal(ours.transform(x), theirs.transform(x))


def test_sklearn_pickle_read_without_sklearn(tmp_path):
    path = sklearn_pickle(str(tmp_path / "robust.pkl"), seed=4, n_features=6)
    with open(path, "rb") as f:
        fitted = pickle.load(f)
    got = interop.load_sklearn_scaler(path)
    assert isinstance(got, RobustScalerState)
    assert np.array_equal(got.center, fitted.center_) and got.center.dtype == np.float64
    assert np.array_equal(got.scale, fitted.scale_) and got.scale.dtype == np.float64
    assert np.array_equal(got.center, jinterop.load_sklearn_scaler(path).center)
    with open(str(tmp_path / "evil.pkl"), "wb") as f:
        pickle.dump(os.system, f)
    with pytest.raises(pickle.UnpicklingError, match="posix.system|os.system|nt.system"):
        robust.load_scaler(str(tmp_path / "evil.pkl"))


def test_port_writes_an_sklearn_pickle(tmp_path):
    center = np.random.default_rng(5).normal(size=6)
    scale = np.random.default_rng(6).uniform(0.5, 2.0, size=6)
    robust.write_sklearn_scaler(center, scale, str(tmp_path / "port.pkl"))
    jinterop._write_sklearn_scaler({"center": center, "scale": scale}, str(tmp_path / "jax.pkl"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with open(tmp_path / "port.pkl", "rb") as f:
            ours = pickle.load(f)
        with open(tmp_path / "jax.pkl", "rb") as f:
            theirs = pickle.load(f)
    from sklearn.preprocessing import RobustScaler

    assert isinstance(ours, RobustScaler)
    assert ours.get_params() == theirs.get_params()
    x = np.random.default_rng(7).normal(size=(9, 6))
    np.testing.assert_array_equal(ours.transform(x), theirs.transform(x))
    np.testing.assert_array_equal(ours.inverse_transform(x), theirs.inverse_transform(x))
    back = interop.load_sklearn_scaler(str(tmp_path / "port.pkl"))
    assert np.array_equal(back.center, center) and np.array_equal(back.scale, scale)


def test_cli_convert_both_ways_then_eval(tmp_path, capsys):
    """cli.convert of one reference checkpoint by each package, the port's
    cli.eval and JAX's on the two, then --to-torch back to the reference's
    state dict exactly, with --scaler copied beside it."""
    cfg_path, _ = narrow_dataset(str(tmp_path / "data"))
    cfg = load_config(cfg_path)
    jmodel = jbuild_model(**jmodel_kwargs(jload_config(cfg_path)))
    x = jnp.zeros((2, cfg.model.num_coords, cfg.data.seg_len, cfg.data.n_joints))
    variables = jmodel.init({"params": jax.random.PRNGKey(2)}, x)
    rng = np.random.default_rng(8)
    stats = nest_flat({k: (rng.normal(0.0, 0.1, v.shape) if k.endswith("mean")
                           else rng.uniform(0.8, 1.2, v.shape)).astype(np.float32)
                       for k, v in flatten_tree(variables["batch_stats"]).items()})
    center = rng.normal(0.0, 0.1, cfg.model.latent_dim).astype(np.float32)
    sd = jinterop.export_state_dict(jmodel, numpy_tree(variables["params"]), stats,
                                    {"center": center})
    sd["encoder.model.0.tcn.1.num_batches_tracked"] = np.asarray(42, np.int64)
    ref = lightning_file(str(tmp_path / "ref.ckpt"), sd, epoch=5)

    ours, theirs = str(tmp_path / "p.ckpt"), str(tmp_path / "j.ckpt")
    assert convert_cli.main(["--config", cfg_path, "--ckpt", ref, "--out", ours]) == ours
    assert "coskad_tpu_torch.cli.eval" in capsys.readouterr().out
    jconvert_cli.main(["-c", cfg_path, "--ckpt", ref, "--out", theirs])
    got = eval_cli.main(["--config", cfg_path, "--ckpt", ours, "--device", "cpu"])
    want = jeval_cli.main(["--config", cfg_path, "--ckpt", theirs])
    assert np.isfinite(got.result.auc) and abs(got.result.auc - want.auc) <= 1e-4
    np.testing.assert_allclose(got.result.per_transform_auc, want.per_transform_auc, atol=1e-4)

    back = str(tmp_path / "out" / "back.ckpt")
    os.makedirs(os.path.dirname(back))
    scaler = sklearn_pickle(str(tmp_path / "fitted.pkl"))
    convert_cli.main(["-c", cfg_path, "--to-torch", "--ckpt", ours, "--out", back,
                      "--scaler", scaler])
    with open(scaler, "rb") as a, open(tmp_path / "out" / "robust.pkl", "rb") as b:
        assert a.read() == b.read()
    back_sd = torch.load(back, map_location="cpu", weights_only=False)
    assert back_sd["epoch"] == 5
    assert sorted(back_sd["state_dict"]) == sorted(f"model.{k}" for k in sd)
    for k, v in sd.items():
        assert np.array_equal(back_sd["state_dict"][f"model.{k}"].numpy(), v), k
    with pytest.raises(SystemExit):
        convert_cli.main(["-c", cfg_path, "--to-torch", "--ckpt", ours])
