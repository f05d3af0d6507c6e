"""Checkpoints: the port's flax-msgpack codec and its checkpoint module
against the JAX package's, in both directions, and a resumed port run
against an uninterrupted one.

Tolerances: decoded trees equal exactly (same bytes, dtypes and shapes);
scores rtol 1e-3, atol 1e-6 and latents rtol 2e-4, atol 2e-5 (fp32
reassociation, PERF.md §2); Adam's moments carried exactly; one lockstep
epoch after a restore, per-step losses rtol 1e-3 (the lockstep band,
tests/test_torch_train.py); a resumed port run against a straight one on the
CPU within 1e-6."""

import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization
from jax.flatten_util import ravel_pytree

from coskad_tpu import config as jconfig
from coskad_tpu.data.windows import SegmentDataset as JaxSegmentDataset
from coskad_tpu.parallel import create_mesh
from coskad_tpu.train import checkpoint as jcheckpoint
from coskad_tpu.train.loop import Trainer as JaxTrainer
from coskad_tpu.utils.logging import MetricLogger as JaxLogger
from coskad_tpu_torch.data.windows import SegmentDataset
from coskad_tpu_torch.interop import flatten_tree, to_jax_variables
from coskad_tpu_torch.train import checkpoint, msgpack
from coskad_tpu_torch.train.loop import Trainer
from coskad_tpu_torch.utils.logging import MetricLogger
from test_torch_train import _capturing, port_config

torch.set_num_threads(1)

SCORE_TOL = dict(rtol=1e-3, atol=1e-6)
LATENT_TOL = dict(rtol=2e-4, atol=2e-5)
LOSS_RTOL = 1e-3


def same_tree(a, b, path="") -> None:
    """Exact equality of decoded trees: keys, leaf types, dtypes, shapes
    and values."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray):
        assert type(b) is np.ndarray, path
        assert (a.dtype, a.shape) == (b.dtype, b.shape), path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


_rng = np.random.default_rng(5)
LEAVES = {
    "f32": _rng.normal(size=(3, 4)).astype(np.float32),
    "f64": _rng.normal(size=(7,)),
    "i32": np.arange(-40, 40, dtype=np.int32),
    "u32": np.array([0, 1, 2 ** 32 - 1], np.uint32),
    "bool": np.array([True, False, True]),
    "zero_d": np.asarray(1.5, np.float32),
    "empty": np.zeros((0, 3), np.float32),
    "np_scalars": {"f": np.float64(0.25), "i": np.int32(-7), "b": np.bool_(True),
                   "u": np.uint32(7)},
    "nested_tuple": serialization.to_state_dict((1, (2.5, "x", (None, b"\x00\x01")), {})),
    "empty_dicts": {"a": {}, "b": {"c": {}}},
    "python_values": {"none": None, "t": True, "f": False, "ints": [0, 127, 128, -32, -33, 255,
                      256, 65536, 2 ** 40, -2 ** 40, -129, -40000], "float": -0.125,
                      "short": "abc", "long": "y" * 300, "bin": b"\x07" * 70000},
    "many_keys": {str(i): i for i in range(40)},
}


@pytest.mark.parametrize("name", sorted(LEAVES))
def test_msgpack_matches_flax(name):
    tree = {name: LEAVES[name]}
    blob = serialization.msgpack_serialize(tree)
    same_tree(msgpack.unpackb(blob), serialization.msgpack_restore(blob))
    assert msgpack.packb(tree) == blob
    same_tree(serialization.msgpack_restore(msgpack.packb(tree)),
              serialization.msgpack_restore(blob))


def test_msgpack_refuses_what_it_cannot_carry():
    with pytest.raises(TypeError):
        msgpack.packb({1: 2})
    with pytest.raises(TypeError):
        msgpack.packb({"x": object()})
    with pytest.raises(ValueError, match="trailing"):
        msgpack.unpackb(msgpack.packb(1) + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        msgpack.unpackb(msgpack.packb("abc")[:-1])


# ---------------------------------------------------------------- trainers


def data_and_config(fused_train, lr=1e-2, variant="euclidean_dynamic", projector="linear"):
    """64 random windows x 2 transforms, 4 steps of 32 an epoch, the
    narrow model; euclidean_dynamic (or hyperbolic) so the center moves
    too."""
    rng = np.random.default_rng(0)
    n_win = 64
    data = rng.normal(size=(n_win, 3, 6, 5)).astype(np.float32)
    meta = np.tile([1, 1, 1, 1], (n_win, 1)).astype(np.int64)
    fids = np.tile(np.arange(1, 7), (n_win, 1)).astype(np.int32)
    cfg = jconfig.Config(
        model=jconfig.ModelConfig(variant=variant, channels=(8, 4, 8), h_dim=16,
                                  latent_dim=4, projector=projector),
        data=jconfig.DataConfig(seg_len=6, n_joints_override=5, batch_size=32,
                                num_transform=2),
        opt=jconfig.OptConfig(lr=lr, epochs=2),
        run=jconfig.RunConfig(fused_train=fused_train, ghost_size=8),
    )
    return (data, meta, fids), cfg


def jax_trainer(arrays, cfg):
    log = _capturing(JaxLogger)
    tr = JaxTrainer(cfg, JaxSegmentDataset(*arrays, num_transform=2),
                    mesh=create_mesh(1, 1, devices=jax.devices()[:1]), logger=log)
    return tr, log


def port_trainer(arrays, cfg):
    log = _capturing(MetricLogger)
    return Trainer(port_config(cfg), SegmentDataset(*arrays, num_transform=2), device="cpu",
                   logger=log), log


def moments_by_name(trainer):
    """Adam's exp_avg / exp_avg_sq of the port, by flax path."""
    by_param = trainer.optimizer.state
    return {k: (by_param[p]["exp_avg"].numpy(), by_param[p]["exp_avg_sq"].numpy())
            for k, p in trainer.model.named_parameters()}


def jax_moments(opt_state, params):
    """The JAX optimizer's flat mu / nu cut back into the params tree."""
    _, unravel = ravel_pytree(params)
    adam = serialization.to_state_dict(jax.device_get(opt_state))["inner_state"]["0"]
    mu = flatten_tree(jax.device_get(unravel(np.asarray(adam["mu"]))))
    nu = flatten_tree(jax.device_get(unravel(np.asarray(adam["nu"]))))
    return {k: (mu[k], nu[k]) for k in mu}


def lockstep_epoch(jtrainer, jlog, jstate, trainer, log, state):
    jlog.losses.clear()
    log.losses.clear()
    jstate, _ = jtrainer.fit(jstate, epochs=1)
    state, _ = trainer.fit(state, epochs=1)
    assert len(log.losses) == len(jlog.losses) == 4
    np.testing.assert_allclose(log.losses, jlog.losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(state.center.numpy(), np.asarray(jstate.center),
                               rtol=1e-3, atol=1e-6)


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    """A JAX Trainer fits an epoch and saves; the port decodes the file as
    flax does, restores it, scores as JAX does, holds Adam's moments by
    name, and one more epoch runs in lockstep with JAX's."""
    jax_to_port(tmp_path, *data_and_config("off"))


def test_port_checkpoint_restores_into_jax(tmp_path):
    """The port fits an epoch on the ghost-BN path and saves; the file has
    the JAX checkpoint's tree (keys, dtypes, shapes), JAX restores it into
    its template, embeds and scores as the port does, and one more epoch
    runs in lockstep."""
    port_to_jax(tmp_path, *data_and_config("on"))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_mlp_hyperbolic_checkpoint_restores_both_ways(tmp_path, direction):
    """The paper's model tree (the MLP head: btlnk/{hidden_0, bn_0, out}
    params, btlnk/bn_0 batch statistics, Adam's moments of its tensors cut
    from the flat vector by name) and the hyperbolic center, in either
    direction, as the linear tree above."""
    arrays, cfg = data_and_config("auto", variant="hyperbolic", projector="mlp")
    (jax_to_port if direction == "jax_to_port" else port_to_jax)(tmp_path, arrays, cfg)


def jax_to_port(tmp_path, arrays, cfg):
    jtrainer, jlog = jax_trainer(arrays, cfg)
    jstate = jtrainer.initialize_center(jtrainer.init_state())
    jstate, _ = jtrainer.fit(jstate, epochs=1)
    path = str(tmp_path / "jax.ckpt")
    jcheckpoint.save(path, jstate, cfg, extra={"epoch": 0, **jtrainer.schedule_state()})
    same_tree(checkpoint.read_payload(path), jcheckpoint.read_payload(path))

    trainer, log = port_trainer(arrays, cfg)
    state, scaler, extra = checkpoint.restore(path, trainer)
    trainer.restore_schedule_state(extra)
    assert scaler is None and extra["epochs_done"] == 1 and state.step == int(jstate.step) == 4
    got = moments_by_name(trainer)
    for k, (mu, nu) in jax_moments(jstate.opt_state, jstate.params).items():
        np.testing.assert_array_equal(got[k][0], mu, err_msg=k)
        np.testing.assert_array_equal(got[k][1], nu, err_msg=k)
    assert trainer.optimizer.param_groups[0]["lr"] == pytest.approx(cfg.opt.lr)

    js, _ = jtrainer.score_all(jstate, jtrainer.train_ds, jtrainer.train_data)
    s, _ = trainer.score_all(state, trainer.train_ds, trainer.train_data)
    np.testing.assert_allclose(s, js, **SCORE_TOL)
    lockstep_epoch(jtrainer, jlog, jstate, trainer, log, state)


def port_to_jax(tmp_path, arrays, cfg):
    trainer, log = port_trainer(arrays, cfg)
    state, _ = trainer.fit(epochs=1)
    path = str(tmp_path / "port.ckpt")
    checkpoint.save(path, trainer, state, trainer.cfg,
                    extra={"epoch": 0, **trainer.schedule_state()})
    assert os.path.exists(path + ".config.json") and not os.path.exists(path + ".tmp")

    jtrainer, jlog = jax_trainer(arrays, cfg)
    template = jtrainer.init_state()
    jpath = str(tmp_path / "template.ckpt")
    jcheckpoint.save(jpath, template)

    def layout(tree):
        return {k: (v.dtype, v.shape) for k, v in flatten_tree(tree).items()}

    assert layout(checkpoint.read_payload(path)["state"]) == \
        layout(jcheckpoint.read_payload(jpath)["state"])
    jstate, _, extra = jcheckpoint.restore(path, template)
    jstate = jtrainer.attach_state(jstate)
    jtrainer.restore_schedule_state(extra)
    assert int(jstate.step) == state.step == 4
    np.testing.assert_array_equal(np.asarray(jstate.rng), [0, cfg.run.seed])
    got = jax_moments(jstate.opt_state, jstate.params)
    for k, (mu, nu) in moments_by_name(trainer).items():
        np.testing.assert_array_equal(got[k][0], mu, err_msg=k)
        np.testing.assert_array_equal(got[k][1], nu, err_msg=k)

    z_j = jtrainer.embed_all(jstate, jtrainer.train_ds, jtrainer.train_data)
    z = trainer.embed_all(state, trainer.train_ds, trainer.train_data)
    np.testing.assert_allclose(z, z_j, **LATENT_TOL)
    js, _ = jtrainer.score_all(jstate, jtrainer.train_ds, jtrainer.train_data)
    s, _ = trainer.score_all(state, trainer.train_ds, trainer.train_data)
    np.testing.assert_allclose(s, js, **SCORE_TOL)
    lockstep_epoch(jtrainer, jlog, jstate, trainer, log, state)


@pytest.mark.parametrize("fused_train", ["off", "on"])
def test_resume_matches_an_uninterrupted_run(tmp_path, fused_train):
    """fit 2 epochs straight, against fit 1 + save + restore into a new
    Trainer + fit 1: the same per-step losses, center and weights."""
    arrays, cfg = data_and_config(fused_train)
    straight, log = port_trainer(arrays, cfg)
    state, _ = straight.fit(epochs=2)

    first, log1 = port_trainer(arrays, cfg)
    half, _ = first.fit(epochs=1)
    path = str(tmp_path / "last.ckpt")
    checkpoint.save(path, first, half, extra={"epoch": 0, **first.schedule_state()})
    resumed, log2 = port_trainer(arrays, cfg)
    rstate, _, extra = checkpoint.restore(path, resumed)
    resumed.restore_schedule_state(extra)
    rstate, _ = resumed.fit(rstate, epochs=1)

    np.testing.assert_allclose(log1.losses + log2.losses, log.losses, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(rstate.center.numpy(), state.center.numpy(), atol=1e-6)
    want = flatten_tree(to_jax_variables(straight.model)[0])
    for k, v in flatten_tree(to_jax_variables(resumed.model)[0]).items():
        np.testing.assert_allclose(v, want[k], rtol=1e-6, atol=1e-6, err_msg=k)
    assert rstate.step == state.step == 8


def test_save_needs_adam_and_a_scaler_rides_along(tmp_path):
    from coskad_tpu_torch.data.normalize import RobustScalerState

    arrays, cfg = data_and_config("off")
    trainer, _ = port_trainer(arrays, cfg)
    state = trainer.init_state()
    scaler = RobustScalerState(center=np.arange(4.0), scale=np.ones(4))
    path = checkpoint.save(str(tmp_path / "a" / "s.ckpt"), trainer, state, scaler=scaler)
    got = checkpoint.load_scaler(path)
    np.testing.assert_array_equal(got.center, scaler.center)
    np.testing.assert_array_equal(got.scale, scaler.scale)
    # no step taken: count 0, zero moments; a restore leaves Adam empty
    opt_state = checkpoint.read_payload(path)["state"]["opt_state"]
    assert int(opt_state["count"]) == 0 and not opt_state["inner_state"]["0"]["mu"].any()
    checkpoint.restore(path, trainer)
    assert not trainer.optimizer.state
    trainer.optimizer = torch.optim.SGD(trainer.model.parameters(), lr=0.1)
    with pytest.raises(TypeError, match="Adam"):
        checkpoint.save(str(tmp_path / "sgd.ckpt"), trainer, state)
