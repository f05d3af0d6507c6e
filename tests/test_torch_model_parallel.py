"""Model parallelism of the port (`coskad_tpu_torch/parallel/mesh.py`) on the
CPU: four gloo processes (tests/torch_mp_worker.py, one thread each) as a
2 x 2 (data, model) mesh, `run.model_parallel` 2, over
tests/torch_dp_worker.py's data: 96 windows, batch 32, 2 epochs, SGD.

  * the linear projector, the MLP head and the autoencoder's reverse
    projector against the JAX Trainer on `create_mesh(2, 2)` in this
    process, from the same weights, and against one port process;
  * dropout and the VAE's own draws against one process;
  * the four ranks' results the same bits (the two model ranks of a data
    block hold the same replicated weights, statistics and scores), and
    each rank's blocks of the split kernels the shards of JAX's
    `shard_params` on the same mesh;
  * the split reverse projector's channel-major hidden state (the
    decoder's K1 input) gathered whole on every rank;
  * a checkpoint round trip: one process writes, the mesh restores and
    writes the same bytes back, trains an Adam epoch and writes again, and
    that file restores in one process and in JAX to the mesh's latents;
  * `fused_train: on` refused under a model axis with JAX's message.

Every scenario runs in one spawn of the four ranks. Bands, those of
tests/test_torch_parallel.py: losses rtol 3e-4 (SGD), center rtol 1e-3 /
atol 1e-6, statistics rtol 1e-3 / atol 1e-5, scores rtol 1e-3 / atol
1e-6, parameters rtol 3e-4 / atol 1e-6; latents of a restored checkpoint
rtol 2e-5 / atol 1e-6 (tests/test_cli_e2e.py's re-laid mesh)."""

import os
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch

from coskad_tpu.data.windows import SegmentDataset as JaxSegmentDataset
from coskad_tpu.parallel import create_mesh as jax_create_mesh
from coskad_tpu.parallel.mesh import shard_params
from coskad_tpu.train import checkpoint as jcheckpoint
from coskad_tpu.train.loop import Trainer as JaxTrainer
from coskad_tpu.utils.logging import MetricLogger as JaxLogger
from coskad_tpu_torch.interop import flatten_tree
from coskad_tpu_torch.parallel import mesh
from coskad_tpu_torch.train import checkpoint
from coskad_tpu_torch.utils.net import free_port
from test_torch_parallel import collect, jax_config, tree
from test_torch_train import _capturing

import torch_mp_worker as worker

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_mp_worker.py")
JAX_SCENARIOS = ("linear", "mlp_head", "autoencoder")
PORT_SCENARIOS = ("dropout", "vae")
GROUP = (*JAX_SCENARIOS, *PORT_SCENARIOS, "checkpoint", "fused_on")
LOSS = dict(rtol=3e-4, atol=0.0)
CENTER = dict(rtol=1e-3, atol=1e-6)
STATS = dict(rtol=1e-3, atol=1e-5)
SCORES = dict(rtol=1e-3, atol=1e-6)
PARAMS = dict(rtol=3e-4, atol=1e-6)
LATENT = dict(rtol=2e-5, atol=1e-6)


def jax_mesh():
    return jax_create_mesh(2, 2, devices=jax.devices()[:4])


def jax_trainer(cfg):
    ds = worker.dataset()
    log = _capturing(JaxLogger)
    return JaxTrainer(jax_config(cfg), JaxSegmentDataset(ds.data, ds.meta, ds.frame_ids,
                                                         num_transform=1),
                      mesh=jax_mesh(), logger=log), log


def jax_run(name, jt, log, state):
    """JAX's fit (SGD) and scores on the 2 x 2 mesh from `state`."""
    state, _ = jt.fit(jt.initialize_center(jt.attach_state(state)), epochs=worker.EPOCHS)
    scores, rec = jt.score_all(state, jt.train_ds, jt.train_data)
    return dict(step_losses=np.asarray(log.losses), center=np.asarray(state.center),
                inv_cov=np.asarray(state.inv_cov), scores=np.asarray(scores),
                rec=np.asarray(rec), params=flatten_tree(jax.device_get(state.params)),
                batch_stats=flatten_tree(jax.device_get(state.batch_stats)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run of the file: JAX's initial weights and the one-process
    checkpoint first, then the 2 x 2 group, overlapped with JAX's fits and
    the one-process baselines here."""
    tmp = tmp_path_factory.mktemp("mp")
    prefix = str(tmp / "mp_")
    jax_side, weights = {}, {}
    for name in JAX_SCENARIOS:
        jt, log = jax_trainer(worker.scenario_config(name, 2))
        jt.tx = optax.sgd(worker.SCENARIOS[name][1])
        state = jt.init_state()
        jax_side[name] = (jt, log, state)
        weights.update({f"{name}.{part}.{k}": v for part in ("params", "batch_stats")
                        for k, v in flatten_tree(jax.device_get(getattr(state, part))).items()})
    np.savez(str(tmp / "weights.npz"), **weights)
    one_ckpt = worker.checkpoint_trainer(1)
    state, _ = one_ckpt.fit(epochs=1)
    checkpoint.save(prefix + "one.ckpt", one_ckpt, state, one_ckpt.cfg, extra={"epoch": 0})

    group = start_group(GROUP, str(tmp / "weights.npz"), prefix)
    shapes = {name: jax_shard_shapes(jax_side[name][2].params) for name in JAX_SCENARIOS}
    jax_out = {name: jax_run(name, *jax_side[name]) for name in JAX_SCENARIOS}
    one = {name: worker.run(name, weights) for name in JAX_SCENARIOS + PORT_SCENARIOS}
    return dict(jax=jax_out, one=one, mp=collect(group), prefix=prefix, shapes=shapes)


def start_group(names, weights_path, prefix):
    """The named scenarios on the four ranks of a 2 x 2 mesh, started;
    `collect` waits for them."""
    port = free_port("localhost")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.path.join(ROOT, "tests")]),
               XLA_FLAGS="")
    procs = [subprocess.Popen([sys.executable, WORKER, str(rank), "4", str(port), weights_path,
                               prefix, *names], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in range(4)]
    return procs, names, prefix


def jax_shard_shapes(params):
    """Each parameter's shape on one device under JAX's `shard_params`."""
    shardings = flatten_tree(shard_params(params, jax_mesh()))
    whole = flatten_tree(jax.device_get(params))
    return {k: tuple(np.asarray(s).item().shard_shape(whole[k].shape))
            for k, s in shardings.items()}


def _close(got, want, band, what):
    np.testing.assert_allclose(got, want, **band, err_msg=what)


@pytest.mark.parametrize("name", JAX_SCENARIOS)
def test_the_mesh_matches_jaxs_mesh(name, runs):
    want, got = runs["jax"][name], runs["mp"][name][0]
    assert len(got["step_losses"]) == len(want["step_losses"]) == 2 * 3
    _close(got["step_losses"], want["step_losses"], LOSS, "losses")
    _close(got["center"], want["center"], CENTER, "center")
    _close(got["inv_cov"], want["inv_cov"], STATS, "inv_cov")
    _close(got["scores"], want["scores"], SCORES, "scores")
    _close(got["rec"], want["rec"], SCORES, "reconstruction errors")
    for part, band in (("params", PARAMS), ("batch_stats", STATS)):
        mine = tree(got, part)
        assert sorted(mine) == sorted(want[part])
        for k, v in want[part].items():
            _close(mine[k], v, band, k)


@pytest.mark.parametrize("name", JAX_SCENARIOS + PORT_SCENARIOS)
def test_the_mesh_matches_one_process(name, runs):
    want, got = runs["one"][name], runs["mp"][name][0]
    assert int(got["step"]) == int(want["step"]) == 2 * 3
    _close(got["step_losses"], want["step_losses"], LOSS, "losses")
    _close(got["epoch_losses"], want["epoch_losses"], LOSS, "epoch losses")
    _close(got["center"], want["center"], CENTER, "center")
    _close(got["mean_vector"], want["mean_vector"], CENTER, "mean_vector")
    _close(got["scores"], want["scores"], SCORES, "scores")
    for part, band in (("params", PARAMS), ("batch_stats", STATS)):
        mine, theirs = tree(got, part), tree(want, part)
        assert sorted(mine) == sorted(theirs)
        for k in theirs:
            _close(mine[k], theirs[k], band, k)


@pytest.mark.parametrize("name", ["autoencoder", "vae"])
def test_the_split_reverse_projector_gathers_the_whole_channel_major_hidden(name, runs):
    """K1's decoder input under a model axis (`ReverseProjector.channel_major`):
    each rank gathers the whole flat hidden state, the module route's
    [B, T, V, H] transposed, and one process's to its band."""
    one = runs["one"][name]
    for rank, got in enumerate(runs["mp"][name]):
        assert got["rev_channel_major"].shape == one["rev_channel_major"].shape, f"rank {rank}"
        np.testing.assert_array_equal(got["rev_channel_major"].transpose(0, 2, 3, 1),
                                      got["rev_hidden"], err_msg=f"rank {rank}")
        _close(got["rev_channel_major"], one["rev_channel_major"], PARAMS, f"rank {rank}")


@pytest.mark.parametrize("name", JAX_SCENARIOS + PORT_SCENARIOS + ("checkpoint",))
def test_the_ranks_hold_the_same_bits(name, runs):
    ranks = runs["mp"][name]
    first = {k: v for k, v in ranks[0].items() if not k.startswith("local_shape/")}
    for rank, other in enumerate(ranks[1:], 1):
        for k in first:
            assert np.array_equal(other[k], first[k]), f"rank {rank} differs in {k}"


@pytest.mark.parametrize("name", JAX_SCENARIOS)
def test_each_rank_holds_jaxs_shard_of_each_kernel(name, runs):
    want = runs["shapes"][name]
    split = {k for k in want if tree(runs["one"][name], "params")[k].shape != want[k]}
    assert split, "no kernel is split"
    assert all("btlnk" in k and k.endswith("kernel") for k in split), split
    for rank, got in enumerate(runs["mp"][name]):
        shapes = {k: tuple(v) for k, v in tree(got, "local_shape").items()}
        assert shapes == {k: tuple(v) for k, v in want.items()}, f"rank {rank}"


def test_a_checkpoint_goes_one_to_the_mesh_and_back_unchanged(runs):
    prefix = runs["prefix"]
    with open(prefix + "one.ckpt", "rb") as f, open(prefix + "again.ckpt", "rb") as g:
        assert f.read() == g.read()


def test_the_meshs_checkpoint_restores_in_one_process(runs):
    trainer = worker.checkpoint_trainer(1)
    state, _, extra = checkpoint.restore(runs["prefix"] + "trained.ckpt", trainer)
    assert extra == {"epoch": 1}
    z = trainer.embed_all(state, trainer.train_ds, trainer.train_data)
    got = runs["mp"]["checkpoint"][0]
    _close(z, got["z_trained"], LATENT, "latents")
    np.testing.assert_array_equal(state.center.numpy(), got["center"])


def test_the_meshs_checkpoint_restores_in_jax(runs):
    jt, _ = jax_trainer(worker.scenario_config("autoencoder", 2))
    template = jt.init_state()
    jstate, _, _ = jcheckpoint.restore(runs["prefix"] + "trained.ckpt", template)
    jstate = jt.attach_state(jstate)
    z = jt.embed_all(jstate, jt.train_ds, jt.train_data)
    _close(z, runs["mp"]["checkpoint"][0]["z_trained"], LATENT, "latents")


def test_fused_train_on_is_refused_with_a_model_axis(runs):
    for rank in runs["mp"]["fused_on"]:
        assert str(rank["message"]) == (
            "fused_train='on' requires sts_gcn encoder, linear projector, dropout 0, an "
            "encoder-only variant and model_parallel 1")


# ---------------------------------------------------------- no processes


@pytest.mark.parametrize("world,data,model,want", [
    (4, -1, 2, (2, 2)), (4, 2, 2, (2, 2)), (4, -1, 4, (1, 4)), (8, -1, 2, (4, 2)),
    (2, -1, 1, (2, 1))])
def test_the_mesh_shape_is_data_times_model(world, data, model, want):
    assert mesh.mesh_shape(world, data, model) == want


def test_the_rank_order_is_jaxs():
    """Rank r sits where JAX's create_mesh(2, 2) puts device r: data index
    r // 2, model index r % 2; each rank's rows are that data index's."""
    jmesh = jax_mesh()
    idx = torch.arange(3 * 32).reshape(3, 32)
    for r, device in enumerate(jax.devices()[:4]):
        d, m = map(int, np.argwhere(jmesh.devices == device)[0])
        lay = mesh.Layout(world=4, rank=r, model_world=2)
        assert (lay.data_rank, lay.model_rank) == (d, m)
        assert torch.equal(lay.rows(idx, dim=1), idx[:, d * 16:(d + 1) * 16])


def test_the_split_dims_are_jaxs_param_spec():
    from coskad_tpu.parallel.mesh import _param_spec

    names = ["btlnk.kernel", "btlnk.bias", "btlnk.hidden_0.kernel", "btlnk.out.kernel",
             "btlnk.bn_0.scale", "rev_btlnk.kernel", "rev_btlnk.bias", "fc_mean.kernel",
             "encoder.layer_0.gcn.t_adj", "encoder.layer_0.tcn_dense.kernel"]
    for name in names:
        for shape in ((6, 4), (6,), (2, 3, 4)):
            spec = tuple(_param_spec(name.split("."), np.zeros(shape)))
            dim = mesh.split_dim(name, len(shape))
            want = None if "model" not in spec else spec.index("model")
            assert dim == want, (name, shape)


def test_no_path_projects_with_a_shard_of_the_folded_projector():
    """Under a model axis K1's fold carries this rank's rows of btlnk.kernel:
    the folded forward refuses them, and the fused train kernels refuse a
    split projector, where each would compute with a shard."""
    from coskad_tpu_torch.kernels import stse_fused, stse_train
    from coskad_tpu_torch.models import STSE

    model = STSE(2, (8, 4, 8), 16, 4, n_frames=12, n_joints=17)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 2, 12, 17)).astype(np.float32))
    folded, _ = model.folded()
    whole = stse_fused.fused_stse_forward_reference(x, folded)
    mesh.shard_model(model, mesh.Layout(world=4, rank=1, model_world=2))
    assert tuple(model.btlnk.kernel.shape) == (12 * 17 * 16 // 2, 4)
    folded, _ = model.folded()
    with pytest.raises(ValueError, match="model-parallel shard"):
        stse_fused.fused_stse_forward_reference(x, folded)
    with pytest.raises(ValueError, match="split over a model axis"):
        stse_train.encoder_ops(model)
    assert whole.shape == (3, 4)

