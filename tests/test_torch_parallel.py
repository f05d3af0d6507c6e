"""Data parallelism of the port (`coskad_tpu_torch/parallel/mesh.py`) on the
CPU: ranks are gloo processes (tests/torch_dp_worker.py, one thread each),
over tests/mp_scenario.py's data: 96 windows, batch 32, 2 epochs, SGD.

  * W=4 against the JAX Trainer on a 4-device CPU mesh in this process,
    from the same weights (carried in through `interop.load_jax_variables`):
    the linear-head module path with a Mahalanobis static center, and the
    fused path at ghost 8 (JAX's reference under `shard_map`);
  * W=2 against one process (the same scenario run here) for the MLP head,
    dropout, the contrastive view, and the VAE on fed draws and on its own;
  * the ranks' parameters and running statistics equal bit for bit;
  * the batch rounding, the eval chunks and the rank blocks against JAX's
    formulas and its data sharding, with no processes; at world size 1 no
    collective runs and the results are the one-process bits.

Bands, those tests/test_torch_train.py uses for one process: per-step
losses rtol 3e-4 (SGD), center rtol 1e-3 / atol 1e-6, running statistics
and the inverse covariance rtol 1e-3 / atol 1e-5, scores rtol 1e-3 / atol
1e-6, parameters rtol 3e-4 / atol 1e-6. The Mahalanobis scenario shrinks
its covariance (opt.cov_shrinkage 0.5): unshrunk, the inverse covariance of
96 latents in 16 dimensions amplifies the order of the sums so far that
JAX's own 4-device run is 9e-3 past the band from its 1-device run; its
parameters are not held (JAX's 4- and 1-device runs are 1.2e-4 past the
parameter band there too), its losses, scores and statistics are."""

import os
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from coskad_tpu.data.windows import SegmentDataset as JaxSegmentDataset
from coskad_tpu.parallel import create_mesh as jax_create_mesh
from coskad_tpu.train.loop import Trainer as JaxTrainer
from coskad_tpu.utils.logging import MetricLogger as JaxLogger
from coskad_tpu_torch.interop import flatten_tree
from coskad_tpu_torch.parallel import mesh
from coskad_tpu_torch.utils.net import free_port
from test_torch_train import _capturing

import torch_dp_worker as worker

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dp_worker.py")
JAX_SCENARIOS = ("module_mahalanobis", "fused_ghost8")
PORT_SCENARIOS = ("mlp_head", "dropout", "contrastive", "vae", "vae_sampled")
GROUP_TIMEOUT = 240
LOSS = dict(rtol=3e-4, atol=0.0)
CENTER = dict(rtol=1e-3, atol=1e-6)
STATS = dict(rtol=1e-3, atol=1e-5)
SCORES = dict(rtol=1e-3, atol=1e-6)
PARAMS = dict(rtol=3e-4, atol=1e-6)


def jax_config(cfg):
    """The port's Config, field for field, as the JAX package's."""
    import dataclasses

    from coskad_tpu import config as jconfig

    return jconfig.Config(**{f: getattr(jconfig, type(getattr(cfg, f)).__name__)(
        **dataclasses.asdict(getattr(cfg, f))) for f in ("model", "data", "opt", "eval", "run")})


def start_group(world, names, weights_path, prefix):
    """The named scenarios on a gloo group of `world` worker processes,
    started; `collect` waits for them."""
    port = free_port("localhost")
    env = dict(os.environ, PYTHONPATH=ROOT, XLA_FLAGS="")
    procs = [subprocess.Popen([sys.executable, WORKER, str(rank), str(world), str(port),
                               weights_path, prefix, *names], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(world)]
    return procs, names, prefix


def collect(group):
    """{name: [rank 0's results, rank 1's, ...]} of a started group."""
    procs, names, prefix = group
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=GROUP_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} of {len(procs)} failed:\n{log[-4000:]}"
    return {name: [dict(np.load(f"{prefix}{name}.rank{rank}.npz")) for rank in range(len(procs))]
            for name in names}


def jax_run(name):
    """JAX's Trainer on a 4-device mesh: its results, and its initial
    weights under the worker's keys."""
    cfg, lr, _ = worker.SCENARIOS[name]
    ds = worker.dataset()
    log = _capturing(JaxLogger)
    jt = JaxTrainer(jax_config(cfg), JaxSegmentDataset(ds.data, ds.meta, ds.frame_ids,
                                                       num_transform=1),
                    mesh=jax_create_mesh(4, 1, devices=jax.devices()[:4]), logger=log)
    jt.tx = optax.sgd(lr)
    state = jt.init_state()
    weights = {f"{name}.{part}.{k}": v for part in ("params", "batch_stats")
               for k, v in flatten_tree(jax.device_get(getattr(state, part))).items()}
    state, _ = jt.fit(jt.initialize_center(state), epochs=worker.EPOCHS)
    scores, _ = jt.score_all(state, jt.train_ds, jt.train_data)
    return dict(step_losses=np.asarray(log.losses), center=np.asarray(state.center),
                inv_cov=np.asarray(state.inv_cov), scores=np.asarray(scores),
                params=flatten_tree(jax.device_get(state.params)),
                batch_stats=flatten_tree(jax.device_get(state.batch_stats))), weights


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run of the file, overlapped: the W=2 group runs while JAX
    trains here, the W=4 group (on JAX's weights) while the one-process
    baselines run here."""
    tmp = tmp_path_factory.mktemp("dp")
    w2 = start_group(2, PORT_SCENARIOS, "-", str(tmp / "w2_"))
    jax_out, weights = {}, {}
    for name in JAX_SCENARIOS:
        jax_out[name], more = jax_run(name)
        weights.update(more)
    np.savez(str(tmp / "weights.npz"), **weights)
    w4 = start_group(4, JAX_SCENARIOS, str(tmp / "weights.npz"), str(tmp / "w4_"))
    one = {name: worker.run(name) for name in PORT_SCENARIOS}
    return dict(jax=jax_out, one=one, w2=collect(w2), w4=collect(w4))


def tree(result, part):
    return {k[len(part) + 1:]: v for k, v in result.items() if k.startswith(part + "/")}


@pytest.mark.parametrize("name", JAX_SCENARIOS)
def test_four_ranks_match_the_jax_mesh(name, runs):
    want, got = runs["jax"][name], runs["w4"][name][0]
    assert len(got["step_losses"]) == len(want["step_losses"]) == 2 * 3
    np.testing.assert_allclose(got["step_losses"], want["step_losses"], **LOSS)
    np.testing.assert_allclose(got["center"], want["center"], **CENTER)
    np.testing.assert_allclose(got["inv_cov"], want["inv_cov"], **STATS)
    np.testing.assert_allclose(got["scores"], want["scores"], **SCORES)
    stats = tree(got, "batch_stats")
    assert sorted(stats) == sorted(want["batch_stats"])
    for k, v in want["batch_stats"].items():
        np.testing.assert_allclose(stats[k], v, **STATS, err_msg=k)
    if name == "fused_ghost8":
        params = tree(got, "params")
        for k, v in want["params"].items():
            np.testing.assert_allclose(params[k], v, **PARAMS, err_msg=k)


@pytest.mark.parametrize("name", PORT_SCENARIOS)
def test_two_ranks_match_one_process(name, runs):
    want, got = runs["one"][name], runs["w2"][name][0]
    assert int(got["step"]) == int(want["step"]) == 2 * 3
    np.testing.assert_allclose(got["step_losses"], want["step_losses"], **LOSS)
    np.testing.assert_allclose(got["epoch_losses"], want["epoch_losses"], **LOSS)
    np.testing.assert_allclose(got["center"], want["center"], **CENTER)
    np.testing.assert_allclose(got["mean_vector"], want["mean_vector"], **CENTER)
    np.testing.assert_allclose(got["scores"], want["scores"], **SCORES)
    for part, band in (("params", PARAMS), ("batch_stats", STATS)):
        mine, theirs = tree(got, part), tree(want, part)
        assert sorted(mine) == sorted(theirs)
        for k in theirs:
            np.testing.assert_allclose(mine[k], theirs[k], **band, err_msg=k)


@pytest.mark.parametrize("group,name", [("w4", n) for n in JAX_SCENARIOS]
                         + [("w2", n) for n in PORT_SCENARIOS])
def test_ranks_hold_the_same_bits(group, name, runs):
    ranks = runs[group][name]
    first = ranks[0]
    for rank, other in enumerate(ranks[1:], 1):
        assert sorted(other) == sorted(first)
        for k in first:
            assert np.array_equal(other[k], first[k]), f"rank {rank} differs in {k}"


# ---------------------------------------------------------- no processes


@pytest.mark.parametrize("n,batch,world", [(96, 32, 4), (96, 32, 1), (5, 32, 4), (3, 32, 4),
                                           (100, 30, 4), (1, 8, 2), (2048, 2048, 8)])
def test_train_batch_is_jaxs_rounding(n, batch, world):
    # coskad_tpu/train/loop.py:829-831, 869
    bs = min(batch, max(n // world, 1) * world)
    assert mesh.train_batch(n, batch, world) == bs


@pytest.mark.parametrize("n,batch,world", [(96, 32, 4), (100, 32, 4), (2048, 512, 8),
                                           (97, 32, 1)])
def test_eval_chunks_are_jaxs_where_a_batch_divides(n, batch, world):
    # coskad_tpu/train/loop.py:663-676: chunks of the batch, the tail wrap-padded
    bs, k = mesh.eval_chunks(n, batch, world)
    assert (bs, k) == (batch, (n + batch - 1) // batch)


@pytest.mark.parametrize("n,batch,world,want", [(10, 32, 4, (12, 1)), (3, 32, 4, (4, 1)),
                                                (33, 32, 3, (33, 1)), (70, 30, 4, (32, 3))])
def test_eval_chunks_pad_to_the_world(n, batch, world, want):
    bs, k = mesh.eval_chunks(n, batch, world)
    assert (bs, k) == want and bs % world == 0 and bs * k >= n


def test_rank_blocks_are_jaxs_data_sharding():
    """Each rank's block of a [K, B] index chunk is the shard JAX's
    PartitionSpec(None, 'data') puts on that device of a 4-device mesh."""
    jmesh = jax_create_mesh(4, 1, devices=jax.devices()[:4])
    idx = np.arange(3 * 32).reshape(3, 32)
    sharded = jax.device_put(idx, NamedSharding(jmesh, PartitionSpec(None, "data")))
    shards = {s.device: np.asarray(s.data) for s in sharded.addressable_shards}
    for rank, device in enumerate(jmesh.devices[:, 0]):
        got = mesh.Layout(world=4, rank=rank).rows(torch.from_numpy(idx), dim=1).numpy()
        np.testing.assert_array_equal(got, shards[device])


def test_a_sharded_draw_keeps_the_ranks_rows_of_the_global_draw():
    def draw(shape):
        return torch.arange(int(np.prod(shape))).reshape(shape)

    assert torch.equal(mesh.local_draw(draw, (3, 2)), draw((3, 2)))
    with mesh.sharded(mesh.Layout(world=2, rank=1)):
        assert torch.equal(mesh.local_draw(draw, (3, 2)), draw((6, 2))[3:])
        with mesh.sharded(mesh.Layout()):  # one rank: no scope
            assert mesh.active() is None
        assert mesh.active() == mesh.Layout(world=2, rank=1)
    assert mesh.active() is None
    with pytest.raises(ValueError, match="equal blocks"):
        mesh.Layout(world=4, rank=0).block(6)


def test_world_one_runs_no_collective_and_keeps_the_bits(monkeypatch):
    """Inside a gloo group of one rank the Trainer is the one-process path
    to the bit, and calls no collective."""
    want = worker.run("fused_ghost8")
    mesh.initialize_distributed(f"localhost:{free_port('localhost')}", 1, 0, device="cpu")
    try:
        assert mesh.layout() == mesh.Layout(world=1, rank=0, backend="gloo")

        def refuse(*args, **kwargs):
            raise AssertionError("a collective ran at world size 1")

        for op in ("all_reduce", "all_gather", "broadcast"):
            monkeypatch.setattr(torch.distributed, op, refuse)
        got = worker.run("fused_ghost8")
    finally:
        monkeypatch.undo()
        mesh.destroy()
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_the_orbax_flavor_is_refused_by_name():
    from coskad_tpu_torch.train import checkpoint

    for fn in (checkpoint.save_orbax, checkpoint.restore_orbax):
        with pytest.raises(NotImplementedError, match="Orbax directory checkpoint"):
            fn("ckpt_dir")
