"""The port's tooling against the JAX package's, on seeded numpy inputs: the
Poincaré tools no training path calls and the Möbius layers
(`geometry/poincare.py`, `geometry/hyperbolic_nn.py`), the trajectory
helpers (`data/trajectories.py`), the plots and tables
(`visualize/plots.py`), `cli.eval --save-roc`, the clip visualizer and
the headless app (`visualize/clips.py`, `visualize/app.py`), and the
profiling harness (`utils/profiling.py`).

Bands: the Poincaré tools and the Möbius layers' values rtol 1e-5 / atol
1e-6 in float32 (the same formulas in another library's float32
arithmetic); a gradient, a sum over the batch, rtol 1e-5 / atol 1e-6 of
its scale (its largest magnitude, at least 1); the trajectory helpers, the
tables, the clip visualizer's frames and actors, the AUC and the thresholds
equal."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coskad_tpu.data import trajectories as jtraj
from coskad_tpu.geometry import hyperbolic_nn as jhnn
from coskad_tpu.geometry import poincare as jpm
from coskad_tpu.score.auc import best_threshold as jbest_threshold
from coskad_tpu.visualize import app as japp
from coskad_tpu.visualize import clips as jclips
from coskad_tpu.visualize import plots as jplots
from coskad_tpu.utils import profiling as jprofiling
from coskad_tpu_torch.data import trajectories as traj
from coskad_tpu_torch.geometry import hyperbolic_nn as hnn
from coskad_tpu_torch.geometry import poincare as pm
from coskad_tpu_torch.interop import load_jax_variables
from coskad_tpu_torch.utils import profiling
from coskad_tpu_torch.visualize import app, clips, plots

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def ball(rng, *shape, radius=0.8):
    """Points inside the unit ball: directions scaled to norms in (0, radius)."""
    x = rng.normal(size=shape)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    return (x * rng.uniform(0.05, radius, size=(*shape[:-1], 1))).astype(np.float32)


def close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
                               np.asarray(want), **TOL, err_msg=what)


def close_grad(got, want, what=""):
    want = np.asarray(want)
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL["rtol"], atol=TOL["atol"] * scale,
                               err_msg=what)


def t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------ Poincaré tools


@pytest.mark.parametrize("k", [-1.0, -0.5])
def test_the_maps_and_mobius_products_match_jax(k):
    rng = np.random.default_rng(0)
    r = 0.7 / np.sqrt(-k)
    x, y, u = ball(rng, 32, 6, radius=r), ball(rng, 32, 6, radius=r), rng.normal(
        size=(32, 6)).astype(np.float32) * 0.5
    m = rng.normal(size=(5, 6)).astype(np.float32)
    m[2] = 0.0  # a zero row: M x is zero in that component only
    m0 = np.zeros((5, 6), np.float32)  # M x all zero: the result is 0
    close(pm.arsinh(t(u)), jpm.arsinh(u), "arsinh")
    close(pm.expmap(t(x), t(u), k), jpm.expmap(x, u, k), "expmap")
    close(pm.logmap(t(x), t(y), k), jpm.logmap(x, y, k), "logmap")
    close(pm.mobius_scalar_mul(0.7, t(x), k), jpm.mobius_scalar_mul(0.7, x, k), "scalar")
    close(pm.mobius_matvec(t(m), t(x), k), jpm.mobius_matvec(m, x, k), "matvec")
    close(pm.mobius_matvec(t(m0), t(x), k), jpm.mobius_matvec(m0, x, k), "matvec of 0")


def test_the_maps_gradients_match_jax():
    rng = np.random.default_rng(1)
    x, y = ball(rng, 16, 5), ball(rng, 16, 5)
    w = rng.normal(size=(16, 5)).astype(np.float32)

    def jloss(x, y):
        return jnp.sum(jpm.logmap(x, jpm.expmap(x, y)) * w)

    gx, gy = jax.grad(jloss, argnums=(0, 1))(x, y)
    tx, ty = t(x).requires_grad_(), t(y).requires_grad_()
    torch.sum(pm.logmap(tx, pm.expmap(tx, ty)) * t(w)).backward()
    close_grad(tx.grad, gx, "d/dx")
    close_grad(ty.grad, gy, "d/dy")


@pytest.mark.parametrize("signed", [True, False])
def test_the_hyperplane_tools_match_jax(signed):
    rng = np.random.default_rng(2)
    x, p = ball(rng, 20, 4), ball(rng, 3, 4, radius=0.5)
    a = rng.normal(size=(3, 4)).astype(np.float32)
    close(pm.hyperbolic_softmax(t(x), t(a), t(p)), jpm.hyperbolic_softmax(x, a, p), "softmax")
    close(pm.dist2plane(t(x)[:, None, :], t(p), t(a), signed=signed),
          jpm.dist2plane(x[:, None, :], p, a, signed=signed), "dist2plane")


@pytest.mark.parametrize("d", [2, 3, 16, 64])
def test_auto_select_c_is_jaxs(d):
    assert pm.auto_select_c(d) == jpm.auto_select_c(d)


def test_gromov_delta_matches_jax():
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(24, 5)).astype(np.float32)
    d = np.linalg.norm(emb[:, None] - emb[None], axis=-1).astype(np.float32)
    close(pm.delta_hyp(t(d)), jpm.delta_hyp(d), "delta_hyp")
    close(pm.relative_delta(t(emb)), jpm.relative_delta(emb), "relative_delta")


@pytest.mark.parametrize("weighted", [False, True])
def test_the_frechet_mean_matches_jax(weighted):
    rng = np.random.default_rng(4)
    xs = ball(rng, 40, 6, radius=0.9)
    w = rng.uniform(0.1, 2.0, size=40).astype(np.float32) if weighted else None
    got = pm.frechet_mean(t(xs), weights=None if w is None else t(w))
    close(got, jpm.frechet_mean(xs, weights=w), "frechet_mean")
    # its gradient, through the 30 steps
    txs = t(xs).requires_grad_()
    torch.sum(pm.frechet_mean(txs) ** 2).backward()
    close_grad(txs.grad, jax.grad(lambda z: jnp.sum(jpm.frechet_mean(z) ** 2))(xs), "d/dxs")


# ------------------------------------------------------------ Möbius layers


def layer_pair(kind, **kw):
    """(flax module, its params as numpy, the port's layer from them)."""
    rng = np.random.default_rng(5)
    x = ball(rng, 12, 6)
    if kind == "linear":
        jmod = jhnn.MobiusLinear(features=4, **kw)
        tmod = hnn.MobiusLinear(6, 4, use_bias=kw.get("use_bias", True),
                                hyperbolic_input=kw.get("hyperbolic_input", True),
                                nonlin=torch.relu if kw.get("nonlin") else None)
    else:
        jmod = jhnn.MobiusDist2Hyperplane(features=4)
        tmod = hnn.MobiusDist2Hyperplane(6, 4)
    params = jax.device_get(jmod.init(jax.random.PRNGKey(0), x)["params"])
    params = jax.tree_util.tree_map(np.asarray, params)
    if kind == "dist":
        params["scale"] = rng.normal(size=4).astype(np.float32) * 0.3
    load_jax_variables(tmod, params, {})
    return jmod, params, tmod, x


@pytest.mark.parametrize("kind,kw", [
    ("linear", {}), ("linear", dict(use_bias=False)), ("linear", dict(hyperbolic_input=False)),
    ("linear", dict(nonlin=jax.nn.relu)), ("dist", {})],
    ids=["linear", "no_bias", "tangent_input", "relu", "dist2hyperplane"])
def test_the_mobius_layers_match_jax_values_and_gradients(kind, kw):
    jmod, params, tmod, x = layer_pair(kind, **kw)
    w = np.random.default_rng(6).normal(size=(12, 4)).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jmod.apply({"params": p}, x) * w)

    close(tmod(t(x)), jmod.apply({"params": params}, x), "forward")
    gp, gx = jax.grad(jloss, argnums=(0, 1))(params, x)
    tx = t(x).requires_grad_()
    torch.sum(tmod(tx) * t(w)).backward()
    close_grad(tx.grad, gx, "d/dx")
    for name, p in tmod.named_parameters():
        close_grad(p.grad, gp[name], f"d/d{name}")


def test_the_mobius_layers_draw_from_their_generator():
    a = hnn.MobiusLinear(6, 4, generator=torch.Generator().manual_seed(0))
    b = hnn.MobiusLinear(6, 4, generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    d = hnn.MobiusDist2Hyperplane(6, 4, generator=torch.Generator().manual_seed(1))
    assert bool(torch.all(torch.linalg.vector_norm(d.point, dim=-1) < 1.0))
    assert torch.equal(d.scale, torch.zeros(4))


# ------------------------------------------------------------ trajectories


def trajectory_pair(seed=7, n=30, joints=5):
    """The same trajectory in both packages: coordinates with a missing
    keypoint, two missing steps and a gap at the start."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(20, 400, size=(n, 2 * joints)).astype(np.float32)
    coords[3, 0] = 0.0
    coords[5:7] = 0.0
    coords[min(n, 12):15] = 0.0
    coords[min(n - 1, 16), 4] = 0.0
    frames = np.arange(1, n + 1, dtype=np.int32)
    return (traj.Trajectory("1-2_3", frames.copy(), coords.copy()),
            jtraj.Trajectory("1-2_3", frames.copy(), coords.copy()))


@pytest.mark.parametrize("delta,first", [(False, False), (True, False), (False, True),
                                         (True, True)])
def test_global_features_are_jaxs(delta, first):
    mine, theirs = trajectory_pair()
    np.testing.assert_array_equal(
        mine.global_features((856, 480), extract_delta=delta, use_first_step_as_reference=first),
        theirs.global_features((856, 480), extract_delta=delta,
                               use_first_step_as_reference=first))
    np.testing.assert_array_equal(mine.size_features((856, 480)),
                                  theirs.size_features((856, 480)))


@pytest.mark.parametrize("system", ["global", "bounding_box_centre", "bounding_box_top_left"])
def test_the_coordinate_systems_are_jaxs(system):
    mine, theirs = trajectory_pair()
    got = mine.change_coordinate_system((856, 480), system).coordinates
    np.testing.assert_array_equal(got, theirs.change_coordinate_system((856, 480),
                                                                       system).coordinates)
    with pytest.raises(ValueError, match="Unknown coordinate system"):
        mine.change_coordinate_system((856, 480), "polar")


def test_missing_steps_are_filled_as_jax_fills_them():
    mine, theirs = trajectory_pair()
    np.testing.assert_array_equal(mine.input_missing_steps().coordinates,
                                  theirs.input_missing_steps().coordinates)
    assert not np.all(mine.coordinates[5] == 0)  # the gap was filled


@pytest.mark.parametrize("pred", [0, 4, 12])
def test_short_trajectories_are_jaxs(pred):
    pairs = [trajectory_pair(seed, n) for seed, n in ((1, 10), (2, 20), (3, 30))]
    mine = {f"t{i}": p[0] for i, p in enumerate(pairs)}
    theirs = {f"t{i}": p[1] for i, p in enumerate(pairs)}
    assert (sorted(traj.remove_short_trajectories(mine, 6, 2, pred))
            == sorted(jtraj.remove_short_trajectories(theirs, 6, 2, pred)))
    # the default keeps today's rule
    assert (sorted(traj.remove_short_trajectories(mine, 6, 2))
            == sorted(jtraj.remove_short_trajectories(theirs, 6, 2)))


def test_the_ground_truth_assembly_is_jaxs(tmp_path):
    rng = np.random.default_rng(8)
    for vid, n in (("01-0001", 40), ("01-0002", 30)):
        np.save(tmp_path / f"{vid}.npy", (rng.uniform(size=n) > 0.7).astype(np.int8))
    masks, jmasks = traj.load_anomaly_masks(str(tmp_path)), jtraj.load_anomaly_masks(
        str(tmp_path))
    assert sorted(masks) == sorted(jmasks)
    ids = np.array(["01-0001_1"] * 20 + ["01-0001_2"] * 15 + ["01-0002_1"] * 25)
    frames = np.concatenate([np.arange(1, 21), np.arange(10, 25), np.arange(3, 28)])
    errors = rng.uniform(size=len(ids)).astype(np.float32)
    for a, b in zip(traj.assemble_ground_truth_and_reconstructions(masks, ids, frames, errors,
                                                                   return_video_ids=True),
                    jtraj.assemble_ground_truth_and_reconstructions(jmasks, ids, frames, errors,
                                                                    return_video_ids=True)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_the_split_and_the_skeleton_filter_are_jaxs():
    pairs = {f"1-{i}_1": trajectory_pair(i, 10 + 3 * i) for i in range(13)}
    mine = traj.split_into_train_and_test({k: p[0] for k, p in pairs.items()}, 0.7, seed=3)
    theirs = jtraj.split_into_train_and_test({k: p[1] for k, p in pairs.items()}, 0.7, seed=3)
    assert [list(d) for d in mine] == [list(d) for d in theirs]
    x = np.random.default_rng(9).normal(size=(10, 6)).astype(np.float32)
    x[[2, 7]] = 0.0
    other = np.arange(10)
    got, (kept,) = traj.remove_missing_skeletons(x, other)
    want, (jkept,) = jtraj.remove_missing_skeletons(x, other)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(kept, jkept)


# ------------------------------------------------------------ plots, tables


def test_plot_roc_gives_jaxs_auc_and_writes_a_png(tmp_path):
    rng = np.random.default_rng(10)
    y = rng.integers(0, 2, 300)
    s = rng.normal(size=300) + y
    auc = plots.plot_roc(y, s, str(tmp_path / "roc.png"))
    assert auc == jplots.plot_roc(y, s)
    assert os.path.getsize(tmp_path / "roc.png") > 0


def test_the_other_plots_write_pngs_and_return_jaxs_values(tmp_path):
    rng = np.random.default_rng(11)
    s = rng.normal(size=120)
    plots.plot_scores(s, gt=s > 0.5, path=str(tmp_path / "scores.png"), per_actor={1: s})
    z = rng.normal(size=(80, 16))
    plots.plot_latents(z, z[:, 0] > 0, center=np.zeros(16), path=str(tmp_path / "lat3.png"))
    plots.plot_latents(z, path=str(tmp_path / "lat2.png"), three_d=False)
    d = plots.plot_latent_sphere(z, path=str(tmp_path / "sphere.png"))
    np.testing.assert_array_equal(d, jplots.plot_latent_sphere(z))
    e = np.abs(rng.normal(size=(3, 120))) + 1e-3
    gt = np.zeros(120)
    gt[40:80] = 1
    c = plots.plot_person_scores(e, gt, path=str(tmp_path / "pp.png"))
    np.testing.assert_array_equal(c, jplots.plot_person_scores(e, gt))
    for name in ("scores", "lat3", "lat2", "sphere", "pp"):
        assert os.path.getsize(tmp_path / f"{name}.png") > 0, name


def test_the_tables_are_jaxs():
    stats = {"107_020.mp4": {"details": {"length": 100, "discarded_frames": 0}},
             "203_051.mp4": {"details": {"length": 80, "discarded_frames": 4,
                                         "perc_discarded": 5.0, "perc_abnormality": 40.0}},
             "212_0303.mp4": {"details": {"length": 90, "discarded_frames": 9,
                                          "perc_discarded": 10.0, "perc_abnormality": 20.0}},
             "global_stats": {"frames": 270}}
    for key in ("107_020.mp4", "203_051.mp4", "101_0152.mp4", "105_003.mp4"):
        assert plots.ubnormal_original_name(key) == jplots.ubnormal_original_name(key)
    for fmt in ("latex", "markdown"):
        assert plots.hr_stats_table(stats, fmt) == jplots.hr_stats_table(stats, fmt)
    aucs = {(1, 2): 0.91234, (1, 1): 0.85, (2, 1): 0.99}
    for fmt, by in (("markdown", "auc"), ("latex", "clip")):
        assert (plots.per_clip_auc_table(aucs, fmt, by)
                == jplots.per_clip_auc_table(aucs, fmt, by))
    for fn in (plots.hr_stats_table, plots.per_clip_auc_table):
        with pytest.raises(ValueError, match="unknown fmt"):
            fn({}, fmt="html")


def test_eval_save_roc_writes_jaxs_files_and_thresholds(tmp_path, capsys):
    from coskad_tpu_torch.cli import eval as eval_cli
    from coskad_tpu_torch.cli import train as train_cli
    from test_torch_cli import narrow_dataset

    path, _ = narrow_dataset(str(tmp_path))
    train_cli.main(["--config", path, "--epochs", "1", "--device", "cpu"])
    out = tmp_path / "roc"
    capsys.readouterr()
    run = eval_cli.main(["--config", path, "--device", "cpu", "--save-roc", str(out)])
    printed = capsys.readouterr().out
    k = len(run.result.per_transform_scores)
    # coskad_tpu/cli/eval.py:156-171: t<N>_roc_hyp.png from N = 0, then final_roc.png
    assert sorted(os.listdir(out)) == sorted([f"t{i}_roc_hyp.png" for i in range(k)]
                                             + ["final_roc.png"])
    for i in range(k):
        thr, _ = jbest_threshold(run.result.per_transform_gt[i],
                                 run.result.per_transform_scores[i])
        assert f"best threshold (transform {i + 1}): {thr}\n" in printed


# ------------------------------------------------------------ clips, app


def tiny_clip(rng, n_frames=6, joints=17):
    return {pid: {f"{f:04d}": {"keypoints": rng.uniform(50, 300, size=(joints, 3))
                               .reshape(-1).tolist()} for f in range(1, n_frames + 1)}
            for pid in ("1", "2")}


def write_clip(path, seed=12, n_frames=6):
    with open(path, "w") as f:
        json.dump(tiny_clip(np.random.default_rng(seed), n_frames), f)
    return str(path)


def test_the_clip_visualizer_is_jaxs(tmp_path):
    path = write_clip(tmp_path / "01_0001.json")
    mine = clips.ClipVisualizer("ubnormal").load_clip_json(path)
    theirs = jclips.ClipVisualizer("ubnormal").load_clip_json(path)
    assert mine.frame_keys() == theirs.frame_keys() and len(mine.frame_keys()) == 6
    for key in mine.frame_keys():
        a, b = mine.actors_in_frame(key), theirs.actors_in_frame(key)
        assert sorted(a) == sorted(b) == ["1", "2"]
        for pid in a:
            np.testing.assert_array_equal(a[pid], b[pid])
    assert (mine.frame_dim, mine.fps) == (theirs.frame_dim, theirs.fps)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    mine.render_frame(ax, mine.frame_keys()[0], scores={"1": 0.5})
    assert len(ax.lines) > 0
    plt.close(fig)
    with pytest.raises(ValueError, match="load_clip_json"):
        clips.ClipVisualizer().actors_in_frame("0001")


def test_extract_frames_round_trip(tmp_path):
    cv2 = pytest.importorskip("cv2")
    video = str(tmp_path / "v.mp4")
    w = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 5, (64, 48))
    for i in range(5):
        w.write(np.full((48, 64, 3), i * 50, np.uint8))
    w.release()
    assert clips.extract_frames(video, str(tmp_path / "frames")) == 5
    assert sorted(os.listdir(tmp_path / "frames")) == [f"{i}.jpg" for i in range(1, 6)]
    clips.extract_frames_tree(str(tmp_path), str(tmp_path / "tree"))
    assert sorted(os.listdir(tmp_path / "tree" / "v")) == [f"{i}.jpg" for i in range(1, 6)]


def test_the_headless_app_writes_one_file_a_clip(tmp_path):
    data = tmp_path / "poses"
    for name in ("01_0001", "02_0003"):
        os.makedirs(data / name)
        write_clip(data / name / app.TRACKED_JSON, n_frames=3)
    found = app.find_clip_jsons(str(data))
    assert found == japp.find_clip_jsons(str(data)) and len(found) == 2
    assert [app.clip_label(c) for c in found] == [japp.clip_label(c) for c in found]
    scores = tmp_path / "scores"
    os.makedirs(scores)
    np.save(scores / "error_per_person_scene_1_scenario_1.npy",
            np.arange(8, dtype=np.float32).reshape(2, 4))
    np.save(scores / "fig_ids_scene_1_scenario_1.npy", np.array([2, 1]))
    assert (app.load_clip_scores(found[0], str(scores))
            == japp.load_clip_scores(found[0], str(scores)))
    assert app.load_clip_scores(found[1], str(scores)) is None
    out = tmp_path / "out"
    app.main(["--data-dir", str(data), "--out-dir", str(out), "--scores-dir", str(scores)])
    assert sorted(os.listdir(out)) == ["01_0001.gif", "02_0003.gif"]
    assert all(os.path.getsize(out / f) > 0 for f in os.listdir(out))


# ------------------------------------------------------------ profiling


def test_the_timer_and_throughput_give_jaxs_keys():
    mine, theirs = profiling.Timer("mul"), jprofiling.Timer("mul")
    x = torch.ones(64, 64)
    for _ in range(3):
        with mine.measure(result=x * 2):
            pass
        with theirs.measure():
            pass
    assert sorted(mine.stats()) == sorted(theirs.stats())
    assert mine.stats()["mul/count"] == 3.0 and profiling.Timer().stats() == {}
    assert profiling.throughput(lambda a: a @ a, x, items_per_call=64, iters=3) > 0


def test_the_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(32, 32) @ torch.ones(32, 32)
    with open(tmp_path / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert prof.key_averages()


def test_device_memory_stats_are_empty_without_cuda():
    assert profiling.device_memory_stats() == {}


def test_debug_nans_raises_at_a_forward_nan():
    x = torch.tensor([-1.0, 2.0])
    with profiling.debug_nans():
        with pytest.raises(FloatingPointError, match="aten.log"):
            torch.log(x)
    assert torch.isnan(torch.log(x))[0]  # outside the scope nothing raises
    with profiling.debug_nans(False):
        torch.log(x)


def test_debug_nans_raises_at_a_backward_nan():
    y = torch.tensor([0.0, 1.0], requires_grad=True)
    with profiling.debug_nans():
        loss = torch.sum(torch.sqrt(y) * 0.0)  # a finite forward
        with pytest.raises(FloatingPointError):
            loss.backward()  # d sqrt at 0 is inf, times 0 is NaN
