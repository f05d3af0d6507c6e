"""The other encoders: the port's `models/graph.py` and `models/encoders.py`
(through `STSE(encoder_type=...)`) against the JAX package's on the same
inputs, with the flax weights carried across by `interop.load_jax_variables`.

Tolerances: the graph constants exactly (the same numpy code); forwards,
running statistics and parameter gradients rtol=2e-4, atol=2e-5 (fp32
reassociation, as tests/test_torch_models.py); a 2-epoch lockstep `fit`
under SGD: per-step losses and centers rtol 1e-3, scores rtol 1e-3,
atol 1e-6 and the validation AUC within 1e-4 (tests/test_torch_serve.py).
`st_gcn` runs at 17 joints, the openpose layout's."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from coskad_tpu import config as jconfig
from coskad_tpu.data.windows import SegmentDataset as JaxSegmentDataset
from coskad_tpu.models import STSE as JaxSTSE
from coskad_tpu.models import build_model as jax_build_model
from coskad_tpu.models import graph as jgraph
from coskad_tpu.parallel import create_mesh
from coskad_tpu.train import checkpoint as jcheckpoint
from coskad_tpu.train.loop import Trainer as JaxTrainer
from coskad_tpu.utils.logging import MetricLogger as JaxLogger
from coskad_tpu_torch.cli import eval as eval_cli
from coskad_tpu_torch.cli.common import load_config
from coskad_tpu_torch.data.windows import SegmentDataset
from coskad_tpu_torch.interop import flatten_tree, load_jax_variables, to_jax_variables
from coskad_tpu_torch.models import STSE, build_model, graph
from coskad_tpu_torch.train import checkpoint
from coskad_tpu_torch.train.loop import Trainer
from coskad_tpu_torch.utils.logging import MetricLogger
from test_torch_bf16 import cpu_bf16_dots
from test_torch_checkpoint import jax_moments, moments_by_name
from test_torch_stse_train import close_grad
from test_torch_train import _capturing, port_config

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-5)
OTHER = ("st_gcn", "learnable_gcn", "static_gcn", "cnn")
KW = dict(input_dim=2, layer_channels=(8, 4), hidden_dimension=8, latent_dim=4, n_frames=6,
          n_joints=17)
MODES = {"eval": dict(train=False), "train": dict(train=True),
         "frozen_bn": dict(train=True, frozen_bn=True)}


# ------------------------------------------------------------------ graph


@pytest.mark.parametrize("layout", sorted(jgraph.LAYOUTS))
def test_graph_functions_equal_jax(layout):
    for strategy in ("uniform", "distance", "spatial"):
        np.testing.assert_array_equal(graph.build_partitioned_adjacency(layout, strategy),
                                      jgraph.build_partitioned_adjacency(layout, strategy))
    num_node, links, _ = graph.LAYOUTS[layout]
    edges = [(i, i) for i in range(num_node)] + links
    for hop in (1, 2):
        np.testing.assert_array_equal(graph.hop_distance(num_node, edges, hop),
                                      jgraph.hop_distance(num_node, edges, hop))
    a = np.random.default_rng(0).uniform(size=(num_node, num_node)) > 0.7
    np.testing.assert_array_equal(graph.normalize_digraph(a * 1.0),
                                  jgraph.normalize_digraph(a * 1.0))
    with pytest.raises(ValueError, match="partition strategy"):
        graph.build_partitioned_adjacency(layout, "nope")
    assert graph.LAYOUTS == jgraph.LAYOUTS


@pytest.mark.parametrize("t,v", [(6, 17), (12, 18), (4, 5)])
def test_spacetime_adjacency_equals_jax(t, v):
    adj = graph.build_spacetime_adjacency(t, v)
    np.testing.assert_array_equal(adj, jgraph.build_spacetime_adjacency(t, v))
    # the spatial block is replicated over every frame pair
    flat = adj.reshape(t, v, t, v)
    assert flat[0, 0, t - 1, 1] > 0 and adj.dtype == np.float32


# ----------------------------------------------------------------- models


def jax_variables(jmodel, x, seed=0):
    """flax init, then BN affines and running statistics and the edge
    importances away from their init values."""
    variables = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(x[:2]))
    rng = np.random.default_rng(seed)

    def jitter(path, v):
        keys = [getattr(p, "key", "") for p in path]
        name, owner = keys[-1], keys[-2] if len(keys) > 1 else ""
        if "bn" in owner and name in ("scale", "var"):
            return jnp.asarray(rng.uniform(0.5, 1.5, np.shape(v)), jnp.float32)
        if "bn" in owner and name in ("bias", "mean"):
            return jnp.asarray(rng.uniform(-0.3, 0.3, np.shape(v)), jnp.float32)
        if name.startswith("edge_importance"):
            return jnp.asarray(rng.uniform(0.5, 1.5, np.shape(v)), jnp.float32)
        return v

    variables = {k: jax.tree_util.tree_map_with_path(jitter, v) for k, v in variables.items()}
    variables.setdefault("batch_stats", {})  # the plain GCNs have no BatchNorm
    return variables


def pair(encoder_type, batch=6, seed=0, **kw):
    kw = dict(KW, **kw)
    jmodel = JaxSTSE(encoder_type=encoder_type, projector="linear", **kw)
    x = np.random.default_rng(seed + 20).normal(
        size=(batch, kw["input_dim"], kw["n_frames"], kw["n_joints"])).astype(np.float32)
    variables = jax_variables(jmodel, x, seed)
    model = STSE(encoder_type=encoder_type, **kw)
    load_jax_variables(model, variables["params"], variables["batch_stats"])
    return jmodel, variables, model, x


def jax_forward_and_grads(jmodel, variables, x, r, mode):
    """z, the new batch_stats (train modes) and d sum(z * r) / d params."""
    kwargs = MODES[mode]

    def loss(params):
        v = {"params": params, "batch_stats": variables["batch_stats"]}
        if kwargs["train"]:
            z, mutated = jmodel.apply(v, jnp.asarray(x), mutable=["batch_stats"], **kwargs)
            return jnp.sum(z * r), (z, mutated.get("batch_stats", {}))
        z = jmodel.apply(v, jnp.asarray(x), **kwargs)
        return jnp.sum(z * r), (z, variables["batch_stats"])

    (_, (z, stats)), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    return np.asarray(z), jax.device_get(stats), jax.device_get(grads)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("encoder_type", OTHER)
def test_stse_forward_stats_and_grads_match_flax(encoder_type, mode):
    jmodel, variables, model, x = pair(encoder_type)
    r = np.random.default_rng(5).normal(size=(x.shape[0], KW["latent_dim"])).astype(np.float32)
    z_ref, stats_ref, grads_ref = jax_forward_and_grads(jmodel, variables, x, r, mode)
    z = model(torch.from_numpy(x), **MODES[mode])
    np.testing.assert_allclose(z.detach().numpy(), z_ref, **TOL)
    (z * torch.from_numpy(r)).sum().backward()
    got_stats = flatten_tree(to_jax_variables(model)[1])
    for k, v in flatten_tree(stats_ref).items():
        np.testing.assert_allclose(got_stats[k], v, err_msg=k, **TOL)
    grads = {n: p.grad for n, p in model.named_parameters()}
    for k, v in flatten_tree(grads_ref).items():
        close_grad(np.zeros_like(v) if grads[k] is None else grads[k].numpy(), v, k)
    assert not model.kernel_takes() and model._fold_cache is None


def test_bf16_config_keeps_the_other_encoders_float32():
    """make_encoder gives the compute dtype to the sts_gcn stack only: at
    bf16 the other encoders' hidden state is the float32 model's to the
    bit, and the linear projector still rounds, as JAX's bf16 STSE does."""
    for encoder_type in OTHER:
        jmodel, variables, f32, x = pair(encoder_type, seed=2)
        bf16 = STSE(encoder_type=encoder_type, dtype=torch.bfloat16, **KW)
        bf16.load_state_dict(f32.state_dict())
        xt = torch.from_numpy(x)
        with torch.no_grad():
            _, h16 = bf16.encode(xt)
            _, h32 = f32.encode(xt)
            z16 = bf16(xt)
        assert torch.equal(h16, h32), encoder_type
        jbf16 = JaxSTSE(encoder_type=encoder_type, projector="linear", dtype=jnp.bfloat16, **KW)
        with cpu_bf16_dots():
            z_ref = np.asarray(jbf16.apply(variables, jnp.asarray(x)), np.float32)
        scale = max(float(np.abs(z_ref).max()), 1.0)
        assert float(np.abs(z16.numpy() - z_ref).max()) <= 2.0 ** -7 * scale, encoder_type
        assert not torch.equal(z16, f32(xt).detach()), "the bf16 projector did not round"


def test_decoder_variants_and_unknown_types_are_refused_as_jax_refuses():
    x = jnp.zeros((1, 2, 6, 17))
    for encoder_type in OTHER:
        for use_vae in (False, True):
            jmodel = jax_build_model(use_decoder=True, use_vae=use_vae,
                                     encoder_type=encoder_type, **KW)
            with pytest.raises(ValueError, match="No decoder available") as jerr:
                jmodel.init(jax.random.PRNGKey(0), x)
            with pytest.raises(ValueError, match="No decoder available") as err:
                build_model(use_decoder=True, use_vae=use_vae, encoder_type=encoder_type,
                            **KW)
            assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError, match="not supported") as jerr:
        JaxSTSE(encoder_type="gat", **KW).init(jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError, match="not supported") as err:
        STSE(encoder_type="gat", **KW)
    assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError, match="openpose has 17 joints"):
        STSE(encoder_type="st_gcn", **dict(KW, n_joints=18))


def test_inits_follow_flax():
    """Edge importances all ones, the learnable adjacency in [0, 1), the
    plain GCN weights within +-1/sqrt(C_out), the temporal conv's
    lecun-normal kernel (truncated at 2 sigma) with a zero bias; one
    generator seed gives one set of weights."""
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    st = STSE(encoder_type="st_gcn", **KW)
    st.reset_parameters(gen())
    assert all(torch.equal(getattr(st.encoder, f"edge_importance_{i}"),
                           torch.ones_like(st.encoder.adj)) for i in range(3))
    conv = st.encoder.layer_0.tconv
    std = (1.0 / (9 * conv.kernel.shape[2])) ** 0.5 / 0.87962566103423978
    assert float(conv.kernel.detach().abs().max()) <= 2 * std and not conv.bias.any()
    learn = STSE(encoder_type="learnable_gcn", **KW)
    learn.reset_parameters(gen())
    adj = learn.encoder.adj_0.detach()
    assert float(adj.min()) >= 0.0 and float(adj.max()) < 1.0
    w = learn.encoder.layer_1.weight.detach()
    assert float(w.abs().max()) <= 1.0 / w.shape[1] ** 0.5
    again = STSE(encoder_type="learnable_gcn", **KW)
    again.reset_parameters(gen())
    assert all(torch.equal(a, b) for a, b in zip(learn.state_dict().values(),
                                                 again.state_dict().values()))


@pytest.mark.parametrize("t,c_in,c_out", [(6, 3, 5), (3, 4, 4), (12, 2, 8)])
def test_temporal_conv_is_the_padded_9x1_convolution(t, c_in, c_out):
    """The per-tap matmul sum is the 9x1 convolution with padding 4 over
    time, values and gradients, in float64 (frames fewer than the taps
    included)."""
    from coskad_tpu_torch.models.encoders import TemporalConv

    conv = TemporalConv(c_in, c_out).double()
    conv.reset_parameters(torch.Generator().manual_seed(5))
    with torch.no_grad():
        conv.bias.uniform_(-1.0, 1.0, generator=torch.Generator().manual_seed(6))
    rng = np.random.default_rng(7)
    h = torch.tensor(rng.normal(size=(3, t, 5, c_in)), requires_grad=True)
    r = torch.tensor(rng.normal(size=(3, t, 5, c_out)))
    got = conv(h)
    got_grads = torch.autograd.grad((got * r).sum(), [h, conv.kernel, conv.bias])
    want = torch.nn.functional.conv2d(h.permute(0, 3, 1, 2), conv.kernel.permute(3, 2, 0, 1),
                                      conv.bias, padding=(4, 0)).permute(0, 2, 3, 1)
    want_grads = torch.autograd.grad((want * r).sum(), [h, conv.kernel, conv.bias])
    assert got.shape == (3, t, 5, c_out)
    for a, b in zip((got, *got_grads), (want, *want_grads)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-12,
                                   atol=1e-12)


# --------------------------------------------------------------- lockstep


def _windows(rng, n, v=17, t=6):
    return rng.normal(size=(n, 3, t, v)).astype(np.float32)


def _val_set(rng, t=6, v=17):
    """Two people over one 30-frame clip, a window starting at each frame;
    person 1 moves wildly in frames 12-20, which the ground truth marks."""
    starts = np.arange(1, 25)
    data, meta, fids = [], [], []
    for person in (1, 2):
        for s in starts:
            w = _windows(rng, 1, v, t)[0]
            if person == 1 and 10 <= s <= 20:
                w = w * 4.0
            data.append(w)
            meta.append([1, 1, person, s])
            fids.append(s + np.arange(t))
    gt = np.zeros(30, np.int64)
    gt[11:20] = 1
    return (np.stack(data), np.asarray(meta, np.int64), np.asarray(fids, np.int32),
            {(1, 1): gt})


@pytest.mark.parametrize("encoder_type", ["st_gcn", "learnable_gcn"])
def test_lockstep_fit_matches_jax_trainer(encoder_type):
    """Two epochs of Trainer.fit under SGD on both sides (euclidean_dynamic,
    4 steps an epoch, validation on): per-step losses, the center after each
    epoch, the validation AUC, then score_all over the validation set."""
    rng = np.random.default_rng(0)
    n_win = 64
    data = _windows(rng, n_win)
    meta = np.tile([1, 1, 1, 1], (n_win, 1)).astype(np.int64)
    fids = np.tile(np.arange(1, 7), (n_win, 1)).astype(np.int32)
    vdata, vmeta, vfids, gt = _val_set(rng)
    lr = 0.05
    cfg = jconfig.Config(
        model=jconfig.ModelConfig(variant="euclidean_dynamic", channels=(8, 4), h_dim=8,
                                  latent_dim=4, encoder_type=encoder_type),
        data=jconfig.DataConfig(seg_len=6, n_joints_override=17, batch_size=32,
                                num_transform=2),
        opt=jconfig.OptConfig(lr=lr, epochs=2, validation=True),
        run=jconfig.RunConfig(fused_train="auto"),
    )
    jlog = _capturing(JaxLogger)
    jtrainer = JaxTrainer(cfg, JaxSegmentDataset(data, meta, fids, num_transform=2),
                          val_ds=JaxSegmentDataset(vdata, vmeta, vfids, num_transform=2),
                          ground_truths=gt, mesh=create_mesh(1, 1, devices=jax.devices()[:1]),
                          logger=jlog)
    jtrainer.tx = optax.sgd(lr)
    jstate = jtrainer.initialize_center(jtrainer.init_state())

    log = _capturing(MetricLogger)
    trainer = Trainer(port_config(cfg), SegmentDataset(data, meta, fids, num_transform=2),
                      val_ds=SegmentDataset(vdata, vmeta, vfids, num_transform=2),
                      ground_truths=gt, device="cpu", logger=log)
    load_jax_variables(trainer.model, jax.device_get(jstate.params),
                       jax.device_get(jstate.batch_stats))
    trainer.optimizer = torch.optim.SGD(trainer.model.parameters(), lr=lr)
    state = trainer.init_state().replace(center=torch.from_numpy(np.array(jstate.center)))
    assert not trainer._fused_compat

    for epoch in range(2):
        jstate, jhist = jtrainer.fit(jstate, epochs=1)
        state, hist = trainer.fit(state, epochs=1)
        np.testing.assert_allclose(state.center.numpy(), np.asarray(jstate.center),
                                   rtol=1e-3, atol=1e-6, err_msg=f"center after epoch {epoch}")
        assert abs(hist["validation_auc"][0] - jhist["validation_auc"][0]) <= 1e-4
    assert len(log.losses) == len(jlog.losses) == 8
    np.testing.assert_allclose(log.losses, jlog.losses, rtol=1e-3)
    js, _ = jtrainer.score_all(jstate, jtrainer.val_ds, jtrainer.val_data)
    s, _ = trainer.score_all(state, trainer.val_ds, trainer.val_data)
    np.testing.assert_allclose(s, js, rtol=1e-3, atol=1e-6)


# ------------------------------------------------------------- checkpoint


@pytest.mark.parametrize("encoder_type", ["st_gcn", "learnable_gcn"])
def test_checkpoints_cross_both_ways(encoder_type, tmp_path):
    """A JAX Trainer's checkpoint (Adam after an epoch, so optax's flat
    mu / nu are cut by name, `edge_importance_0` and `adj_0` sorting before
    `layer_0`) restored into the port: the same weights, moments and scores;
    then the port's checkpoint restored by JAX: the same moments."""
    rng = np.random.default_rng(1)
    data = _windows(rng, 32)
    meta = np.tile([1, 1, 1, 1], (32, 1)).astype(np.int64)
    fids = np.tile(np.arange(1, 7), (32, 1)).astype(np.int32)
    cfg = jconfig.Config(
        model=jconfig.ModelConfig(channels=(8, 4), h_dim=8, latent_dim=4,
                                  encoder_type=encoder_type),
        data=jconfig.DataConfig(seg_len=6, n_joints_override=17, batch_size=16,
                                num_transform=1),
        opt=jconfig.OptConfig(lr=1e-3, epochs=1),
    )
    jtrainer = JaxTrainer(cfg, JaxSegmentDataset(data, meta, fids, num_transform=1),
                          mesh=create_mesh(1, 1, devices=jax.devices()[:1]))
    jstate, _ = jtrainer.fit(epochs=1)
    path = str(tmp_path / "jax.ckpt")
    jcheckpoint.save(path, jstate, cfg)
    trainer = Trainer(port_config(cfg), SegmentDataset(data, meta, fids, num_transform=1),
                      device="cpu")
    state, _, _ = checkpoint.restore(path, trainer)
    names = checkpoint.ravel_order(to_jax_variables(trainer.model)[0])
    first = next(i for i, n in enumerate(names) if n.startswith(("encoder.edge", "encoder.adj")))
    assert first < names.index(next(n for n in names if n.startswith("encoder.layer_0")))
    want = jax_moments(jstate.opt_state, jstate.params)
    got = moments_by_name(trainer)
    assert sorted(got) == sorted(want)
    for k, (mu, nu) in want.items():
        np.testing.assert_array_equal(got[k][0], mu, err_msg=k)
        np.testing.assert_array_equal(got[k][1], nu, err_msg=k)
    js, _ = jtrainer.score_all(jstate, jtrainer.train_ds, jtrainer.train_data)
    s, _ = trainer.score_all(state, trainer.train_ds, trainer.train_data)
    np.testing.assert_allclose(s, js, rtol=1e-3, atol=1e-6)

    back = str(tmp_path / "port.ckpt")
    checkpoint.save(back, trainer, state, trainer.cfg)
    template = jtrainer.init_state()
    restored, _, _ = jcheckpoint.restore(back, template)
    port_params = flatten_tree(to_jax_variables(trainer.model)[0])
    assert all(np.array_equal(v, port_params[k])
               for k, v in flatten_tree(jax.device_get(restored.params)).items())
    again = jax_moments(restored.opt_state, restored.params)
    for k, (mu, nu) in got.items():
        np.testing.assert_array_equal(again[k][0], mu, err_msg=k)
        np.testing.assert_array_equal(again[k][1], nu, err_msg=k)


def test_jax_st_gcn_checkpoint_through_the_port_cli_eval(tmp_path):
    """JAX cli.train on an st_gcn config over the synthetic 17-keypoint
    tree, then the port's cli.eval --device cpu on its checkpoint against
    JAX's cli.eval."""
    from coskad_tpu.cli import eval as jeval_cli
    from coskad_tpu.cli import train as jtrain_cli
    from fixtures import make_synthetic_dataset

    cfg_path = make_synthetic_dataset(str(tmp_path), n_train_clips=1, n_test_clips=1,
                                      n_frames=120)
    with open(cfg_path) as f:
        raw = yaml.safe_load(f)
    raw.update(channels=[8, 4], h_dim=8, latent_dim=4, dataset_batch_size=64,
               encoder_type="st_gcn", dataset_kp18_format=False)
    with open(cfg_path, "w") as f:
        yaml.safe_dump(raw, f)
    jtrain_cli.main(["--config", cfg_path, "--epochs", "1"])
    want = jeval_cli.main(["--config", cfg_path])
    got = eval_cli.main(["--config", cfg_path, "--device", "cpu"])
    cfg = load_config(cfg_path)
    assert cfg.model.encoder_type == "st_gcn" and cfg.data.n_joints == 17
    assert abs(got.result.auc - want.auc) <= 1e-4
    np.testing.assert_allclose(got.result.per_transform_auc, want.per_transform_auc, atol=1e-4)
