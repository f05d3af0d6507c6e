"""compute_dtype="bfloat16": the port's module path, its plain K2-K5 bf16
forms and its Trainer against the JAX package at bf16, on the same weights
(carried across by `interop`) and the same seeded inputs.

XLA on the CPU has no kernel for a bf16 x bf16 -> f32 dot, so the JAX side
runs under `cpu_bf16_dots`: in this test process alone, a CPU lowering of
`dot_general` that widens bf16 operands to f32, takes the f32 dot and
converts the result to the dot's own output type. That is the dot's exact
function (bf16 products are exact in f32, which sums them), the "+widen"
of the JAX kernels' interpret mode (coskad_tpu/kernels/stse_train.py:266);
nothing in the JAX package changes. The JAX kernels run in interpret mode.

Bands, each justified by bf16 rounding (2^-8 relative at a rounding point)
and none looser than the JAX package's own 5e-2 * max(scale, 1)
(tests/test_fused_train_kernel.py:201-210):
  * forwards, latents, running statistics, losses and centers:
    err <= 2^-5 * max(scale, 1). The two packages round at the same points
    but sum in other orders (and jit keeps some of JAX's intermediates
    unrounded), so a value can land on the other side of a bf16 rounding
    boundary: one such flip is 1 ulp, <= 2^-7 of the value, and a few of
    them through the layers stay within 4 ulps;
  * gradients: the cosine of each leaf against JAX's above 0.98 (the JAX
    package's own bf16 gradient check, :226-233), except the biases of the
    dense layers under live or ghost BatchNorm: their gradient is zero
    analytically (BatchNorm takes out any shift of its input), so both
    packages give rounding noise, held to err <= 2^-5 of the largest
    gradient of the model.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coskad_tpu import config as jconfig
from coskad_tpu.data.windows import SegmentDataset as JaxSegmentDataset
from coskad_tpu.geometry import poincare as jpoincare
from coskad_tpu.kernels import stse_train as K
from coskad_tpu.models import STSE as JaxSTSE
from coskad_tpu.parallel import create_mesh
from coskad_tpu.train.loop import Trainer as JaxTrainer
from coskad_tpu.utils.logging import MetricLogger as JaxLogger
from coskad_tpu_torch.data.windows import SegmentDataset
from coskad_tpu_torch.geometry import poincare
from coskad_tpu_torch.interop import flatten_tree, load_jax_variables, to_jax_variables
from coskad_tpu_torch.kernels import stse_fused, stse_train
from coskad_tpu_torch.models import STSE
from coskad_tpu_torch.models.stse import eval_uses_kernel
from coskad_tpu_torch.models.stsgcn import rounded
from coskad_tpu_torch.train.loop import Trainer
from coskad_tpu_torch.utils.logging import MetricLogger
from test_torch_stse_train import CASES, jax_variables
from test_torch_train import _capturing, port_config

torch.set_num_threads(1)

BAND = 2.0 ** -5
COSINE = 0.98
# the paper's layer schedule at a narrow width, 17 joints
NARROW = dict(input_dim=2, layer_channels=(8, 4, 8), hidden_dimension=8, latent_dim=4,
              n_frames=6, n_joints=17)


@contextlib.contextmanager
def cpu_bf16_dots():
    """A CPU lowering of `dot_general` for bf16 operands: widened to f32,
    the f32 dot, then the dot's output type (see the module docstring);
    the previous lowering comes back on exit."""
    from jax._src import core
    from jax._src.interpreters import mlir
    from jax._src.lax import lax as lax_internal

    prim = lax_internal.dot_general_p
    table = mlir._platform_specific_lowerings["cpu"]
    before = table[prim]

    def f32(aval):
        return core.ShapedArray(aval.shape, np.dtype(np.float32))

    def lower(ctx, lhs, rhs, **params):
        avals = ctx.avals_in
        if all(a.dtype != jnp.bfloat16 for a in avals):
            return before.rule(ctx, lhs, rhs, **params)
        out_aval, = ctx.avals_out
        lhs = mlir.convert_hlo(ctx, lhs, avals[0], f32(avals[0]))
        rhs = mlir.convert_hlo(ctx, rhs, avals[1], f32(avals[1]))
        wide = ctx.replace(avals_in=[f32(a) for a in avals], avals_out=[f32(out_aval)])
        out, = before.rule(wide, lhs, rhs, **dict(params, preferred_element_type=np.float32))
        if out_aval.dtype != np.float32:
            out = mlir.convert_hlo(ctx, out, f32(out_aval), out_aval)
        return [out]

    mlir.register_lowering(prim, lower, platform="cpu")
    try:
        yield
    finally:
        table[prim] = before


@pytest.fixture(scope="module", autouse=True)
def bf16_dots():
    with cpu_bf16_dots():
        yield


def assert_band(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert np.all(np.isfinite(got)) and err <= BAND * max(scale, 1.0), (name, err, scale)


def assert_cosine(got, want, name):
    a, b = np.asarray(want, np.float64).ravel(), np.asarray(got, np.float64).ravel()
    assert np.all(np.isfinite(b)), name
    denom = np.linalg.norm(a) * np.linalg.norm(b)
    if denom > 1e-10:
        assert float(a @ b / denom) > COSINE, (name, float(a @ b / denom))


def assert_gradients(got, want):
    """got, want: {name: gradient}; cosine per leaf (see the docstring)."""
    top = max(float(np.abs(g).max()) for g in want.values())
    for k, g in got.items():
        if k.startswith("encoder.") and k.endswith("_dense.bias"):
            assert float(np.abs(g).max()) <= BAND * top, (k, float(np.abs(g).max()), top)
        else:
            assert_cosine(g, want[k], k)


def stse_pair(projector, seed=0, batch=16):
    from test_torch_mlp_head import jittered

    jmodel = JaxSTSE(projector=projector, dtype=jnp.bfloat16, **NARROW)
    x = np.random.default_rng(seed + 11).normal(
        size=(batch, NARROW["input_dim"], NARROW["n_frames"], NARROW["n_joints"])
    ).astype(np.float32)
    variables = jittered(jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(x[:2])), seed)
    model = STSE(projector=projector, dtype=torch.bfloat16, **NARROW)
    load_jax_variables(model, variables["params"], variables["batch_stats"])
    return jmodel, variables, model, x


def test_rounded_is_round_to_nearest_even_and_the_identity_at_float32():
    x = torch.tensor([1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8, -(1 + 2.0 ** -8), 1 + 2.0 ** -8 + 2.0 ** -20,
                      3.4e38])
    assert rounded(x, torch.bfloat16).tolist() == [1.0, 1 + 2.0 ** -6, -1.0, 1 + 2.0 ** -7,
                                                   float("inf")]
    y = torch.randn(5)
    assert rounded(y, torch.float32) is y
    assert rounded(y, torch.bfloat16).dtype == torch.float32


@pytest.mark.parametrize("projector", ["linear", "mlp"])
def test_module_forwards_match_flax_at_bf16(projector):
    """Eval (jitted, as the JAX Trainer scores), live-BN train with its
    running statistics, frozen BN, and the train forward's gradients."""
    jmodel, variables, model, x = stse_pair(projector)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    z_j = jax.jit(jmodel.apply)(variables, xj)
    with torch.no_grad():
        z = model(xt)
    assert z.dtype == torch.float32 and z_j.dtype == jnp.float32
    assert_band(z.numpy(), z_j, "eval latent")

    z_j, mutated = jmodel.apply(variables, xj, train=True, mutable=["batch_stats"])
    model.train()
    z = model(xt, train=True)
    assert_band(z.detach().numpy(), z_j, "train latent")
    want = flatten_tree(jax.device_get(mutated["batch_stats"]))
    got = flatten_tree(to_jax_variables(model)[1])
    assert sorted(got) == sorted(want)
    for k in want:
        assert_band(got[k], want[k], k)

    def loss_j(p):
        out, _ = jmodel.apply({"params": p, "batch_stats": variables["batch_stats"]}, xj,
                              train=True, mutable=["batch_stats"])
        return jnp.mean(out ** 2)

    g_j = flatten_tree(jax.grad(loss_j)(variables["params"]))
    torch.mean(z ** 2).backward()
    assert_gradients({k: p.grad.numpy() for k, p in model.named_parameters()}, g_j)

    load_jax_variables(model, variables["params"], variables["batch_stats"])
    z_j, _ = jmodel.apply(variables, xj, train=True, frozen_bn=True, mutable=["batch_stats"])
    with torch.no_grad():
        z = model(xt, train=True, frozen_bn=True)
    assert_band(z.numpy(), z_j, "frozen-BN latent")


def test_hyperbolic_latent_matches_flax_at_bf16():
    """The Poincaré geometry reads the float32 latent of the bf16 model."""
    jmodel, variables, model, x = stse_pair("mlp", seed=3)
    z_j = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        z = model(torch.from_numpy(x))
    h_j = jpoincare.project(jpoincare.expmap0(z_j))
    h = poincare.project(poincare.expmap0(z))
    assert_band(h.numpy(), h_j, "ball point")
    assert_band(poincare.dist0(h).numpy(), jpoincare.dist0(h_j), "distance from 0")


def _kernel_pair(case, seed):
    kw = dict(CASES[case])
    batch, ghost = kw.pop("batch"), kw.pop("ghost")
    jmodel = JaxSTSE(projector="linear", bn_mode="flax", **kw)
    x = np.random.default_rng(seed + 7).normal(
        size=(batch, kw["input_dim"], kw["n_frames"], kw["n_joints"])).astype(np.float32)
    variables = jax_variables(jmodel, jnp.asarray(x[:2]), seed)
    model = STSE(**kw)
    load_jax_variables(model, variables["params"], variables["batch_stats"])
    return variables, model, x, ghost


@pytest.mark.parametrize("compute_dtype,bwd_mode", [
    ("bfloat16", "split"), ("bfloat16_f32store", "split"), ("bfloat16", "mono"),
    ("bfloat16_f32store", "mono")])
def test_plain_kernel_forms_match_pallas_interpret(compute_dtype, bwd_mode):
    """K2 and the split backward (K4, K3) or K5 in their plain bf16 forms,
    through fused_stse_apply, against the JAX kernels in interpret mode at
    the same compute_dtype: z, the running statistics the sums update, and
    every parameter's gradient (K5: the mono backward on both sides)."""
    variables, model, x, ghost = _kernel_pair("narrow", seed=2)
    params, bs = variables["params"], variables["batch_stats"]
    center = np.random.default_rng(1).normal(size=4).astype(np.float32)

    def loss_j(p):
        z, new = K.fused_stse_apply(p, bs, jnp.asarray(x), ghost_size=ghost, interpret=True,
                                    compute_dtype=compute_dtype, bwd_mode=bwd_mode)
        return jnp.mean((z - center) ** 2), (z, new)

    (_, (z_j, new_j)), g_j = jax.value_and_grad(loss_j, has_aux=True)(params)
    z = stse_train.fused_stse_apply(model, torch.from_numpy(x), ghost_size=ghost,
                                    compute_dtype=compute_dtype, bwd_mode=bwd_mode)
    assert_band(z.detach().numpy(), z_j, "z")
    want = flatten_tree(jax.device_get(new_j))
    got = flatten_tree(to_jax_variables(model)[1])
    for k in want:
        assert_band(got[k], want[k], k)
    torch.mean((z - torch.from_numpy(center)) ** 2).backward()
    assert_gradients({k: p.grad.numpy() for k, p in model.named_parameters()},
                     flatten_tree(jax.device_get(g_j)))


@pytest.mark.parametrize("fused_train", ["off", "on"])
def test_lockstep_fit_at_bf16_matches_jax_trainer(fused_train):
    """Two epochs of Trainer.fit at compute_dtype bfloat16 on both sides
    (euclidean_dynamic, 4 steps an epoch, ghost 8 when fused): per-step
    losses and the center after each epoch. Fused, the JAX Trainer on the
    CPU runs its float32 jnp spec (impl="reference") and the port its plain
    bf16 forms: the band covers bf16 rounding either way."""
    rng = np.random.default_rng(0)
    n_win = 64
    data = rng.normal(size=(n_win, 3, 6, 5)).astype(np.float32)
    meta = np.tile([1, 1, 1, 1], (n_win, 1)).astype(np.int64)
    fids = np.tile(np.arange(1, 7), (n_win, 1)).astype(np.int32)
    cfg = jconfig.Config(
        model=jconfig.ModelConfig(variant="euclidean_dynamic", channels=(8, 4), h_dim=8,
                                  latent_dim=4),
        data=jconfig.DataConfig(seg_len=6, n_joints_override=5, batch_size=32,
                                num_transform=2),
        opt=jconfig.OptConfig(lr=1e-3, epochs=2),
        run=jconfig.RunConfig(fused_train=fused_train, ghost_size=8, compute_dtype="bfloat16"),
    )
    jlog = _capturing(JaxLogger)
    jtrainer = JaxTrainer(cfg, JaxSegmentDataset(data, meta, fids, num_transform=2),
                          mesh=create_mesh(1, 1, devices=jax.devices()[:1]), logger=jlog)
    jstate = jtrainer.initialize_center(jtrainer.init_state())
    log = _capturing(MetricLogger)
    trainer = Trainer(port_config(cfg), SegmentDataset(data, meta, fids, num_transform=2),
                      device="cpu", logger=log)
    assert trainer.model.dtype == torch.bfloat16
    assert trainer._fused_compat == (fused_train == "on")
    load_jax_variables(trainer.model, jax.device_get(jstate.params),
                       jax.device_get(jstate.batch_stats))
    state = trainer.init_state().replace(center=torch.from_numpy(np.array(jstate.center)))
    for epoch in range(2):
        jstate, _ = jtrainer.fit(jstate, epochs=1)
        state, _ = trainer.fit(state, epochs=1)
        assert_band(state.center.numpy(), jstate.center, f"center after epoch {epoch}")
    assert len(log.losses) == len(jlog.losses) == 8
    for step, (a, b) in enumerate(zip(log.losses, jlog.losses)):
        assert_band(a, b, f"loss of step {step}")


class _Planner:
    """Stands in for K1's library: answers its planner and counts asks."""

    def __init__(self, takes: bool):
        self.takes, self.asked = takes, 0

    def stse_fused_plan(self, *args):
        self.asked += 1
        return 0 if self.takes else 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eval_route_by_compute_dtype(monkeypatch, dtype):
    """At float32 the card's eval route asks K1's planner (once); at bf16 it
    takes the module path without asking, as JAX's bf16 eval is XLA over its
    modules and K1 is float32 only. The module route never raises under
    grad mode."""
    planner = _Planner(takes=True)
    monkeypatch.setattr(stse_fused, "_library", lambda: planner)
    model = STSE(dtype=dtype, **NARROW).eval()
    x = torch.zeros(2, 2, 6, 17, requires_grad=True)
    takes = model.kernel_takes()
    assert takes == (dtype == torch.float32)
    assert model.kernel_takes() == takes and planner.asked == int(takes)
    with torch.no_grad():
        assert eval_uses_kernel(takes, [x, *model.parameters()]) == takes
    assert not eval_uses_kernel(False, [x, *model.parameters()])


def test_config_at_bf16_builds_trains_and_scores():
    """A Config with compute_dtype bfloat16 builds a bf16 model, trains
    (module path and fused) and scores on the CPU: finite float32 losses,
    latents and scores."""
    rng = np.random.default_rng(2)
    ds = SegmentDataset(rng.normal(size=(32, 3, 6, 5)).astype(np.float32),
                        np.ones((32, 4), np.int64), np.tile(np.arange(1, 7), (32, 1)),
                        num_transform=2)
    cfg = jconfig.Config(
        model=jconfig.ModelConfig(variant="euclidean_static", channels=(4,), h_dim=4,
                                  latent_dim=2),
        data=jconfig.DataConfig(seg_len=6, n_joints_override=5, batch_size=16, num_transform=2),
        opt=jconfig.OptConfig(epochs=1),
        run=jconfig.RunConfig(compute_dtype="bfloat16", ghost_size=8))
    for fused in ("off", "on"):
        pcfg = port_config(dataclasses.replace(cfg, run=dataclasses.replace(cfg.run,
                                                                           fused_train=fused)))
        trainer = Trainer(pcfg, ds, device="cpu", logger=MetricLogger(every_n_steps=10 ** 9))
        assert trainer.model.dtype == torch.bfloat16
        state, hist = trainer.fit(epochs=1)
        scores, _ = trainer.score_all(state, ds, trainer.train_data)
        z = trainer.embed_all(state, ds, trainer.train_data)
        assert np.isfinite(hist["loss"]).all() and np.isfinite(scores).all()
        assert z.dtype == np.float32 and scores.shape == (len(ds),)
