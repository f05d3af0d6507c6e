"""Train-mode dropout in the port (`models/stsgcn.py::dropout`, in the
STS-GCN layers of the encoder and the decoder, the ST-GCN blocks and the
cnn stack), held to flax's `nn.Dropout` semantics.

JAX and torch draw their masks from different generators, so a fit with
dropout is not held to the JAX Trainer element by element. What is held:
at rate 0 the layers compute what they computed before, bit for bit, and
draw nothing; in eval mode dropout is the identity, so a model with
dropout > 0 matches flax's `apply` (rtol 2e-4, atol 2e-5, fp32
reassociation); in train mode, live BatchNorm or `frozen_bn`, the kept
fraction lies within 4 standard deviations of its binomial mean and each
kept value is exactly x / (1 - rate); one generator seed gives one mask; a
resumed fit equals a straight one bit for bit (the Trainer seeds the
stream from (seed, step, 0x60)); a dropout fit's losses stay finite."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coskad_tpu.models import build_model as jax_build_model
from coskad_tpu_torch import config as tconfig
from coskad_tpu_torch.data.windows import SegmentDataset
from coskad_tpu_torch.interop import flatten_tree, load_jax_variables, to_jax_variables
from coskad_tpu_torch.models import STSE, build_model
from coskad_tpu_torch.models.stsgcn import dropout
from coskad_tpu_torch.train import checkpoint
from coskad_tpu_torch.train.loop import Trainer
from test_torch_encoders import jax_variables

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-5)
KW = dict(input_dim=2, layer_channels=(8, 4), hidden_dimension=8, latent_dim=4, n_frames=6,
          n_joints=17)


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def x_of(batch=6, seed=1, **kw):
    kw = dict(KW, **kw)
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(batch, kw["input_dim"], kw["n_frames"], kw["n_joints"])).astype(np.float32))


def within_4_sigma(kept: int, n: int, keep_prob: float) -> bool:
    return abs(kept - n * keep_prob) <= 4.0 * (n * keep_prob * (1.0 - keep_prob)) ** 0.5


@pytest.mark.parametrize("use_decoder", [False, True])
def test_rate_zero_is_bit_identical_and_draws_nothing(use_decoder):
    """dropout=0: a train forward with a generator is the forward without
    one, bit for bit, and leaves the generator where it was."""
    model = build_model(use_decoder=use_decoder, dropout=0.0, **KW)
    model.reset_parameters(gen(2))
    x = x_of()
    g = gen(9)
    before = g.get_state()
    out = model(x, train=True, dropout_generator=g)
    again = model(x, train=True)
    assert torch.equal(g.get_state(), before)
    for a, b in zip(out if use_decoder else [out], again if use_decoder else [again]):
        assert torch.equal(a, b)
    assert torch.equal(dropout(x, 0.0, True, None), x)


@pytest.mark.parametrize("encoder_type", ["sts_gcn", "st_gcn", "cnn"])
def test_eval_is_deterministic_and_matches_flax(encoder_type):
    jmodel = jax_build_model(encoder_type=encoder_type, dropout=0.3, **KW)
    x = x_of(seed=3).numpy()
    variables = jax_variables(jmodel, x, seed=4)
    model = build_model(encoder_type=encoder_type, dropout=0.3, **KW)
    load_jax_variables(model, variables["params"], variables["batch_stats"])
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        z1, z2 = model(torch.from_numpy(x)), model(torch.from_numpy(x))
    assert torch.equal(z1, z2)
    np.testing.assert_allclose(z1.numpy(), ref, **TOL)


def test_decoder_eval_with_dropout_matches_flax():
    jmodel = jax_build_model(use_decoder=True, dropout=0.3, **KW)
    x = x_of(seed=5).numpy()
    variables = jax_variables(jmodel, x, seed=6)
    model = build_model(use_decoder=True, dropout=0.3, **KW)
    load_jax_variables(model, variables["params"], variables["batch_stats"])
    z_ref, rec_ref = jmodel.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        z, rec = model(torch.from_numpy(x))
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), **TOL)
    np.testing.assert_allclose(rec.numpy(), np.asarray(rec_ref), **TOL)


@pytest.mark.parametrize("frozen_bn", [False, True])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_train_mask_fraction_and_kept_values(rate, frozen_bn):
    """A one-layer cnn encoder (dense, BN, dropout): its hidden state with
    dropout is the same model's without, each element either 0 or exactly
    that value / (1 - rate); the kept share within 4 sigma of 1 - rate."""
    kw = dict(KW, layer_channels=(), hidden_dimension=16)
    model = STSE(encoder_type="cnn", dropout=rate, **kw)
    model.reset_parameters(gen(7))
    plain = STSE(encoder_type="cnn", dropout=0.0, **kw)
    plain.load_state_dict(model.state_dict())
    x = x_of(batch=64, seed=8, **kw)
    _, h = model.encode(x, train=True, frozen_bn=frozen_bn, dropout_generator=gen(1))
    _, want = plain.encode(x, train=True, frozen_bn=frozen_bn)
    keep = h != 0
    kept, n = int(keep.sum()), h.numel()
    assert within_4_sigma(kept, n, 1.0 - rate), (kept, n)
    assert torch.equal(h[keep], want[keep] / np.float32(1.0 - rate))
    assert not want[~keep].eq(0).all()  # the zeros are dropped values, not zeros of h


def test_dropout_function_statistics():
    x = torch.randn(200_000, generator=gen(3))
    for rate in (0.1, 0.25, 0.9):
        y = dropout(x, rate, True, gen(4))
        keep = y != 0
        assert within_4_sigma(int(keep.sum()), x.numel(), 1.0 - rate)
        assert torch.equal(y[keep], x[keep] / np.float32(1.0 - rate))
        assert torch.equal(dropout(x, rate, False, None), x)
    with pytest.raises(ValueError, match="dropout_generator"):
        dropout(x, 0.1, True, None)


@pytest.mark.parametrize("encoder_type", ["sts_gcn", "st_gcn", "cnn"])
def test_one_seed_one_mask(encoder_type):
    model = build_model(use_decoder=encoder_type == "sts_gcn", encoder_type=encoder_type,
                        dropout=0.2, **KW)
    model.reset_parameters(gen(1))
    x = x_of(seed=2)

    def out(seed, frozen_bn=False):
        o = model(x, train=True, frozen_bn=frozen_bn, dropout_generator=gen(seed))
        return torch.cat([t.reshape(-1) for t in (o if isinstance(o, tuple) else (o,))])

    assert torch.equal(out(5), out(5)) and not torch.equal(out(5), out(6))
    assert torch.equal(out(5, True), out(5, True)) and not torch.equal(out(5, True), out(6, True))


def _config(variant, encoder_type="sts_gcn"):
    return tconfig.Config(
        model=tconfig.ModelConfig(variant=variant, channels=(8, 4), h_dim=8, latent_dim=4,
                                  dropout=0.2, encoder_type=encoder_type),
        data=tconfig.DataConfig(seg_len=6, n_joints_override=17, batch_size=16,
                                num_transform=2),
        opt=tconfig.OptConfig(lr=1e-3, epochs=2),
    )


def _dataset(n=48, seed=0):
    data = np.random.default_rng(seed).normal(size=(n, 3, 6, 17)).astype(np.float32)
    return SegmentDataset(data, np.ones((n, 4), np.int64), np.tile(np.arange(1, 7), (n, 1))
                          .astype(np.int32), num_transform=2)


@pytest.mark.parametrize("variant", ["euclidean_dynamic", "vae"])
def test_resumed_fit_equals_straight(variant, tmp_path):
    """Two epochs straight against one, a checkpoint, a fresh Trainer and
    one more: the same losses, weights and center to the bit (the VAE also
    samples, from its own stream)."""
    cfg = _config(variant)
    ds = _dataset()
    straight = Trainer(cfg, ds, device="cpu")
    s_state, s_hist = straight.fit(epochs=2)
    first = Trainer(cfg, ds, device="cpu")
    state, _ = first.fit(epochs=1)
    path = str(tmp_path / "mid.ckpt")
    checkpoint.save(path, first, state, cfg, extra=first.schedule_state())
    resumed = Trainer(cfg, ds, device="cpu")
    state, _, extra = checkpoint.restore(path, resumed)
    resumed.restore_schedule_state(extra)
    state, hist = resumed.fit(state, epochs=1)
    assert hist["loss"] == s_hist["loss"][1:] and np.isfinite(s_hist["loss"]).all()
    want = flatten_tree(to_jax_variables(straight.model)[0])
    got = flatten_tree(to_jax_variables(resumed.model)[0])
    assert all(np.array_equal(got[k], want[k]) for k in want)
    assert torch.equal(state.center, s_state.center)


@pytest.mark.parametrize("encoder_type", ["st_gcn", "cnn"])
def test_dropout_fit_losses_stay_finite(encoder_type):
    cfg = _config("euclidean_dynamic", encoder_type)
    cfg = dataclasses.replace(cfg, opt=dataclasses.replace(cfg.opt, epochs=3))
    trainer = Trainer(cfg, _dataset(seed=1), device="cpu")
    state, hist = trainer.fit()
    assert len(hist["loss"]) == 3 and np.isfinite(hist["loss"]).all()
    assert torch.isfinite(state.center).all()
    # the masks are drawn from (seed, step, 0x60): another step, another mask
    a = trainer._generator(0, 0x60)
    b = trainer._generator(1, 0x60)
    assert not torch.equal(torch.rand(8, generator=a), torch.rand(8, generator=b))
