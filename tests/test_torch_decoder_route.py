"""The decoder variants' eval decode on K1 (`STSAE.decode`), on the CPU.

On the card the decoder's STS-GCN stack runs K1 in the form of the compute
dtype, on weights folded by prefix (`fold_stse_params(prefix="decoder.")`)
and fed the reverse projector's channel-major hidden state
(`ReverseProjector.channel_major`). Here, where no kernel runs:

  * the fold by prefix through the kernel's plain versions against the
    module decoder: float32 in the band of tests/test_torch_stse_fused.py
    (rtol 2e-4, atol 2e-5: the fold's reassociation), bf16 to the bit (both
    round at the same points and sum in the same order on the CPU);
  * the channel-major hidden state: the module path's, transposed;
  * the decoder's fold cache: rebuilt on an in-place `decoder.*` update,
    kept on an encoder, head or reverse projector update;
  * the whole route, for a latent that claims to be on the card (a tensor
    subclass whose `is_cuda` is True) with a planner that takes every
    layout: the custom op's CPU implementation (the plain version on the
    packed operand) runs where the kernel would, and a call that autograd
    would record raises; `decoder_launches` adds what `launches` adds:
    nothing for the CPU implementation, one for a launch (emulated here by
    an implementation that counts one); where the planner refuses, the
    modules run and nothing is counted;
  * the Trainer's scoring pass: each batch's decode under its own span,
    `eval.decode`, inside the forward's, and the MSE the model's forward
    gives.
"""

import math

import numpy as np
import pytest
import torch

from coskad_tpu_torch import config as tconfig
from coskad_tpu_torch.data.windows import SegmentDataset
from coskad_tpu_torch.kernels import stse_fused
from coskad_tpu_torch.models import STSAE
from coskad_tpu_torch.models.stse import STSVAE
from coskad_tpu_torch.train.loop import Trainer
from coskad_tpu_torch.utils import profiling

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-5)
SHAPE = dict(input_dim=2, layer_channels=(8, 4, 8), hidden_dimension=16, latent_dim=4,
             n_frames=6, n_joints=5, projector="mlp")


class _Planner:
    """Stands in for K1's library: both forms' planners answer `answer`."""

    def __init__(self, answer=0):
        self.answer = answer

    def stse_fused_plan(self, *args):
        return self.answer

    stse_fused_bf16_plan = stse_fused_plan


class _OnCard(torch.Tensor):
    """A CPU tensor that the eval route reads as one on the card."""

    @property
    def is_cuda(self):
        return True


def _launching(plain):
    """The op's CPU implementation counted as a launch, as `_launch` counts
    the kernel's."""

    def run(*args):
        stse_fused.launches.value += 1
        return plain(*args)

    return run


def _model(dtype=torch.float32, cls=STSAE, seed=0):
    gen = torch.Generator().manual_seed(seed)
    model = cls(**SHAPE, dtype=dtype)
    model.reset_parameters(gen)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            lo, hi = (-0.5, 0.5) if name.endswith(".mean") else (0.5, 2.0)
            buf.copy_(torch.empty(buf.shape).uniform_(lo, hi, generator=gen))
    return model.eval()


def _z(n=3, seed=1):
    return torch.randn(n, SHAPE["latent_dim"], generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decoder_fold_by_prefix_matches_the_module_decoder(dtype):
    model = _model(dtype)
    folded, packed = model.decoder_folded()
    state = {k: v.detach() for k, v in model.state_dict().items()}
    again = stse_fused.fold_stse_params(state, dtype, "decoder.")
    assert folded.dtype == packed.dtype == dtype and folded.w_proj is None
    assert len(folded.layers) == len(again.layers) == 4
    for got, want in zip(folded.layers, again.layers):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert [tuple(int(c) for c in row[:3]) for row in packed.layout] == [
        (16, 8, 0), (8, 4, 0), (4, 8, 0), (8, 2, 0)]
    z = _z()
    with torch.no_grad():
        x = model.rev_btlnk.channel_major(z)
        want = model.decoder(model.rev_btlnk(z)).reshape(3, 30, 2)
        if dtype == torch.float32:
            torch.testing.assert_close(stse_fused.fused_stse_hidden_reference(x, folded), want,
                                       **TOL)
        else:
            assert torch.equal(stse_fused.fused_stse_hidden_bf16_reference(x, folded), want)
        assert torch.equal(stse_fused.fused_stse_hidden(x, folded, packed),
                           packed.op(x, *packed.op_args))


def test_the_encoder_fold_is_unchanged_by_the_prefix():
    model = _model()
    state = {k: v.detach() for k, v in model.state_dict().items()}
    assert stse_fused.fold_stse_params(state).layers[0].w.shape == (2, 8)
    with pytest.raises(ValueError, match="no decoder.layer_0"):
        stse_fused.fold_stse_params({k: v for k, v in state.items()
                                     if not k.startswith("decoder.")}, prefix="decoder.")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_channel_major_is_the_reverse_projectors_hidden_transposed(dtype):
    model = _model(dtype)
    with torch.no_grad():
        cm = model.rev_btlnk.channel_major(_z())
        tvh = model.rev_btlnk(_z())
    assert cm.shape == (3, 16, 6, 5) and cm.is_contiguous()
    torch.testing.assert_close(cm.permute(0, 2, 3, 1), tvh, rtol=0, atol=0)


def test_decoder_fold_cache_rebuilds_only_on_a_decoder_update():
    model = _model()
    _, packed = model.decoder_folded()
    _, enc_packed = model.folded()
    with torch.no_grad():
        model.encoder.layer_1.tcn_bn.var.mul_(2.0)
        model.btlnk.hidden_0.kernel.add_(0.1)
        model.rev_btlnk.kernel.add_(0.1)
    assert model.decoder_folded()[1] is packed
    assert model.folded()[1] is not enc_packed
    enc_packed = model.folded()[1]
    with torch.no_grad():
        model.decoder.layer_2.tcn_bn.var.mul_(2.0)
    rebuilt = model.decoder_folded()[1]
    assert rebuilt is not packed and not torch.equal(rebuilt.weights, packed.weights)
    assert model.folded()[1] is enc_packed
    model.load_state_dict(model.state_dict())  # copies in place: a new version
    assert model.decoder_folded()[1] is not rebuilt


@pytest.mark.parametrize("cls", [STSAE, STSVAE])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_decode_route_on_the_card(monkeypatch, cls, dtype):
    monkeypatch.setattr(stse_fused, "_library", lambda: _Planner(0))
    model = _model(dtype, cls)
    assert model.decoder_kernel_takes()
    z = _z()
    with torch.no_grad():
        want = model.decoder(model.rev_btlnk(z)).permute(0, 3, 1, 2)
        before = stse_fused.launches.value, stse_fused.decoder_launches.value
        got = model.decode(z.as_subclass(_OnCard)).as_subclass(torch.Tensor)
        assert (stse_fused.launches.value, stse_fused.decoder_launches.value) == before
        for name in ("fused_stse_hidden_reference", "fused_stse_hidden_bf16_reference"):
            monkeypatch.setattr(stse_fused, name, _launching(getattr(stse_fused, name)))
        again = model.decode(z.as_subclass(_OnCard)).as_subclass(torch.Tensor)
    assert stse_fused.launches.value - before[0] == 1
    assert stse_fused.decoder_launches.value - before[1] == 1
    assert torch.equal(again, got)
    assert got.shape == want.shape == (3, 2, 6, 5)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL)
    else:
        assert torch.equal(got, want)
    with pytest.raises(RuntimeError, match="no_grad"):
        model.decode(z.as_subclass(_OnCard))  # the parameters require grad
    model.requires_grad_(False)
    with pytest.raises(RuntimeError, match="no_grad"):
        model.decode(z.clone().requires_grad_(True).as_subclass(_OnCard))


def test_the_decode_route_takes_the_modules_where_the_planner_refuses(monkeypatch):
    monkeypatch.setattr(stse_fused, "_library", lambda: _Planner(1))
    model = _model()
    assert not model.decoder_kernel_takes()
    z = _z()
    before = stse_fused.decoder_launches.value
    got = model.decode(z.as_subclass(_OnCard)).as_subclass(torch.Tensor)
    assert stse_fused.decoder_launches.value == before
    torch.testing.assert_close(got, model.decode(z), rtol=0, atol=0)
    got.sum().backward()  # the module route stays differentiable
    assert model.decoder.layer_0.tcn_dense.kernel.grad is not None


def _config(variant):
    return tconfig.Config(
        model=tconfig.ModelConfig(variant=variant, num_coords=2, channels=(8, 4, 8), h_dim=16,
                                  latent_dim=4, projector="mlp"),
        data=tconfig.DataConfig(seg_len=6, kp18_format=False, batch_size=16,
                                num_transform=2, n_joints_override=5),
        opt=tconfig.OptConfig(lr=1e-3, epochs=1), eval=tconfig.EvalConfig(),
        run=tconfig.RunConfig(seed=0))


@pytest.mark.parametrize("variant", ["autoencoder", "vae"])
def test_a_scoring_pass_decodes_each_batch_under_its_own_span(variant):
    data = np.random.default_rng(3).uniform(-1, 1, size=(20, 3, 6, 5)).astype(np.float32)
    ds = SegmentDataset(data=data, meta=np.zeros((20, 4), np.int64),
                        frame_ids=np.zeros((20, 6), np.int32), num_transform=2)
    tr = Trainer(_config(variant), ds, device="cpu")
    tr.vae_sample = False
    state = tr.init_state()
    profiling.reset_spans()
    scores, rec = tr.score_all(state, ds, tr.train_data)
    counts = {k: v["count"] for k, v in profiling.span_stats().items()}
    batches = math.ceil(len(ds) / tr.batch_size)
    assert counts["eval.decode"] == counts["eval.forward"] == batches
    forward = profiling.span_stats()["eval.forward"]
    assert forward["self_s"] < forward["total_s"]  # the decode is the forward's child
    idx = torch.remainder(torch.arange(batches * tr.batch_size), len(ds))
    with torch.no_grad():
        batch = tr._gather(tr.train_data, idx)
        out = tr.model(batch) if variant == "autoencoder" else tr.model(batch, sample=False)
        want = torch.mean((out[1] - batch) ** 2, dim=(1, 2, 3))[:len(ds)]
    np.testing.assert_array_equal(rec, want.numpy())
    assert scores.shape == rec.shape == (len(ds),)
    profiling.reset_spans()
