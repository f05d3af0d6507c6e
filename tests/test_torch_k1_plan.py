"""K1's launch plan (`models/stse.py::_Plan`), on the CPU.

Each stack K1 runs (the encoder's, and the autoencoder's decoder's) keeps a
plan on its model: the stack folded and packed, the op and its arguments,
and where each tensor the fold read lives. A hit compares each of those
tensors' storage and in-place version with the plan's; it walks no
`state_dict` and lists no parameter, and under `no_grad` or
`inference_mode` the route check reads none either. Here the route runs
for an input that claims to be on the card (a tensor subclass whose
`is_cuda` is True) with a planner that takes every layout, so the custom
op's CPU implementation runs where the kernel would; that implementation
is counted as a launch. Checked for both stacks at float32 and bf16:

  * a hit calls no `nn.Module.state_dict` and no `nn.Module.parameters`;
  * `stse_fused.plan_hits` equals the launches of a steady pass and
    `plan_builds` stays 0; an optimizer step costs one build a stack;
  * the plan is rebuilt after an in-place update, a parameter, buffer or
    submodule replaced, a parameter's `.data` swapped, `load_state_dict`
    and `.to()`, and kept across an update of what only the other stack's
    fold reads;
  * the rebuilt plan's operand is a fresh fold's, bit for bit, and the
    route's output is the fresh operand's;
  * the plan's slots are the stack's `state_dict` entries, in order.
"""

import pytest
import torch
from torch import nn

from coskad_tpu_torch.kernels import stse_fused
from coskad_tpu_torch.models import STSAE

torch.set_num_threads(1)

SHAPE = dict(input_dim=2, layer_channels=(8, 4, 8), hidden_dimension=16, latent_dim=4,
             n_frames=6, n_joints=5, projector="mlp")
STACKS = ("encoder", "decoder")
DTYPES = (torch.float32, torch.bfloat16)
PREFIX = {"encoder": "encoder.", "decoder": "decoder."}
OTHER = {"encoder": "decoder", "decoder": "encoder"}


class _Planner:
    """Stands in for K1's library: both forms' planners take every layout."""

    def stse_fused_plan(self, *args):
        return 0

    stse_fused_bf16_plan = stse_fused_plan


class _OnCard(torch.Tensor):
    """A CPU tensor that the eval route reads as one on the card."""

    @property
    def is_cuda(self):
        return True


def _launching(plain):
    def run(*args):
        stse_fused.launches.value += 1
        return plain(*args)

    return run


@pytest.fixture
def card(monkeypatch):
    """The route as on the card: every layout taken, the op's CPU
    implementation counted as a launch."""
    monkeypatch.setattr(stse_fused, "_library", lambda: _Planner())
    for name in ("fused_stse_hidden_reference", "fused_stse_hidden_bf16_reference"):
        monkeypatch.setattr(stse_fused, name, _launching(getattr(stse_fused, name)))


def _model(dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    model = STSAE(**SHAPE, dtype=dtype)
    model.reset_parameters(gen)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            lo, hi = (-0.5, 0.5) if name.endswith(".mean") else (0.5, 2.0)
            buf.copy_(torch.empty(buf.shape).uniform_(lo, hi, generator=gen))
    return model.eval()


def _input(stack, n=3):
    gen = torch.Generator().manual_seed(1)
    if stack == "encoder":
        return torch.randn(n, 2, 6, 5, generator=gen)
    return torch.randn(n, SHAPE["latent_dim"], generator=gen)


def _route(model, stack, x):
    """The stack's eval route on `x` as on the card: the encoder's hidden
    state, or the decoder's reconstruction."""
    x = x.as_subclass(_OnCard)
    out = model._hidden(x, False, False) if stack == "encoder" else model.decode(x)
    return out.as_subclass(torch.Tensor)


def _plan(model, stack):
    if stack == "encoder":
        return model._plan("_fold_cache", model._encoder_stack, "encoder.")
    return model._plan("_decoder_fold_cache", model._decoder_stack, "decoder.")


def _fresh(model, stack, dtype):
    """The stack folded and packed from its `state_dict`, as every launch
    did before plans."""
    state = {k: v.detach() for k, v in model.state_dict().items()}
    return stse_fused.pack_folded(stse_fused.fold_stse_params(state, dtype, PREFIX[stack]))


def _counts():
    return stse_fused.plan_hits.value, stse_fused.plan_builds.value, stse_fused.launches.value


def _raising(name):
    def refuse(*args, **kwargs):
        raise AssertionError(f"nn.Module.{name} called on a plan hit")

    return refuse


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stack", STACKS)
def test_a_plan_hit_walks_no_state_dict_and_reads_no_parameter(card, monkeypatch, stack, dtype):
    model, x = _model(dtype), _input(stack)
    with torch.no_grad():
        want = _route(model, stack, x)  # builds the plan
    monkeypatch.setattr(nn.Module, "state_dict", _raising("state_dict"))
    monkeypatch.setattr(nn.Module, "parameters", _raising("parameters"))
    monkeypatch.setattr(nn.Module, "named_parameters", _raising("named_parameters"))
    before = _counts()
    for mode in (torch.no_grad, torch.inference_mode):
        with mode():
            assert torch.equal(_route(model, stack, x), want)
    hits, builds, launches = (a - b for a, b in zip(_counts(), before))
    assert (hits, builds, launches) == (2, 0, 2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stack", STACKS)
def test_plan_counters_count_hits_and_builds(card, stack, dtype):
    """A steady pass: a hit a launch, no build. An optimizer step moves
    every parameter, so each stack builds once, then hits again."""
    model, x = _model(dtype), _input(stack)
    with torch.inference_mode():
        model.kernel_takes(), model.decoder_kernel_takes()  # both plans built
        before = _counts()
        for _ in range(5):
            _route(model, stack, x)
    hits, builds, launches = (a - b for a, b in zip(_counts(), before))
    assert (hits, builds, launches) == (5, 0, 5)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    z, rec = model(torch.randn(4, 2, 6, 5), train=True)
    (z.square().mean() + rec.square().mean()).backward()
    opt.step()
    model.eval()
    before = _counts()
    with torch.inference_mode():
        for _ in range(3):
            _route(model, stack, x)
        model.folded(), model.decoder_folded()
    hits, builds, launches = (a - b for a, b in zip(_counts(), before))
    assert (hits, builds, launches) == (2 + 1, 2, 3)


def _in_place(model, stack):
    layer = getattr(model, stack).layer_1
    with torch.no_grad():
        layer.tcn_dense.kernel.add_(0.25)


def _parameter_replaced(model, stack):
    layer = getattr(model, stack).layer_1
    layer.tcn_dense.kernel = nn.Parameter(layer.tcn_dense.kernel.detach() * 1.5)


def _buffer_replaced(model, stack):
    layer = getattr(model, stack).layer_1
    layer.tcn_bn.var = layer.tcn_bn.var * 2.0


def _loaded(model, stack):
    state = model.state_dict()
    state[f"{stack}.layer_1.tcn_dense.kernel"] = state[f"{stack}.layer_1.tcn_dense.kernel"] * 0.5
    model.load_state_dict(state)


def _submodule_replaced(model, stack):
    layer = getattr(model, stack).layer_1
    new = type(layer.prelu)()
    with torch.no_grad():
        for mine, theirs in zip(new.parameters(), layer.prelu.parameters()):
            mine.copy_(theirs * 0.5)
    layer.prelu = new


def _data_swapped(model, stack):
    """New storage under the same parameter, its version unchanged."""
    kernel = getattr(model, stack).layer_1.tcn_dense.kernel
    kernel.data = kernel.detach() * 1.5


def _moved(model, stack):
    """New storage for every tensor; the old storage is returned, held, so
    that the new cannot reuse its addresses."""
    held = list(model.state_dict().values())
    model.to(torch.float64).to(torch.float32)
    return held


CHANGES = {"in_place": _in_place, "parameter_replaced": _parameter_replaced,
           "buffer_replaced": _buffer_replaced, "load_state_dict": _loaded,
           "submodule_replaced": _submodule_replaced, "data_swapped": _data_swapped,
           "to": _moved}


@pytest.mark.parametrize("change", sorted(CHANGES))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stack", STACKS)
def test_the_plan_rebuilds_on_a_change_to_what_its_fold_reads(card, stack, dtype, change):
    """Each change to the stack's tensors or tree rebuilds its plan once;
    the rebuilt operand is a fresh fold's to the bit, and the route gives
    what that operand gives."""
    model, x = _model(dtype), _input(stack)
    with torch.inference_mode():
        _route(model, stack, x)
    old = _plan(model, stack)
    held = CHANGES[change](model, stack)  # noqa: F841 (kept alive)
    before = _counts()
    with torch.inference_mode():
        got = _route(model, stack, x)
    plan = _plan(model, stack)
    assert plan is not old and _counts()[1] - before[1] == 1
    fresh = _fresh(model, stack, dtype)
    assert torch.equal(plan.packed.weights, fresh.weights)
    assert torch.equal(torch.as_tensor(plan.packed.layout), torch.as_tensor(fresh.layout))
    if change not in ("to", "load_state_dict"):  # those two may write the same values back
        assert not torch.equal(plan.packed.weights, old.packed.weights)
    with torch.inference_mode():
        want = (fresh.op(x, *fresh.op_args) if stack == "encoder"
                else model.k1_decode(x, fresh))
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stack", STACKS)
def test_the_plan_is_kept_across_an_update_of_the_other_stack(card, stack, dtype):
    """What only the other stack's fold reads: the decoder or `rev_btlnk`
    for the encoder's plan, the encoder, the head or `rev_btlnk` for the
    decoder's; a plan kept is counted a hit."""
    model, x = _model(dtype), _input(stack)
    with torch.inference_mode():
        _route(model, stack, x)
    plan = _plan(model, stack)
    with torch.no_grad():
        getattr(model, OTHER[stack]).layer_2.tcn_bn.var.mul_(2.0)
        model.rev_btlnk.kernel.add_(0.1)
        if stack == "decoder":
            model.btlnk.hidden_0.kernel.add_(0.1)
    getattr(model, OTHER[stack]).layer_0.tcn_dense.kernel = nn.Parameter(
        getattr(model, OTHER[stack]).layer_0.tcn_dense.kernel.detach().clone())
    before = _counts()
    with torch.inference_mode():
        _route(model, stack, x)
    assert _plan(model, stack) is plan
    assert _counts()[1] == before[1]


@pytest.mark.parametrize("stack", STACKS)
def test_the_plans_slots_are_the_stacks_state_dict(stack):
    model = _model(torch.float32)
    stacked = model._encoder_stack() if stack == "encoder" else model._decoder_stack()
    want = {}
    for prefix, m in stacked:
        want.update(m.state_dict(prefix=prefix, keep_vars=True))
    slots = _plan(model, stack).slots
    assert [name for name, _, _ in slots] == list(want)
    assert all(tensors[k] is want[name] for name, tensors, k in slots)


@pytest.mark.parametrize("stack", STACKS)
def test_under_grad_mode_the_route_still_raises(card, stack):
    """The route check reads the parameters where grad mode is on: a
    parameter that requires grad raises as before; none does not."""
    model, x = _model(torch.float32), _input(stack)
    with pytest.raises(RuntimeError, match="no_grad"):
        _route(model, stack, x)
    model.requires_grad_(False)
    assert _route(model, stack, x).shape[0] == 3
