"""The eval forward's route (`models.stse.eval_uses_kernel`): on the card it
runs K1 (at float32, or its bf16 form at bf16), which has no backward, so a call that autograd would record
raises instead of returning a latent cut from the graph; on the CPU the
plain module path stays differentiable, as flax `apply(train=False)` is."""

import numpy as np
import pytest
import torch

from coskad_tpu_torch.kernels import stse_fused
from coskad_tpu_torch.models import STSE
from coskad_tpu_torch.models.stse import eval_uses_kernel

torch.set_num_threads(1)


def _model(dtype=torch.float32):
    model = STSE(input_dim=2, layer_channels=(4,), hidden_dimension=4, latent_dim=3,
                 n_frames=4, n_joints=5, dtype=dtype).eval()
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model


def _x(requires_grad=False):
    x = np.random.default_rng(0).normal(size=(4, 2, 4, 5)).astype(np.float32)
    return torch.from_numpy(x).requires_grad_(requires_grad)


class _Planner:
    """Stands in for K1's library: both forms' planners take every layout."""

    def stse_fused_plan(self, *args):
        return 0

    stse_fused_bf16_plan = stse_fused_plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grad_from", ["parameters", "input"])
def test_cuda_route_raises_when_autograd_would_record(monkeypatch, grad_from, dtype):
    """At either compute dtype a model K1 takes (its bf16 form at bf16)
    raises on the card's route where autograd would record."""
    monkeypatch.setattr(stse_fused, "_library", lambda: _Planner())
    model = _model(dtype)
    assert model.kernel_takes() and model.folded()[1].dtype == dtype
    if grad_from == "parameters":
        tensors = [_x(), *model.parameters()]
    else:
        tensors = [_x(requires_grad=True), torch.zeros(3)]
    with pytest.raises(RuntimeError, match="no_grad"):
        eval_uses_kernel(model.kernel_takes(), tensors)


def test_cuda_route_passes_under_no_grad():
    model = _model()
    with torch.no_grad():
        assert eval_uses_kernel(True, [_x(requires_grad=True), *model.parameters()])


def test_cuda_route_passes_under_inference_mode():
    model = _model()
    with torch.inference_mode():
        assert eval_uses_kernel(True, [_x(), *model.parameters()])


def test_cuda_route_passes_when_nothing_requires_grad():
    assert eval_uses_kernel(True, [_x(), torch.zeros(3)])


def test_cpu_eval_forward_stays_differentiable():
    model = _model()
    assert not eval_uses_kernel(False, [_x(), *model.parameters()])
    x = _x(requires_grad=True)
    z = model(x)
    torch.sum(z * z).backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    grads = [p.grad for p in model.parameters()]
    assert all(g is not None for g in grads)
    assert any(float(g.abs().max()) > 0 for g in grads)
