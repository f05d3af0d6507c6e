"""The eval forward's route (`models.stse.eval_uses_kernel`): on the card it
runs K1, which has no backward, so a call that autograd would record
raises instead of returning a latent cut from the graph; on the CPU the
plain module path stays differentiable, as flax `apply(train=False)` is."""

import numpy as np
import pytest
import torch

from coskad_tpu_torch.models import STSE
from coskad_tpu_torch.models.stse import eval_uses_kernel

torch.set_num_threads(1)


def _model():
    model = STSE(input_dim=2, layer_channels=(4,), hidden_dimension=4, latent_dim=3,
                 n_frames=4, n_joints=5).eval()
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model


def _x(requires_grad=False):
    x = np.random.default_rng(0).normal(size=(4, 2, 4, 5)).astype(np.float32)
    return torch.from_numpy(x).requires_grad_(requires_grad)


@pytest.mark.parametrize("grad_from", ["parameters", "input"])
def test_cuda_route_raises_when_autograd_would_record(grad_from):
    if grad_from == "parameters":
        tensors = [_x(), *_model().parameters()]
    else:
        tensors = [_x(requires_grad=True), torch.zeros(3)]
    with pytest.raises(RuntimeError, match="no_grad"):
        eval_uses_kernel(True, tensors)


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
