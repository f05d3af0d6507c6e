"""The port's autoencoder (`STSAE`) against the benchmark's plain reference
(`benchmark/reference/stsae.py`), on seeded random weights at a small
size, in eval: the latent, the reconstruction, the distance to a center
and each window's reconstruction MSE.

Bands:
  * float32: rtol 2e-4, atol 2e-5, the autoencoder tests' band:
    the port folds BatchNorm into the dense weights, the reference applies
    it after the product, so the sums are taken in another order;
  * bfloat16: err <= 2^-5 * max(scale, 1) (tests/test_torch_bf16.py's band,
    scale the reference's largest magnitude): the bf16 model rounds its
    activations and products at JAX's points, the reference holds float32
    throughout, and a handful of roundings through eight layers stay
    within a few bf16 ulps of the scale;
  * bfloat16 against the reference at those casts (`precision="bf16"`,
    what the benchmark's `correct` compares with): one bf16 ulp of the
    scale, err <= 2^-8 * max(scale, 1), where a sum taken in another order
    may move a cast to its neighbour, and no further from the port than
    the float32 equations are.

And the reference imports nothing of the program, in a process of its own.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark.reference import stse as ref
from benchmark.reference import stsae
from coskad_tpu_torch.models import STSAE

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=2e-5)
ARCH = dict(in_dim=2, channels=[8, 4, 8], hidden=16, latent=4, frames=6, joints=5,
            projector="mlp")


def _pair(dtype, seed):
    params = stsae.make_params(ARCH, torch.Generator().manual_seed(seed), "cpu", trained=True)
    model = STSAE(input_dim=2, layer_channels=(8, 4, 8), hidden_dimension=16, latent_dim=4,
                  n_frames=6, n_joints=5, projector="mlp", dtype=dtype).eval()
    model.load_state_dict(params, strict=True)
    return params, model


def _band(got, want, dtype, what):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL, msg=what)
    else:
        err = float((got - want).abs().max())
        assert err <= 2.0 ** -5 * max(float(want.abs().max()), 1.0), (what, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seed", [0, 1])
def test_port_agrees_with_the_plain_reference(dtype, seed):
    params, model = _pair(dtype, seed)
    gen = torch.Generator().manual_seed(10 + seed)
    x = torch.rand(9, 2, 6, 5, generator=gen) * 2.0 - 1.0
    center = torch.rand(4, generator=gen) - 0.5
    with torch.no_grad():
        z, rec = model(x)
        z_ref = ref.encode(params, ARCH, x, "eval")
        rec_ref = stsae.decode(params, ARCH, z_ref)
        _band(z, z_ref, dtype, "latent")
        _band(rec, rec_ref, dtype, "reconstruction")
        _band(ref.scores(z, center), ref.scores(z_ref, center), dtype, "distance")
        _band(torch.mean((rec - x) ** 2, dim=(1, 2, 3)),
              torch.mean((rec_ref - x) ** 2, dim=(1, 2, 3)), dtype, "reconstruction MSE")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_at_bf16_the_reference_at_the_models_casts_is_the_port(seed):
    params, model = _pair(torch.bfloat16, seed)
    gen = torch.Generator().manual_seed(10 + seed)
    x = torch.rand(9, 2, 6, 5, generator=gen) * 2.0 - 1.0
    with torch.no_grad():
        z, rec = model(x)
        z_ref = stsae.encode(params, ARCH, x, "bf16")
        rec_ref = stsae.decode(params, ARCH, z_ref, "bf16")
        z_f32 = stsae.encode(params, ARCH, x)
        rec_f32 = stsae.decode(params, ARCH, z_f32)
    for name, got, want, f32 in (("latent", z, z_ref, z_f32),
                                 ("reconstruction", rec, rec_ref, rec_f32)):
        err = float((got - want).abs().max())
        assert err <= 2.0 ** -8 * max(float(want.abs().max()), 1.0), (name, err)
        assert err <= float((got - f32).abs().max()), name


def test_eval_outputs_are_the_reference_blocks_put_together():
    """`eval_outputs` scores the logical indices of a resident set (window
    i % N under transform i // N) in blocks, as the benchmark's cell reads
    them: the same numbers as the batch taken whole."""
    params, _ = _pair(torch.float32, 2)
    gen = torch.Generator().manual_seed(3)
    data = torch.rand(7, 3, 6, 5, generator=gen)
    table = torch.as_tensor(ref.transform_table(2))
    idx = torch.arange(14)
    center = torch.rand(4, generator=gen) - 0.5
    scores, errors = stsae.eval_outputs(params, ARCH, data, idx, table, center, block=5)
    x = ref.gather(data, idx, table, 2)
    with torch.no_grad():
        z = ref.encode(params, ARCH, x, "eval")
        want = torch.mean((stsae.decode(params, ARCH, z) - x) ** 2, dim=(1, 2, 3))
    torch.testing.assert_close(scores, ref.scores(z, center), rtol=1e-6, atol=0)
    torch.testing.assert_close(errors, want, rtol=1e-6, atol=0)
    low, _ = stsae.eval_outputs(params, ARCH, data, idx, table, center, precision="fp8")
    assert not torch.allclose(low, scores, rtol=1e-3, atol=0)
    # the decoder alone one precision down: the same scores, other errors
    bf16 = stsae.eval_outputs(params, ARCH, data, idx, table, center, precision="bf16")
    low = stsae.eval_outputs(params, ARCH, data, idx, table, center, precision="bf16",
                             decoder_precision="fp8")
    assert torch.equal(low[0], bf16[0]) and not torch.allclose(low[1], bf16[1], rtol=1e-3)
    with pytest.raises(ValueError, match="tf32"):
        stsae.decode(params, ARCH, z, "tf32")


def test_the_parameter_names_are_the_ports():
    _, model = _pair(torch.float32, 0)
    spec = {name: shape for name, shape, _ in stsae.param_spec(ARCH)}
    assert spec == {k: tuple(v.shape) for k, v in model.state_dict().items()}


def test_reference_imports_nothing_of_the_program():
    code = ("import json, sys\nimport benchmark.reference.stsae\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "benchmark" in tops
    assert not tops & {"coskad_tpu_torch", "coskad_tpu", "jax", "jaxlib", "flax", "chip_smoke"}
