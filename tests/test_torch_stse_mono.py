"""K5, the mono backward: `fused_stse_apply(bwd_mode="mono")` and
`mono_backward_reference` against jax.grad of the JAX package's
`fused_stse_apply(..., interpret=True, bwd_mode="mono")`, mono against split
in the port, and what mono keeps alive between forward and backward.

Gradient band as tests/test_fused_train_kernel.py:84-91: err < 1e-3 *
max(scale, 1) + 1e-6 (fp32 reassociation through the BN backward's 1/cnt
cancellations)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coskad_tpu.kernels import stse_train as K
from coskad_tpu_torch.interop import flatten_tree
from coskad_tpu_torch.kernels import stse_train
from coskad_tpu_torch.models import STSE
from test_torch_stse_train import CASES, close_grad, pair

torch.set_num_threads(1)


def _center(case):
    return np.random.default_rng(5).normal(size=(CASES[case]["latent_dim"],)).astype(np.float32)


def _jax_mono_grads(variables, x, ghost, center):
    def loss_j(p):
        z, _ = K.fused_stse_apply(p, variables["batch_stats"], jnp.asarray(x), ghost_size=ghost,
                                  interpret=True, bwd_mode="mono")
        return jnp.mean((z - center) ** 2)

    l_j, g_j = jax.value_and_grad(loss_j)(variables["params"])
    return float(l_j), flatten_tree(g_j)


@pytest.mark.parametrize("case", sorted(CASES))
def test_mono_gradients_match_jax_mono_backward(case):
    """By flax path: the port's mono step, and its plain K5 (operand
    gradients carried into the parameters through `encoder_ops`), against
    jax.grad of the JAX mono backward (Pallas, interpret mode)."""
    _, variables, model, x, ghost = pair(case, seed=2)
    center = _center(case)
    l_j, want = _jax_mono_grads(variables, x, ghost, center)

    xt, c = torch.from_numpy(x), torch.from_numpy(center)
    z = stse_train.fused_stse_apply(model, xt, ghost_size=ghost, bwd_mode="mono")
    loss = torch.mean((z - c) ** 2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), l_j, rtol=1e-5)
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for k in want:
        close_grad(got[k], want[k], k)

    # The plain K5 alone: dz of the same loss, its operand gradients pulled
    # back into the parameters.
    model.zero_grad()
    b, ch, t, v = x.shape
    x_nodes = xt.permute(0, 2, 3, 1).reshape(b, t * v, ch)
    ops = stse_train.encoder_ops(model)
    dz = 2.0 * (z.detach() - c) / z.numel()
    d_ops = stse_train.mono_backward_reference(x_nodes, dz, stse_train.detached(ops), ghost)
    pairs = [(o, g) for o, g in zip(stse_train._flatten(ops), stse_train._flatten(d_ops))
             if o is not None]
    torch.autograd.backward([o for o, _ in pairs], [g for _, g in pairs])
    for k, p in model.named_parameters():
        close_grad(p.grad.numpy(), want[k], k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_mono_matches_split_in_the_port(case):
    """The same step by both backward modes: loss, every gradient and the
    running statistics."""
    _, _, model, x, ghost = pair(case, seed=3)
    twin = STSE(**{k: v for k, v in CASES[case].items() if k not in ("batch", "ghost")})
    twin.load_state_dict(model.state_dict())
    c = torch.from_numpy(_center(case))
    losses = []
    for m, mode in ((model, "mono"), (twin, "split")):
        z = stse_train.fused_stse_apply(m, torch.from_numpy(x), ghost_size=ghost, bwd_mode=mode)
        loss = torch.mean((z - c) ** 2)
        loss.backward()
        losses.append(loss.item())
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)
    for (name, p), q in zip(model.named_parameters(), twin.parameters()):
        close_grad(p.grad.numpy(), q.grad.numpy(), name)
    for (name, a), b in zip(model.named_buffers(), twin.buffers()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def _saved(mode, compute_dtype="float32"):
    """(tensors FusedGhostEncode saves for its backward on the CPU route, x
    as handed over, the operands, after a backward; the number of layers) of
    the narrow model; x bf16 under "bfloat16", as fused_stse_apply hands it."""
    _, _, model, x, ghost = pair("narrow", seed=4)
    b, ch, t, v = x.shape
    x_nodes = torch.from_numpy(x).permute(0, 2, 3, 1).reshape(b, t * v, ch)
    x_nodes = x_nodes.to(stse_train.activation_dtype(compute_dtype)).contiguous()
    ops = stse_train.encoder_ops(model)
    flat = [None if o is None else o.detach().requires_grad_(True)
            for o in stse_train._flatten(ops)]
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        z, *_ = stse_train.FusedGhostEncode.apply(x_nodes, ghost, len(ops.layers), mode,
                                                  compute_dtype, *flat)
    operands = [o for o in flat if o is not None]
    z.sum().backward()
    return saved, x_nodes, operands, len(ops.layers)


@pytest.mark.parametrize("mode,compute_dtype", [("mono", "float32"), ("split", "float32"),
                                                ("split", "bfloat16")])
def test_saved_for_backward(mode, compute_dtype):
    """Mono keeps only x and the operands alive for its backward; split
    keeps every layer's activations and block statistics too. Under
    "bfloat16" split saves x and the activations as bf16 tensors, at half
    the float32 case's bytes, and the rest as in float32."""
    saved, x_nodes, operands, n_layers = _saved(mode, compute_dtype)
    expect = [x_nodes, *operands]
    if mode == "mono":
        assert len(saved) == len(expect)
        for s, e in zip(saved, expect):
            assert s.data_ptr() == e.data_ptr() and s.shape == e.shape
    else:  # + each layer's activations and block statistics
        assert len(saved) == len(expect) + 2 * n_layers
        acts = saved[1:1 + n_layers]
        assert saved[0].data_ptr() == x_nodes.data_ptr()
        assert all(a.dtype == stse_train.activation_dtype(compute_dtype) for a in acts)
        if compute_dtype == "bfloat16":
            f32 = _saved(mode)[0]
            nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
            assert 2 * nbytes(saved[:1 + n_layers]) == nbytes(f32[:1 + n_layers])
            assert nbytes(saved[1 + n_layers:]) == nbytes(f32[1 + n_layers:])
    assert all(o.grad is not None for o in operands)


@pytest.mark.parametrize("in_flight", [1, 2])
@pytest.mark.parametrize("compute_dtype", stse_train.COMPUTE_DTYPES)
def test_mono_chunk_and_workspace(compute_dtype, in_flight):
    """K5's chunk at the flagship width, B=2048, ghost 64: the largest
    whole-block chunk whose footprint (`in_flight` chunk workspaces and the
    whole-batch buffers) stays at or under what K2's forward allocates in
    the same form (the next larger does not) sets the chunk count; the
    chunk is the least with that count. An explicit chunk
    is cut to whole blocks, at least one block, at most the batch; a batch
    of one block takes that block. Under "bfloat16" the per-window scratch
    (t, r, dpre, g, dg), each layer's activation and dy are bf16: half
    their bytes; the moments, statistics, constants and the products'
    partials stay float32."""
    model = STSE(input_dim=2, layer_channels=(32, 16, 32), hidden_dimension=64, latent_dim=16,
                 n_frames=12, n_joints=18)
    ops = stse_train.encoder_ops(model)
    fwd = stse_train.forward_buffers(ops, 2048, 64, compute_dtype)
    budget = stse_train.buffer_bytes(fwd)
    small = stse_train.scratch_dtype(compute_dtype).itemsize
    # K2: z, t / r over the widest layer, moments, block sums, the projector's
    # 33 split partials, each layer's activation, statistics and sums; M^T in
    # bf16 under "bfloat16"
    rows = 2048 * 216
    assert budget == (4 * 2048 * 16 + small * rows * (2 * 64 + 144) + 4 * 2048 * 4 * 64
                      + 4 * 32 * 4 * 64 + 4 * 33 * 2048 * 16 + 4 * (32 * 4 + 4) * 144
                      + (2 * 2 * 216 * 216 if compute_dtype == "bfloat16" else 0))
    # the largest whole-block chunk under the budget sets the chunk count;
    # the chunk is the least whole-block chunk with that count
    foot = lambda c: stse_train.mono_footprint(ops, 2048, c, 64, compute_dtype, in_flight)
    largest = max(c for c in range(64, 2048 + 1, 64) if foot(c) <= budget)
    assert 64 <= largest < 2048 and foot(largest + 64) > budget
    chunk = stse_train.mono_chunk(ops, 2048, 64, compute_dtype, in_flight=in_flight)
    n_chunks = -(-2048 // largest)
    assert chunk % 64 == 0 and chunk <= largest and foot(chunk) <= budget
    assert -(-2048 // chunk) == n_chunks and -(-2048 // (chunk - 64)) > n_chunks
    assert chunk == (512 if in_flight == 2 else 1024)  # 4 and 2 chunks, none short
    # the footprint's parts: the slots and what launch_mono_backward allocates
    ws = stse_train.mono_workspace(ops, 216, chunk, 64, compute_dtype)
    slot = sum(-(-v // 256) * 256 for v in ws.values() if v is not None)
    whole = stse_train.buffer_bytes(stse_train.mono_batch_buffers(ops, 2048, chunk, 64,
                                                                  compute_dtype))
    assert stse_train.mono_footprint(ops, 2048, chunk, 64, compute_dtype, in_flight) == (
        min(in_flight, -(-2048 // chunk)) * slot + whole)
    for kw, want in ((dict(chunk_windows=100), 64), (dict(chunk_windows=10), 64),
                     (dict(chunk_windows=4096), 2048), (dict(chunk_windows=320), 320)):
        assert stse_train.mono_chunk(ops, 2048, 64, compute_dtype, **kw) == want, kw
    assert stse_train.mono_chunk(ops, 96, 32, compute_dtype, chunk_windows=128) == 96
    assert stse_train.mono_chunk(ops, 64, 64, compute_dtype, in_flight=in_flight) == 64
    # one chunk workspace at 128 windows, by buffer
    ws = stse_train.mono_workspace(ops, 216, 128, 64, compute_dtype)
    for k in ("t_buf", "r_buf", "dpre_buf", "act3"):
        assert ws[k] == small * 128 * 216 * 64, k
    for k in ("g_buf", "dg_buf", "dy_buf", "act0", "act2"):
        assert ws[k] == small * 128 * 216 * 32, k
    assert ws["act1"] == small * 128 * 216 * 16
    assert ws["part"] == 4 * 128 * 4 * 64 and ws["stats3"] == 4 * 2 * 4 * 64
    assert sum(v for v in ws.values() if v is not None) == (
        small * 128 * 216 * (3 * 64 + 2 * 32 + 32 + 144) + 4 * 34048 + 4 * 1152
        + ws["prod_buf"])
    assert ws["prod_buf"] == 4 * max(s * size for s, size in (
        (stse_train.product_splits("rows", 216 * 64, 16, 128), 216 * 64 * 16),
        *((stse_train.product_splits("windows", 216, 216, 128, ci), 216 * 216)
          for ci in (2, 32, 16, 32)),
        *((stse_train.product_splits("rows", ci, co, 128 * 216), ci * co)
          for ci, co in ((2, 32), (32, 16), (16, 32), (32, 64)))))
