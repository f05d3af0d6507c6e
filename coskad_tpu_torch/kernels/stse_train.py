"""Train-mode STSE encoder with ghost BatchNorm: forward, split and mono backward.

Replaces the Pallas kernels of `coskad_tpu/kernels/stse_train.py`:

    K2  `_fwd_kernel` (:432, via `_fwd_pallas` :843)       -> `ghost_forward`
    K3  `_layer_bwd_kernel` (:790, `_layer_bwd_body` :566) -> `layer_backward`
    K4  `_top_layer_bwd_kernel` (:738)                     -> `top_backward`
    K5  `_bwd_kernel` (:498, via `_bwd_pallas` :1008)      -> `mono_backward`

each one C entry point of `csrc/stse_train.cu` (CUDA C++ for sm_90a, built
by `build.py` at first use, bound with ctypes). `product` runs one of their
batch-reduction products (dW, dW_res, dM, dwp) alone, for checks and
timing. `FusedGhostEncode` is the port of the custom VJP
`fused_ghost_encode` (:1061-1107): K2 forward, then K4 for the top layer
and K3 for each layer below; with bwd_mode="mono", K2 forward keeping
only x and the operands, then K5, which recomputes the forward one chunk
of ghost blocks at a time.
`fused_stse_apply` (:1110) is the train-mode encode a Trainer calls; it also
folds the exact full-batch pre-BN sums into the model's running statistics
(`updated_batch_stats`, :1176), in place on the BatchNorm buffers where flax
returns a new tree.

Ghost BatchNorm normalizes each block of `ghost_size` consecutive windows
with the biased statistics of its ghost_size * T * V rows; an identity
residual (C_in == C_out) adds the layer input itself (W_res = I, no BN).
Activations are node-major [B, T*V, C] throughout, like K1's output; the
TPU kernel's [C, B, 256] layout, its (8, C) stat rows and its node padding
were Mosaic workarounds and are not carried over.

Dispatch, as for K1: a CUDA tensor launches the kernels or raises; a CPU
tensor takes the plain PyTorch versions beside them (`ghost_forward_reference`,
and autograd through `ghost_layer_reference` for the backward).

compute_dtype (`COMPUTE_DTYPES`, the JAX kernels' `_parse_dtype` :266 and
`_dop` :288): "float32"; "bfloat16", every dot operand rounded to bf16 (round
to nearest even) and summed in float32, and the values JAX stores at bf16
rounded where they are stored: the layer input as read, g, t, r, the output
y, dy as read, dpre, dg and dx. The tensors the kernels hand each other (the
input windows, every activation, dy and dx) are then `torch.bfloat16`
(`activation_dtype`), as the JAX kernel stores them in its dtype (:420-422,
450), and so is the per-window scratch (K2's t and r; the backward's g, t,
r, dpre, dg and graph operand: `scratch_dtype`); "bfloat16_f32store", bf16
operands and every value stored in float32. Statistics, the
running-statistic sums, z and the weight gradients are float32 under every
form; `fused_stse_apply` rounds the input windows to bf16 under both bf16
forms (JAX casts x_t to the operand dtype, :1152).
The kernels take the form as a template argument (`csrc/stse_train.cu`);
the plain versions round at the same points (`_bf16_einsum` for a product,
both ways; `_stored` for a stored value) and keep their input's dtype: the
wrappers widen a bf16 input for them and hand back bf16 activations and dx
under "bfloat16" on both routes.

What bounds the kernels on an H100: K2-K5 run every product (the
per-window passes', the projector's and the batch reductions') on the
tensor cores, as 3xTF32 under float32 and on the bf16 mma (m16n8k16) under
a bf16 form. That leaves them bound by their scratch traffic (see `work`,
`products` and the source's header).
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel import mesh
from ..utils.profiling import LaunchCounter
from .stse_fused import combined_graph_matrix

SOURCE = "coskad_tpu_torch/kernels/csrc/stse_train.cu"
REPLACES = {
    "stse_train_forward": "coskad_tpu/kernels/stse_train.py:432",
    "stse_train_layer_backward": "coskad_tpu/kernels/stse_train.py:790",
    "stse_train_top_backward": "coskad_tpu/kernels/stse_train.py:738",
    "stse_train_mono_backward": "coskad_tpu/kernels/stse_train.py:498",
    # one batch-reduction product of K3 / K4 / K5 alone, for checks and timing
    # (the dots of `_layer_bwd_body`, e.g. p_t = dpre @ g3^T at :656, and dwp at :768)
    "stse_train_product": "coskad_tpu/kernels/stse_train.py:656",
}
BN_EPS = 1e-5
# K5's schedule (`mono_chunk`): a mono step's peak memory is K2's forward
# (its activations and t/r scratch over the whole batch), so K5 takes as
# few chunks of whole ghost blocks as keep its footprint (`mono_footprint`:
# MONO_IN_FLIGHT chunk workspaces and the whole-batch buffers) at or under
# what K2 allocates at the same batch, width and form (`forward_buffers`),
# made even. Larger chunks give each pass more blocks; with two chunks in
# flight, on the caller's stream and one more, one chunk's small passes
# (statistics, constants, split sums) overlap the other's. On an H100 two in
# flight beat one at every chunk of the sweep in chip_smoke.py (PERF.md).
MONO_IN_FLIGHT = 2
# the compute_dtype forms, in the order of csrc/stse_train.cu's ComputeDtype
COMPUTE_DTYPES = ("float32", "bfloat16", "bfloat16_f32store")

forward_launches = LaunchCounter()  # K2
layer_backward_launches = LaunchCounter()  # K3
top_backward_launches = LaunchCounter()  # K4
mono_backward_launches = LaunchCounter()  # K5
product_launches = LaunchCounter()  # one batch-reduction product alone (`product`)

# Descriptor fields, in the order of the enums in csrc/stse_train.cu.
_FWD_HEADER = ("n_layers", "batch", "n_nodes", "ghost", "latent", "x", "wp", "bp", "z",
               "t_buf", "r_buf", "part", "block_sums", "z_splits", "z_part", "graph", "dtype")
_FWD_LAYER = ("ci", "co", "identity", "m", "w", "b", "gamma", "beta", "w_res", "b_res",
              "gamma_res", "beta_res", "alpha", "act", "stats", "sums")
_BWD = ("batch", "n_nodes", "ghost", "ci", "co", "identity", "latent", "x", "dy", "dz", "wp",
        "y", "m", "w", "b", "gamma", "beta", "w_res", "b_res", "gamma_res", "beta_res",
        "alpha", "stats", "dm", "dw", "db", "dgamma", "dbeta", "dw_res", "db_res",
        "dgamma_res", "dbeta_res", "dalpha", "dx", "dwp", "dbp", "mt", "g_buf", "t_buf",
        "r_buf", "dpre_buf", "dg_buf", "part", "dalpha_part", "consts", "gpart", "prod_buf",
        "splits_w", "splits_w_res", "splits_m", "splits_wp", "dtype")
_PRODUCT = ("form", "p", "q", "n", "k", "a", "b", "splits", "part", "out", "dtype", "a_bf16",
            "b_bf16")
PRODUCT_FORMS = ("rows", "windows")  # the order of csrc/stse_train.cu's ProductForm
_MONO_HEADER = ("n_layers", "batch", "n_nodes", "ghost", "latent", "chunk", "in_flight",
                "slot_bytes", "x", "dz", "wp", "dwp", "dbp", "splits_wp", "chunk_dwp", "t_buf",
                "r_buf", "dpre_buf", "g_buf", "dg_buf", "dy_buf", "part", "block_sums", "consts",
                "prod_buf", "dtype")


class LayerOps(NamedTuple):
    """One layer's operands, flax orientation. The residual fields are None
    for an identity residual (`identity`, the counterpart of the JAX
    package's `has_identity_residual`)."""

    m: torch.Tensor  # [N, N] combined graph matrix
    w: torch.Tensor  # [C_in, C_out] tcn dense
    b: torch.Tensor  # [C_out]
    gamma: torch.Tensor  # [C_out] tcn BN scale
    beta: torch.Tensor  # [C_out] tcn BN bias
    w_res: Optional[torch.Tensor]  # [C_in, C_out] residual dense
    b_res: Optional[torch.Tensor]
    gamma_res: Optional[torch.Tensor]
    beta_res: Optional[torch.Tensor]
    alpha: torch.Tensor  # [] PReLU slope

    @property
    def identity(self) -> bool:
        return self.w_res is None


class EncoderOps(NamedTuple):
    layers: Tuple[LayerOps, ...]
    wp: torch.Tensor  # [N * C_hidden, latent], node-major rows (the flax kernel as it is)
    bp: torch.Tensor  # [latent]


N_LAYER_OPS = len(LayerOps._fields)
_MONO_LAYER = ("ci", "co", "identity", *LayerOps._fields, *("d" + f for f in LayerOps._fields),
               "act", "stats", "mt", "gpart", "dalpha_part", "chunk_dm", "chunk_dw",
               "chunk_dw_res", "splits_w", "splits_m")


def _bias(dense) -> torch.Tensor:
    if dense.bias is not None:
        return dense.bias
    return dense.kernel.new_zeros(dense.kernel.shape[1])


def encoder_ops(model) -> EncoderOps:
    """Kernel operands from an STSE's modules, built differentiably, so the
    gradients of M reach `gcn.t_adj` / `gcn.a_adj` through
    `combined_graph_matrix` (the counterpart of `encoder_ops_from_tree`)."""
    layers = []
    for i in range(model.encoder.n_layers):
        lay = getattr(model.encoder, f"layer_{i}")
        res = lay.residual_dense
        layers.append(LayerOps(
            m=combined_graph_matrix(lay.gcn.t_adj, lay.gcn.a_adj),
            w=lay.tcn_dense.kernel, b=_bias(lay.tcn_dense),
            gamma=lay.tcn_bn.scale, beta=lay.tcn_bn.bias,
            w_res=None if res is None else res.kernel,
            b_res=None if res is None else _bias(res),
            gamma_res=None if res is None else lay.residual_bn.scale,
            beta_res=None if res is None else lay.residual_bn.bias,
            alpha=lay.prelu.alpha,
        ))
    if getattr(model.btlnk, "split", None) is not None:
        raise ValueError("the fused train kernels need the projector whole: it is split "
                         "over a model axis (run.model_parallel > 1)")
    return EncoderOps(tuple(layers), model.btlnk.kernel, _bias(model.btlnk))


def detached(ops: EncoderOps, dtype: Optional[torch.dtype] = None) -> EncoderOps:
    """The operands cut from autograd and, with `dtype`, cast (the kernels
    are held against their plain versions run in float64)."""

    def cut(t):
        return None if t is None else t.detach().to(dtype or t.dtype)

    return EncoderOps(tuple(LayerOps(*(cut(t) for t in lay)) for lay in ops.layers),
                      cut(ops.wp), cut(ops.bp))


# --------------------------------------------------------------------------
# Plain PyTorch versions (the semantics; the CPU path; the kernels' oracle)
# --------------------------------------------------------------------------


def _dtype_index(compute_dtype: str) -> int:
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {compute_dtype!r} is not one of {COMPUTE_DTYPES}")
    return COMPUTE_DTYPES.index(compute_dtype)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 (round to nearest even), in t's dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


class _Bf16Einsum(torch.autograd.Function):
    """einsum(spec, a, b) with bf16 operands both ways, as a kernel's
    product under a bf16 form: forward from a and b rounded, backward from
    the rounded operands and the rounded incoming gradient (each product of
    bf16 values exact, the sums in the operands' dtype)."""

    @staticmethod
    def forward(ctx, spec, a, b):
        ar, br = _bf16(a), _bf16(b)
        ctx.spec = spec
        ctx.save_for_backward(ar, br)
        return torch.einsum(spec, ar, br)

    @staticmethod
    def backward(ctx, grad):
        ar, br = (t.detach().requires_grad_(True) for t in ctx.saved_tensors)
        with torch.enable_grad():
            da, db = torch.autograd.grad(torch.einsum(ctx.spec, ar, br), (ar, br), _bf16(grad))
        return None, da, db


class _Bf16Grad(torch.autograd.Function):
    """The identity forward; the gradient rounded to bf16."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _bf16(grad)


def _stored(x: torch.Tensor, store_bf16: bool, forward: bool = True,
            backward: bool = True) -> torch.Tensor:
    """x as a kernel stores it: rounded to bf16 under the "bfloat16" form,
    in the forward value, the gradient that reaches it, or both."""
    if not store_bf16:
        return x
    if forward and backward:
        return _bf16(x)
    return x + (_bf16(x) - x).detach() if forward else _Bf16Grad.apply(x)


_bf16_einsum = _Bf16Einsum.apply


def _ghost_bn(h: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor):
    """BatchNorm over the rows of each block, biased variance (flax's
    formula). h: [n_blocks, rows, C]. Returns (y, mean, var), mean and var
    [n_blocks, C]."""
    mean = h.mean(dim=1)
    var = torch.clamp((h * h).mean(dim=1) - mean * mean, min=0.0)
    y = (h - mean[:, None]) * torch.rsqrt(var + BN_EPS)[:, None] * gamma + beta
    return y, mean, var


def ghost_layer_reference(x: torch.Tensor, lay: LayerOps, ghost_size: int,
                          positive: Optional[torch.Tensor] = None,
                          compute_dtype: str = "float32"):
    """One ST-GCNN layer with ghost BatchNorm. x: [B, N, C_in] node-major.

    Returns (y [B, N, C_out], stats [n_blocks, 4, C_out] = (t_mean,
    t_inv_std, r_mean, r_inv_std) per ghost block, sums [4, C_out] = the
    full-batch (sum t, sum t^2, sum r, sum r^2) of the pre-BN values). An
    identity residual has r = x, block statistics (0, 1) and no BN.

    `positive` [B, N, C_out], if given, is PReLU's branch per element in
    place of pre >= 0: at a pre-activation within rounding of 0 the branch
    (and so the derivative) is a coin toss between two roundings, so a check
    that holds a kernel's backward to this version passes the branches the
    kernel's own forward took.

    Under a bf16 `compute_dtype` the products have bf16 operands both ways
    and, under "bfloat16", x (and dx), g, t, r, y (and dy) and dpre are
    rounded as the kernels store them (see the module's docstring)."""
    b, n, ci = x.shape
    co = lay.w.shape[1]
    nb = b // ghost_size
    ops_bf16 = _dtype_index(compute_dtype) > 0
    store_bf16 = compute_dtype == "bfloat16"
    if ops_bf16:
        x = _stored(x, store_bf16)
        g = _stored(_bf16_einsum("bnc,nm->bmc", x, lay.m), store_bf16, backward=False)
        t = _stored(_bf16_einsum("bnc,co->bno", g, lay.w) + lay.b, store_bf16, backward=False)
    else:
        g = torch.einsum("bnc,nm->bmc", x, lay.m)
        t = g @ lay.w + lay.b
    t = t.reshape(nb, ghost_size * n, co)
    tn, t_mean, t_var = _ghost_bn(t, lay.gamma, lay.beta)
    if lay.identity:
        r = x.reshape(nb, ghost_size * n, ci)
        rn, r_mean, r_inv = r, torch.zeros_like(t_mean), torch.ones_like(t_mean)
    else:
        if ops_bf16:
            r = _stored(_bf16_einsum("bnc,co->bno", x, lay.w_res) + lay.b_res, store_bf16,
                        backward=False)
        else:
            r = x @ lay.w_res + lay.b_res
        r = r.reshape(nb, ghost_size * n, co)
        rn, r_mean, r_var = _ghost_bn(r, lay.gamma_res, lay.beta_res)
        r_inv = torch.rsqrt(r_var + BN_EPS)
    pre = _stored(tn + rn, store_bf16, forward=False)  # dpre rounded
    branch = pre >= 0 if positive is None else positive.reshape(pre.shape)
    y = _stored(torch.where(branch, pre, lay.alpha * pre).reshape(b, n, co), store_bf16)
    stats = torch.stack([t_mean, torch.rsqrt(t_var + BN_EPS), r_mean, r_inv], dim=1)
    sums = torch.stack([t.sum((0, 1)), (t * t).sum((0, 1)), r.sum((0, 1)),
                        (r * r).sum((0, 1))])
    return y, stats, sums


def ghost_forward_reference(x: torch.Tensor, ops: EncoderOps, ghost_size: int,
                            compute_dtype: str = "float32"):
    """K2's plain version. x: [B, N, C_in] -> (z [B, latent], sums per layer
    [4, C_out], acts per layer [B, N, C_out], stats per layer [n_blocks, 4,
    C_out])."""
    sums, acts, stats = [], [], []
    h = x
    for lay in ops.layers:
        h, st, s = ghost_layer_reference(h, lay, ghost_size, compute_dtype=compute_dtype)
        acts.append(h)
        stats.append(st)
        sums.append(s)
    return _project(h, ops.wp, ops.bp, compute_dtype), sums, acts, stats


def _project(h: torch.Tensor, wp: torch.Tensor, bp: torch.Tensor,
             compute_dtype: str) -> torch.Tensor:
    """z = h_flat wp + bp, the products' operands bf16 under a bf16 form."""
    flat = h.reshape(h.shape[0], -1)
    if _dtype_index(compute_dtype) > 0:
        return _bf16_einsum("bk,kl->bl", flat, wp) + bp
    return flat @ wp + bp


def ghost_encode_reference(ops: EncoderOps, x: torch.Tensor, ghost_size: int):
    """Counterpart of `ghost_encode_reference`: x [B, C_in, T, V] ->
    (z [B, latent], per-layer dicts of full-batch pre-BN sums)."""
    b, c, t, v = x.shape
    if b % ghost_size:
        raise ValueError(f"batch {b} is not a multiple of ghost_size {ghost_size}")
    z, sums, _, _ = ghost_forward_reference(
        x.permute(0, 2, 3, 1).reshape(b, t * v, c), ops, ghost_size)
    keys = ("tcn_sum", "tcn_sumsq", "res_sum", "res_sumsq")
    return z, [dict(zip(keys, s.unbind(0)), count=float(b * t * v)) for s in sums]


def _grads_through(fn, inputs: Sequence[Optional[torch.Tensor]], grad_out: torch.Tensor):
    """Gradients of fn(*leaves) against grad_out for every input that is not
    None (None stays None), by autograd on detached copies."""
    leaves = [None if a is None else a.detach().requires_grad_(True) for a in inputs]
    with torch.enable_grad():
        out = fn(*leaves)
        live = [a for a in leaves if a is not None]
        grads = iter(torch.autograd.grad(out, live, grad_out, allow_unused=True))
    out = []
    for a in leaves:
        if a is None:
            out.append(None)
            continue
        g = next(grads)
        out.append(torch.zeros_like(a) if g is None else g)
    return out


def layer_backward_reference(x: torch.Tensor, dy: torch.Tensor, lay: LayerOps,
                             ghost_size: int, need_dx: bool = True,
                             positive: Optional[torch.Tensor] = None,
                             compute_dtype: str = "float32"):
    """K3's plain version: autograd through the ghost layer from its saved
    input. Returns (LayerOps of gradients, dx or None). `positive`: see
    `ghost_layer_reference`."""

    def fn(xx, *ops):
        return ghost_layer_reference(xx, LayerOps(*ops), ghost_size, positive, compute_dtype)[0]

    grads = _grads_through(fn, [x, *lay], dy)
    return LayerOps(*grads[1:]), grads[0] if need_dx else None


def top_backward_reference(x: torch.Tensor, dz: torch.Tensor, lay: LayerOps,
                           wp: torch.Tensor, bp: torch.Tensor, ghost_size: int,
                           need_dx: bool = True, positive: Optional[torch.Tensor] = None,
                           compute_dtype: str = "float32"):
    """K4's plain version: autograd through the top ghost layer and the
    projector. Returns (LayerOps of gradients, dwp, dbp, dx or None).
    `positive`: see `ghost_layer_reference`."""

    def fn(xx, wpp, bpp, *ops):
        y = ghost_layer_reference(xx, LayerOps(*ops), ghost_size, positive, compute_dtype)[0]
        return _project(y, wpp, bpp, compute_dtype)

    grads = _grads_through(fn, [x, wp, bp, *lay], dz)
    return LayerOps(*grads[3:]), grads[1], grads[2], grads[0] if need_dx else None


def mono_backward_reference(x: torch.Tensor, dz: torch.Tensor, ops: EncoderOps,
                            ghost_size: int, positive: Optional[Sequence[torch.Tensor]] = None,
                            compute_dtype: str = "float32") -> EncoderOps:
    """K5's plain version: the forward recomputed from x [B, N, C_in], then
    autograd of <z, dz> into every operand. Returns an EncoderOps of
    gradients (None where the operand is None); x gets none, it is data.
    `positive`, one [B, N, C_out] branch per layer: see
    `ghost_layer_reference`."""
    n_layers = len(ops.layers)
    branches = [None] * n_layers if positive is None else positive
    x = x.detach()

    def fn(*flat):
        o = _unflatten(flat, n_layers)
        h = x
        for lay, branch in zip(o.layers, branches):
            h = ghost_layer_reference(h, lay, ghost_size, branch, compute_dtype)[0]
        return _project(h, o.wp, o.bp, compute_dtype)

    return _unflatten(_grads_through(fn, _flatten(ops), dz), n_layers)


def scratch_dtype(compute_dtype: str) -> torch.dtype:
    """The dtype of K2-K5's per-window scratch (K2's t and r; the backward's
    g, t, r, dpre, dg and graph operand) in `compute_dtype`: bf16 under
    "bfloat16", as the JAX kernel stores its large intermediates in its
    dtype (coskad_tpu/kernels/stse_train.py:342-345), else float32."""
    return torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32


def activation_dtype(compute_dtype: str) -> torch.dtype:
    """The dtype of the tensors K2-K5 take and hand back (the input windows,
    each layer's activation, dy and dx) in `compute_dtype`: that of the
    scratch (the source's act_t is its scratch_t), bf16 under "bfloat16",
    where each of their values is a bf16 value, as the JAX kernel stores
    them (coskad_tpu/kernels/stse_train.py:420-422, 450), else float32."""
    return scratch_dtype(compute_dtype)


def graph_operand_size(n: int, compute_dtype: str) -> int:
    """Elements of the backward's graph operand (`graph_operand_kernel` in
    the source): M^T [N, N] in float32 for bwd_dx's dx = M dg, or under
    "bfloat16" M and M^T in bf16 rows of N rounded up to 8, for bwd_dx and
    bwd_pre (g = M^T x)."""
    if compute_dtype == "bfloat16":
        return 2 * n * (-(-n // 8) * 8)
    return n * n


def _needs_graph_operand(need_dx: bool, compute_dtype: str) -> bool:
    """Whether a layer's backward reads the graph operand: bwd_dx for dx,
    and under "bfloat16" bwd_pre on every layer."""
    return need_dx or compute_dtype == "bfloat16"


def product_reference(form: str, a: torch.Tensor, b: torch.Tensor,
                      compute_dtype: str = "float32") -> torch.Tensor:
    """One batch-reduction product, plain, in the operands' dtype: "rows"
    sums a[r, p] b[r, q] over rows r (dW = g^T dt and dW_res = x^T dr over
    B * N rows, dwp = y_flat^T dz over B windows); "windows" sums
    a[w, p, k] b[w, q, k] over windows w and channels k (dM = sum over
    windows of x dg^T, a and b [B, N, C_in]). Under a bf16 form the operands
    are rounded to bf16 first. bf16 operands (the kernels' scratch) are
    taken as float32."""
    a, b = (t.float() if t.dtype == torch.bfloat16 else t for t in (a, b))
    if _dtype_index(compute_dtype) > 0:
        a, b = _bf16(a), _bf16(b)
    if form == "rows":
        return torch.einsum("rp,rq->pq", a, b)
    if form == "windows":
        return torch.einsum("wpk,wqk->pq", a, b)
    raise ValueError(f"unknown product form {form!r}")


def products(ops: EncoderOps, batch: int) -> List[dict]:
    """The batch-reduction products of one split backward step at `batch`
    windows, as `product` runs them: name, the kernel that runs it (K4 for
    the top layer and dwp, K3_layer<l> below), form, P, Q, n (rows or
    windows) and k (channels of a window, 1 for rows), whether each operand
    is a per-window scratch buffer (a_scratch, b_scratch: bf16 under
    "bfloat16", `scratch_dtype`; the others are the layer input, its output
    and dz, float32), and its FLOPs and bytes (each operand read once, the
    output written once, at 4 bytes a value)."""
    n = ops.layers[0].m.shape[0]
    top = len(ops.layers) - 1
    out = []
    for l, lay in enumerate(ops.layers):
        ci, co = lay.w.shape
        key = "K4" if l == top else f"K3_layer{l}"
        # dW = g^T dt, dW_res = x^T dr, dM = sum x dg^T
        for name in ("dw",) + (() if lay.identity else ("dw_res",)):
            out.append(dict(name=f"layer{l}.{name}", key=key, form="rows", p=ci, q=co,
                            n=batch * n, k=1, a_scratch=name == "dw", b_scratch=True))
        out.append(dict(name=f"layer{l}.dm", key=key, form="windows", p=n, q=n, n=batch, k=ci,
                        a_scratch=False, b_scratch=True))
    out.append(dict(name="dwp", key="K4", form="rows", p=n * ops.layers[top].w.shape[1],
                    q=ops.wp.shape[1], n=batch, k=1, a_scratch=False, b_scratch=False))
    for d in out:
        d["flops"] = 2.0 * d["p"] * d["q"] * d["n"] * d["k"]
        d["bytes"] = 4.0 * (d["n"] * d["k"] * (d["p"] + d["q"]) + d["p"] * d["q"])
    return out


# --------------------------------------------------------------------------
# CUDA launches
# --------------------------------------------------------------------------


def _bind(lib):
    """Set the argument and return types of the kernel library's C entries."""
    for fn in REPLACES:
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        getattr(lib, fn).restype = ctypes.c_int
    lib.stse_train_error_string.argtypes = [ctypes.c_int]
    lib.stse_train_error_string.restype = ctypes.c_char_p
    return lib


def _library():
    from . import build

    return build.load("stse_train", _bind)


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _checked(t: Optional[torch.Tensor], device: torch.device, shape, name: str,
             dtypes=(torch.float32,)):
    """A contiguous tensor of one of `dtypes` (float32) and `shape` on
    `device` (None stays None)."""
    if t is None:
        return None
    if t.device != device or t.dtype not in dtypes or tuple(t.shape) != tuple(shape):
        want = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise ValueError(f"stse_train: {name} must be {want} {tuple(shape)} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t.detach().contiguous()


def _layer_operands(lay: LayerOps, n: int, device) -> LayerOps:
    ci, co = lay.w.shape
    if lay.identity and ci != co:
        raise ValueError("an identity residual needs C_in == C_out")
    shapes = dict(m=(n, n), w=(ci, co), b=(co,), gamma=(co,), beta=(co,), w_res=(ci, co),
                  b_res=(co,), gamma_res=(co,), beta_res=(co,), alpha=())
    return LayerOps(*(_checked(getattr(lay, f), device, shapes[f], f) for f in LayerOps._fields))


def _run(lib, fn: str, desc: np.ndarray, device) -> None:
    desc = np.ascontiguousarray(desc, np.int64)
    if device.type == "cuda":
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = getattr(lib, fn)(desc.ctypes.data, stream)
    else:  # the CUDA source run on the host by the tests
        err = getattr(lib, fn)(desc.ctypes.data, None)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: {lib.stse_train_error_string(err).decode()}")


def forward_buffers(ops: EncoderOps, batch: int, ghost_size: int,
                    compute_dtype: str = "float32") -> dict:
    """Everything K2 allocates for `batch` windows in `compute_dtype`
    (`launch_forward` allocates from this): name -> (shape, dtype), None
    where not needed. Its outputs z and each layer's activation, block
    statistics and full-batch sums; the t / r scratch and moments over the
    widest layer; the projector's split partials; under "bfloat16" the
    graph operand. Its total (`buffer_bytes`) is K5's budget."""
    n = ops.layers[0].m.shape[0]
    latent = ops.wp.shape[1]
    cmax = max(lay.w.shape[1] for lay in ops.layers)
    f32, sc = torch.float32, scratch_dtype(compute_dtype)
    z_splits = projector_splits(n * ops.layers[-1].w.shape[1], batch, latent)
    out = dict(z=((batch, latent), f32), t_buf=((batch * n * cmax,), sc),
               r_buf=((batch * n * cmax,), sc), part=((batch * 4 * cmax,), f32),
               block_sums=((batch // ghost_size * 4 * cmax,), f32),
               z_part=((z_splits * batch * latent,), f32),  # the projector's split partials
               # under "bfloat16" fwd_pre reads each layer's bf16 M^T, built in turn here
               graph=((graph_operand_size(n, compute_dtype),), sc)
               if compute_dtype == "bfloat16" else None)
    for l, lay in enumerate(ops.layers):
        co = lay.w.shape[1]
        out[f"act{l}"] = ((batch, n, co), activation_dtype(compute_dtype))
        out[f"stats{l}"] = ((batch // ghost_size, 4, co), f32)
        out[f"sums{l}"] = ((4, co), f32)
    return out


def buffer_bytes(buffers: dict) -> int:
    """Bytes of `forward_buffers`' or `mono_batch_buffers`' allocations."""
    return sum(int(np.prod(shape)) * dtype.itemsize
               for shape, dtype in (v for v in buffers.values() if v is not None))


def launch_forward(lib, x: torch.Tensor, ops: EncoderOps, ghost_size: int,
                   compute_dtype: str = "float32"):
    """Run K2 from `lib` on x [B, N, C_in] (the device's tensors, or host
    tensors for the CUDA source compiled on the host) in `compute_dtype`, x
    and the activations in `activation_dtype`. Same returns as
    `ghost_forward_reference`."""
    b, n, c0 = x.shape
    dev = x.device
    if b % ghost_size or b < 1:
        raise ValueError(f"batch {b} must be a positive multiple of ghost_size {ghost_size}")
    if ops.layers[0].w.shape[0] != c0:
        raise ValueError(f"input has {c0} channels, layer 0 takes {ops.layers[0].w.shape[0]}")
    x = _checked(x, dev, (b, n, c0), "x", (activation_dtype(compute_dtype),))
    layers = [_layer_operands(lay, n, dev) for lay in ops.layers]
    c_hidden = layers[-1].w.shape[1]
    latent = ops.wp.shape[1]
    wp = _checked(ops.wp, dev, (n * c_hidden, latent), "wp")
    bp = _checked(ops.bp, dev, (latent,), "bp")
    buf = {k: None if v is None else torch.empty(v[0], dtype=v[1], device=dev)
           for k, v in forward_buffers(ops, b, ghost_size, compute_dtype).items()}
    desc = [len(layers), b, n, ghost_size, latent, _ptr(x), _ptr(wp), _ptr(bp),
            *(_ptr(buf[k]) for k in ("z", "t_buf", "r_buf", "part", "block_sums")),
            projector_splits(n * c_hidden, b, latent), _ptr(buf["z_part"]), _ptr(buf["graph"]),
            _dtype_index(compute_dtype)]
    for l, lay in enumerate(layers):
        ci, co = lay.w.shape
        desc += [ci, co, int(lay.identity), *(_ptr(t) for t in lay),
                 *(_ptr(buf[f"{k}{l}"]) for k in ("act", "stats", "sums"))]
    assert len(desc) == len(_FWD_HEADER) + len(layers) * len(_FWD_LAYER)
    _run(lib, "stse_train_forward", np.asarray(desc, np.int64), dev)
    pick = lambda k: [buf[f"{k}{l}"] for l in range(len(layers))]
    return buf["z"], pick("sums"), pick("act"), pick("stats")


# The product kernels' tiles and steps, as csrc/stse_train.cu has them.
_PRODUCT_WARPS = 8  # warps a block, each with its own share of the block's steps
_Z_WINDOWS = 128  # K2's projector: windows a block (kZWindows), by 16 latent columns
_ROWS_STEP = 16  # rows form: rows a step (kRowsStep)
_CHAN_STEP = 16  # windows form: channels of one window a step (kChanStep)
_WINDOWS_TILE = (32, 56)  # windows form: the output tile (dM: 7 x 4 tiles of 216 x 216)


def product_tile(form: str, p: int, q: int) -> Tuple[int, int]:
    """The output tile one block of the product kernel owns: rows form the
    least of 16, 32, 64 that holds P (and Q), else 64 (`launch_product` in
    the source); windows form 32 x 56."""
    if form == "windows":
        return _WINDOWS_TILE
    return tuple(16 if d <= 16 else 32 if d <= 32 else 64 for d in (p, q))


def product_splits(form: str, p: int, q: int, n: int, k: int = 1,
                   target_blocks: int = 264) -> int:
    """How many blocks split one output tile's reduction of n rows (or n
    windows of k channels): enough for two waves of one 256-thread block an
    SM over 132 SMs, as long as each warp keeps at least two steps of its
    own. At the flagship width and B = 2048 the largest partials (dW's,
    264 x 32 x 64 floats) stay under the 64 x 64-tile design's (dM's,
    17 x 216^2)."""
    pt, qt = product_tile(form, p, q)
    tiles = -(-p // pt) * -(-q // qt)
    steps = -(-n // _ROWS_STEP) if form == "rows" else n * -(-k // _CHAN_STEP)
    return max(1, min(-(-target_blocks // tiles), steps // (2 * _PRODUCT_WARPS)))


def projector_splits(rows: int, batch: int, latent: int, target_blocks: int = 528) -> int:
    """How many blocks split K2's projector z = y_flat wp + bp along the
    `rows` (N * C_out) of wp: four blocks an SM over 132 SMs (a block holds
    no shared memory and few registers), as long as each keeps at least
    four k-steps of 8 rows. A block owns 128 windows by 16 latent columns,
    so it reads its rows of wp from L2 once per 128 windows."""
    tiles = -(-batch // _Z_WINDOWS) * -(-latent // 16)
    return max(1, min(-(-target_blocks // tiles), -(-rows // 32)))


def partials(*products: Tuple[int, int]) -> int:
    """Floats of the partials buffer the products (splits, P * Q) share, run
    one after another: a product with one split writes its output directly."""
    return max([1] + [s * size for s, size in products if s > 1])


def launch_backward(lib, x: torch.Tensor, y: torch.Tensor, stats: torch.Tensor, lay: LayerOps,
                    ghost_size: int, need_dx: bool, dy: Optional[torch.Tensor] = None,
                    dz: Optional[torch.Tensor] = None, wp: Optional[torch.Tensor] = None,
                    compute_dtype: str = "float32"):
    """Run K3 (dy given) or K4 (dz and wp given) from `lib` on the layer's
    input x and output y (K2's: the backward takes PReLU's branch from its
    sign) in `compute_dtype`, x, y, dy and dx in `activation_dtype`. Returns
    (LayerOps of gradients, dwp, dbp, dx); dwp and dbp are None for K3 and dx
    is None unless need_dx."""
    b, n, ci = x.shape
    dev = x.device
    top = dz is not None
    co = lay.w.shape[1]
    if b % ghost_size or b < 1:
        raise ValueError(f"batch {b} must be a positive multiple of ghost_size {ghost_size}")
    act = dict(dtype=activation_dtype(compute_dtype), device=dev)
    x = _checked(x, dev, (b, n, ci), "x", (act["dtype"],))
    y = _checked(y, dev, (b, n, co), "y", (act["dtype"],))
    lay = _layer_operands(lay, n, dev)
    stats = _checked(stats, dev, (b // ghost_size, 4, co), "stats")
    latent = 0
    if top:
        latent = dz.shape[1]
        dz = _checked(dz, dev, (b, latent), "dz")
        wp = _checked(wp, dev, (n * co, latent), "wp")
    else:
        dy = _checked(dy, dev, (b, n, co), "dy", (act["dtype"],))
    f32 = dict(dtype=torch.float32, device=dev)
    sc = dict(dtype=scratch_dtype(compute_dtype), device=dev)
    grads = LayerOps(*(None if t is None else torch.empty(t.shape, **f32) for t in lay))
    dx = torch.empty((b, n, ci), **act) if need_dx else None
    dwp = torch.empty((n * co, latent), **f32) if top else None
    dbp = torch.empty((latent,), **f32) if top else None
    rows = b * n
    splits = dict(w=product_splits("rows", ci, co, rows),
                  w_res=product_splits("rows", ci, co, rows),
                  m=product_splits("windows", n, n, b, ci),
                  wp=product_splits("rows", n * co, latent, b) if top else 1)
    prod = partials((splits["w"], ci * co), (splits["w_res"], ci * co), (splits["m"], n * n),
                    (splits["wp"], n * co * latent))
    nb = b // ghost_size
    scratch = dict(
        mt=torch.empty((graph_operand_size(n, compute_dtype),), **sc)
        if _needs_graph_operand(need_dx, compute_dtype) else None,
        g_buf=torch.empty((rows * ci,), **sc), t_buf=torch.empty((rows * co,), **sc),
        r_buf=torch.empty((rows * co,), **sc), dpre_buf=torch.empty((rows * co,), **sc),
        dg_buf=torch.empty((rows * ci,), **sc), part=torch.empty((b * 3 * co,), **f32),
        dalpha_part=torch.empty((b,), **f32), consts=torch.empty((nb * 6 * co,), **f32),
        gpart=torch.empty((nb * 6 * co,), **f32), prod_buf=torch.empty((prod,), **f32))
    fields = dict(
        batch=b, n_nodes=n, ghost=ghost_size, ci=ci, co=co, identity=int(lay.identity),
        latent=latent, x=_ptr(x), dy=_ptr(dy), dz=_ptr(dz), wp=_ptr(wp), y=_ptr(y),
        stats=_ptr(stats), dx=_ptr(dx), dwp=_ptr(dwp), dbp=_ptr(dbp),
        **{f: _ptr(getattr(lay, f)) for f in LayerOps._fields},
        **{"d" + f: _ptr(getattr(grads, f)) for f in LayerOps._fields},
        **{k: _ptr(v) for k, v in scratch.items()},
        **{f"splits_{k}": v for k, v in splits.items()}, dtype=_dtype_index(compute_dtype))
    desc = np.asarray([fields[f] for f in _BWD], np.int64)
    _run(lib, "stse_train_top_backward" if top else "stse_train_layer_backward", desc, dev)
    return grads, dwp, dbp, dx


def _product_shape(form: str, a: torch.Tensor, b: torch.Tensor):
    """(P, Q, n, k) of a product's operands, or ValueError."""
    if form == "rows" and a.dim() == 2 and b.dim() == 2 and a.shape[0] == b.shape[0]:
        return a.shape[1], b.shape[1], a.shape[0], 1
    if (form == "windows" and a.dim() == 3 and b.dim() == 3 and a.shape[0] == b.shape[0]
            and a.shape[2] == b.shape[2]):
        return a.shape[1], b.shape[1], a.shape[0], a.shape[2]
    raise ValueError(f"stse_train product {form!r}: operands {tuple(a.shape)} and "
                     f"{tuple(b.shape)} do not fit (rows: [R, P], [R, Q]; windows: "
                     "[W, P, K], [W, Q, K])")


def launch_product(lib, form: str, a: torch.Tensor, b: torch.Tensor,
                   splits: Optional[int] = None, compute_dtype: str = "float32") -> torch.Tensor:
    """Run one batch-reduction product from `lib` (see `product_reference`)
    with the kernel K3, K4 and K5 use, in `compute_dtype`'s operand
    precision; `splits` overrides `product_splits`. Each operand is float32
    or, under a bf16 form, bfloat16 (as K3-K5 hand over their scratch
    operands under "bfloat16")."""
    p, q, n, k = _product_shape(form, a, b)
    dev = a.device
    kinds = (torch.float32, torch.bfloat16) if _dtype_index(compute_dtype) > 0 else (
        torch.float32,)
    a = _checked(a, dev, a.shape, "a", kinds)
    b = _checked(b, dev, b.shape, "b", kinds)
    splits = product_splits(form, p, q, n, k) if splits is None else splits
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty((p, q), **f32)
    part = torch.empty((splits * p * q,), **f32) if splits > 1 else None
    fields = dict(form=PRODUCT_FORMS.index(form), p=p, q=q, n=n, k=k, a=_ptr(a), b=_ptr(b),
                  splits=splits, part=_ptr(part), out=_ptr(out),
                  dtype=_dtype_index(compute_dtype), a_bf16=int(a.dtype == torch.bfloat16),
                  b_bf16=int(b.dtype == torch.bfloat16))
    _run(lib, "stse_train_product", np.asarray([fields[f] for f in _PRODUCT], np.int64), dev)
    return out


_OCCUPANCY = ("bwd_pre_windows_per_block", "bwd_pre_smem_bytes", "bwd_pre_blocks_per_sm",
              "bwd_dx_smem_bytes", "bwd_dx_blocks_per_sm", "fwd_pre_windows_per_block",
              "fwd_pre_smem_bytes", "fwd_pre_blocks_per_sm", "fwd_apply_smem_bytes",
              "fwd_apply_blocks_per_sm", "projector_z_blocks_per_sm")


def pass_occupancy(lib, n: int, ci: int, co: int, compute_dtype: str = "float32") -> dict:
    """K2-K5's per-window passes for a layer of C_in ci and C_out co on n
    nodes in `compute_dtype`, from `lib`: fwd_pre's and bwd_pre's windows a
    block, and the shared bytes a block and blocks an SM on the current
    device (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`) of bwd_pre,
    bwd_dx, fwd_pre and fwd_apply, and the blocks an SM of K2's projector_z
    (no shared memory; the same for every layer)."""
    fn = lib.stse_train_pass_occupancy
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = np.zeros(len(_OCCUPANCY), np.int32)
    err = fn(n, ci, co, _dtype_index(compute_dtype), out.ctypes.data)
    if err != 0:
        raise RuntimeError(f"stse_train_pass_occupancy failed: "
                           f"{lib.stse_train_error_string(err).decode()}")
    return {k: int(v) for k, v in zip(_OCCUPANCY, out)}


def _in_flight(in_flight: Optional[int]) -> int:
    """K5's chunks in flight: `in_flight`, by default MONO_IN_FLIGHT; 1 or 2."""
    k = MONO_IN_FLIGHT if in_flight is None else in_flight
    if k not in (1, 2):
        raise ValueError(f"K5 runs 1 or 2 chunks in flight, not {k}")
    return k


def mono_chunk(ops: EncoderOps, batch: int, ghost_size: int, compute_dtype: str = "float32",
               chunk_windows: Optional[int] = None, in_flight: Optional[int] = None) -> int:
    """K5's chunk in windows, whole ghost blocks, at least one block, at
    most the batch: `chunk_windows` cut down to whole blocks where given.
    Else the budget's: the largest chunk whose `mono_footprint` with
    `in_flight` chunks in flight (default MONO_IN_FLIGHT) stays at or
    under what K2's forward allocates at the same batch (`forward_buffers`;
    a mono step's peak is K2's forward, so K5 adds none to it) sets the
    number of chunks, and the chunk is the least that keeps that number:
    chunks as even as whole blocks allow, with no short last chunk that
    runs its passes on few blocks."""
    if chunk_windows is not None:
        return min(max(ghost_size, chunk_windows // ghost_size * ghost_size), batch)
    # every mono backward asks, and the rule tries every block count
    key = (ops.layers[0].m.shape[0], tuple((*lay.w.shape, lay.identity) for lay in ops.layers),
           ops.wp.shape[1], batch, ghost_size, compute_dtype, _in_flight(in_flight))
    if key not in _BUDGET_CHUNKS:
        _BUDGET_CHUNKS[key] = _budget_chunk(ops, batch, ghost_size, compute_dtype, key[-1])
    return _BUDGET_CHUNKS[key]


_BUDGET_CHUNKS = {}  # mono_chunk's budget rule by shapes, batch, ghost, form and in flight


def _budget_chunk(ops: EncoderOps, batch: int, ghost_size: int, compute_dtype: str,
                  in_flight: int) -> int:
    budget = buffer_bytes(forward_buffers(ops, batch, ghost_size, compute_dtype))
    for blocks in range(batch // ghost_size, 0, -1):
        chunk = blocks * ghost_size
        if mono_footprint(ops, batch, chunk, ghost_size, compute_dtype, in_flight) <= budget:
            even = -(-batch // (-(-batch // chunk) * ghost_size)) * ghost_size
            fits = mono_footprint(ops, batch, even, ghost_size, compute_dtype, in_flight) <= budget
            return even if fits else chunk
    return ghost_size


def _mono_splits(ops: EncoderOps, chunk: int) -> Tuple[int, List[Tuple[int, int]]]:
    """The split counts of K5's products over one chunk: dwp's, and each
    layer's (dW and dW_res, dM)."""
    n = ops.layers[0].m.shape[0]
    layers = []
    for lay in ops.layers:
        ci, co = lay.w.shape
        layers.append((product_splits("rows", ci, co, chunk * n),
                       product_splits("windows", n, n, chunk, ci)))
    return product_splits("rows", n * ops.layers[-1].w.shape[1], ops.wp.shape[1], chunk), layers


def mono_workspace(ops: EncoderOps, n: int, chunk: int, ghost_size: int,
                   compute_dtype: str = "float32") -> dict:
    """One chunk's workspace for K5 in `compute_dtype`, name -> bytes (None:
    not needed); each chunk in flight has its own. It scales with the
    chunk, not the batch. The per-window scratch (t, r, dpre, g, dg) takes
    `scratch_dtype`, each layer's activation and dy take `activation_dtype`
    (both bf16 under "bfloat16"); the moments, statistics, constants and
    the products' split partials (prod_buf) are float32."""
    co = [lay.w.shape[1] for lay in ops.layers]
    ci = [lay.w.shape[0] for lay in ops.layers]
    rows, blocks = chunk * n, chunk // ghost_size
    splits_wp, splits = _mono_splits(ops, chunk)
    prod = partials((splits_wp, n * co[-1] * ops.wp.shape[1]),
                    *((s, size) for (s_w, s_m), a, b in zip(splits, ci, co)
                      for s, size in ((s_w, a * b), (s_m, n * n))))
    count = dict(t_buf=rows * max(co), r_buf=rows * max(co), dpre_buf=rows * max(co),
                 g_buf=rows * max(ci), dg_buf=rows * max(ci),
                 dy_buf=rows * max(ci[1:]) if len(ci) > 1 else None,
                 part=chunk * 4 * max(co), block_sums=blocks * 4 * max(co),
                 consts=blocks * 6 * max(co), prod_buf=prod)
    for l, c in enumerate(co):
        count[f"act{l}"] = rows * c
        count[f"stats{l}"] = blocks * 4 * c
    small = scratch_dtype(compute_dtype).itemsize
    return {k: None if v is None else v * (4 if _mono_f32(k) else small)
            for k, v in count.items()}


def _mono_f32(name: str) -> bool:
    """Whether K5's workspace buffer `name` is float32 in every form: the
    moments, block sums, constants, split partials and statistics."""
    return name in ("part", "block_sums", "consts", "prod_buf") or name.startswith("stats")


_SLOT_ALIGN = 256  # bytes: where each buffer of a chunk workspace starts


def _slot_layout(workspace: dict) -> Tuple[dict, int]:
    """Byte offsets of a chunk workspace's buffers (`mono_workspace`) in
    one slot (None stays None), and the slot's bytes."""
    offsets, size = {}, 0
    for k, nbytes in workspace.items():
        offsets[k] = None if nbytes is None else size
        size += 0 if nbytes is None else -(-nbytes // _SLOT_ALIGN) * _SLOT_ALIGN
    return offsets, size


def mono_batch_buffers(ops: EncoderOps, batch: int, chunk: int, ghost_size: int,
                       compute_dtype: str = "float32") -> dict:
    """K5's buffers over the whole batch (`launch_mono_backward` allocates
    from this), name -> (shape, dtype), None where not needed: each layer's
    gradients, its graph operand, its per-block and per-window shares
    (gpart, dalpha_part) and its per-chunk products (chunk_dm, chunk_dw,
    chunk_dw_res); dwp, dbp and the per-chunk dwp."""
    n = ops.layers[0].m.shape[0]
    latent = ops.wp.shape[1]
    n_chunks = -(-batch // chunk)
    f32, sc = torch.float32, scratch_dtype(compute_dtype)
    out = {}
    for l, lay in enumerate(ops.layers):
        ci, co = lay.w.shape
        out.update({f"d{f}{l}": None if t is None else (tuple(t.shape), f32)
                    for f, t in zip(LayerOps._fields, lay)})
        out.update({
            f"mt{l}": ((graph_operand_size(n, compute_dtype),), sc)
            if _needs_graph_operand(l > 0, compute_dtype) else None,
            f"gpart{l}": ((batch // ghost_size * 6 * co,), f32), f"dalpha_part{l}": ((batch,), f32),
            f"chunk_dm{l}": ((n_chunks * n * n,), f32), f"chunk_dw{l}": ((n_chunks * ci * co,), f32),
            f"chunk_dw_res{l}": None if lay.identity else ((n_chunks * ci * co,), f32)})
    out.update(dwp=((n * ops.layers[-1].w.shape[1], latent), f32), dbp=((latent,), f32),
               chunk_dwp=((n_chunks * n * ops.layers[-1].w.shape[1] * latent,), f32))
    return out


def mono_footprint(ops: EncoderOps, batch: int, chunk: int, ghost_size: int,
                   compute_dtype: str = "float32", in_flight: Optional[int] = None) -> int:
    """Bytes K5 allocates at `chunk` windows with `in_flight` chunks in
    flight (no more than there are chunks): a chunk workspace each, laid
    out as one slot (`mono_workspace`), and the whole-batch buffers
    (`mono_batch_buffers`)."""
    n = ops.layers[0].m.shape[0]
    slots = min(_in_flight(in_flight), -(-batch // chunk))
    slot = _slot_layout(mono_workspace(ops, n, chunk, ghost_size, compute_dtype))[1]
    return slots * slot + buffer_bytes(mono_batch_buffers(ops, batch, chunk, ghost_size,
                                                          compute_dtype))


def launch_mono_backward(lib, x: torch.Tensor, dz: torch.Tensor, ops: EncoderOps,
                         ghost_size: int, chunk_windows: Optional[int] = None,
                         compute_dtype: str = "float32",
                         in_flight: Optional[int] = None) -> EncoderOps:
    """Run K5 from `lib` on x [B, N, C_in] (in `activation_dtype`) and dz
    [B, latent] in `compute_dtype`: every operand's gradient, the forward
    recomputed chunk by chunk (`mono_chunk`), `in_flight` chunks at a time
    (default MONO_IN_FLIGHT), each in its own slot of one workspace. Same
    return as `mono_backward_reference`."""
    b, n, c0 = x.shape
    dev = x.device
    if b % ghost_size or b < 1:
        raise ValueError(f"batch {b} must be a positive multiple of ghost_size {ghost_size}")
    if ops.layers[0].w.shape[0] != c0:
        raise ValueError(f"input has {c0} channels, layer 0 takes {ops.layers[0].w.shape[0]}")
    layers = [_layer_operands(lay, n, dev) for lay in ops.layers]
    c_hidden = layers[-1].w.shape[1]
    latent = ops.wp.shape[1]
    x = _checked(x, dev, (b, n, c0), "x", (activation_dtype(compute_dtype),))
    dz = _checked(dz, dev, (b, latent), "dz")
    wp = _checked(ops.wp, dev, (n * c_hidden, latent), "wp")
    chunk = mono_chunk(ops, b, ghost_size, compute_dtype, chunk_windows, in_flight)
    slots = min(_in_flight(in_flight), -(-b // chunk))
    offsets, slot_bytes = _slot_layout(mono_workspace(ops, n, chunk, ghost_size, compute_dtype))
    space = torch.empty((slots * slot_bytes,), dtype=torch.uint8, device=dev)
    ws = {k: 0 if o is None else space.data_ptr() + o for k, o in offsets.items()}  # slot 0's
    buf = {k: None if v is None else torch.empty(v[0], dtype=v[1], device=dev)
           for k, v in mono_batch_buffers(ops, b, chunk, ghost_size, compute_dtype).items()}
    splits_wp, splits = _mono_splits(ops, chunk)
    rows = []
    for l, (lay, (splits_w, splits_m)) in enumerate(zip(layers, splits)):
        fields = dict(ci=lay.w.shape[0], co=lay.w.shape[1], identity=int(lay.identity),
                      act=ws[f"act{l}"], stats=ws[f"stats{l}"], splits_w=splits_w,
                      splits_m=splits_m, **{f: _ptr(getattr(lay, f)) for f in LayerOps._fields},
                      **{k: _ptr(buf[f"{k}{l}"]) for k in (
                          *("d" + f for f in LayerOps._fields), "mt", "gpart", "dalpha_part",
                          "chunk_dm", "chunk_dw", "chunk_dw_res")})
        rows += [fields[f] for f in _MONO_LAYER]
    header = dict(n_layers=len(layers), batch=b, n_nodes=n, ghost=ghost_size, latent=latent,
                  chunk=chunk, in_flight=slots, slot_bytes=slot_bytes, x=_ptr(x), dz=_ptr(dz),
                  wp=_ptr(wp), dwp=_ptr(buf["dwp"]), dbp=_ptr(buf["dbp"]), splits_wp=splits_wp,
                  chunk_dwp=_ptr(buf["chunk_dwp"]), dtype=_dtype_index(compute_dtype),
                  **{k: ws[k] for k in ("t_buf", "r_buf", "dpre_buf", "g_buf", "dg_buf", "dy_buf",
                                        "part", "block_sums", "consts", "prod_buf")})
    desc = np.asarray([header[f] for f in _MONO_HEADER] + rows, np.int64)
    _run(lib, "stse_train_mono_backward", desc, dev)
    grads = tuple(LayerOps(*(buf[f"d{f}{l}"] for f in LayerOps._fields))
                  for l in range(len(layers)))
    return EncoderOps(grads, buf["dwp"], buf["dbp"])


# --------------------------------------------------------------------------
# The wrappers: kernel on a CUDA tensor, plain version on a CPU tensor
# --------------------------------------------------------------------------


def _route(x: torch.Tensor) -> bool:
    if x.is_cuda:
        return True
    if x.device.type != "cpu":
        raise ValueError(f"stse_train runs on CUDA or CPU tensors, not {x.device}")
    return False


def _plain_inputs(compute_dtype: str, **tensors: Optional[torch.Tensor]):
    """A wrapper's activation inputs (windows, y, dy) for its plain version,
    in order: under "bfloat16" each must be a bf16 tensor, as the kernels
    take it, and is widened to float32 (exactly); else each goes through as
    it is (the plain versions keep their input's dtype)."""
    out = []
    for name, t in tensors.items():
        if compute_dtype == "bfloat16" and t is not None:
            if t.dtype != torch.bfloat16:
                raise ValueError(f"stse_train: {name} must be bfloat16 under compute_dtype "
                                 f"'bfloat16', got {t.dtype}")
            t = t.float()
        out.append(t)
    return out


def _as_activation(t: Optional[torch.Tensor], compute_dtype: str) -> Optional[torch.Tensor]:
    """A plain version's activation or dx as the kernels hand it back: bf16
    under "bfloat16" (its values are bf16 values already), else as it is."""
    return t if t is None or compute_dtype != "bfloat16" else t.to(torch.bfloat16)


def ghost_forward(x: torch.Tensor, ops: EncoderOps, ghost_size: int,
                  compute_dtype: str = "float32"):
    """K2: x [B, N, C_in] -> (z, sums, acts, stats), see
    `ghost_forward_reference`; x and acts in `activation_dtype` on both
    routes, so the autograd Function saves the same bytes on each."""
    if _route(x):
        with torch.no_grad():
            out = launch_forward(_library(), x, ops, ghost_size, compute_dtype)
        forward_launches.value += 1
        return out
    (x,) = _plain_inputs(compute_dtype, x=x)
    z, sums, acts, stats = ghost_forward_reference(x, ops, ghost_size, compute_dtype)
    return z, sums, [_as_activation(a, compute_dtype) for a in acts], stats


def layer_backward(x: torch.Tensor, y: torch.Tensor, dy: torch.Tensor, lay: LayerOps,
                   stats: torch.Tensor, ghost_size: int, need_dx: bool = True,
                   compute_dtype: str = "float32"):
    """K3: one lower layer's backward from its saved input x, output y and
    block statistics. Returns (LayerOps of gradients, dx or None); x, y, dy
    and dx in `activation_dtype`. The plain version recomputes y, bit for
    bit what the plain forward gave."""
    if _route(x):
        with torch.no_grad():
            grads, _, _, dx = launch_backward(_library(), x, y, stats, lay, ghost_size, need_dx,
                                              dy=dy, compute_dtype=compute_dtype)
        layer_backward_launches.value += 1
        return grads, dx
    x, _, dy = _plain_inputs(compute_dtype, x=x, y=y, dy=dy)
    grads, dx = layer_backward_reference(x, dy, lay, ghost_size, need_dx,
                                         compute_dtype=compute_dtype)
    return grads, _as_activation(dx, compute_dtype)


def top_backward(x: torch.Tensor, y_top: torch.Tensor, dz: torch.Tensor, lay: LayerOps,
                 stats: torch.Tensor, wp: torch.Tensor, bp: torch.Tensor, ghost_size: int,
                 need_dx: bool = True, compute_dtype: str = "float32"):
    """K4: the top layer's backward with the projector's. Returns (LayerOps
    of gradients, dwp, dbp, dx or None); x, y_top and dx in
    `activation_dtype`."""
    if _route(x):
        with torch.no_grad():
            out = launch_backward(_library(), x, y_top, stats, lay, ghost_size, need_dx, dz=dz,
                                  wp=wp, compute_dtype=compute_dtype)
        top_backward_launches.value += 1
        return out
    x, _ = _plain_inputs(compute_dtype, x=x, y_top=y_top)
    grads, dwp, dbp, dx = top_backward_reference(x, dz, lay, wp, bp, ghost_size, need_dx,
                                                 compute_dtype=compute_dtype)
    return grads, dwp, dbp, _as_activation(dx, compute_dtype)


def product(form: str, a: torch.Tensor, b: torch.Tensor,
            compute_dtype: str = "float32") -> torch.Tensor:
    """One batch-reduction product alone, as K3, K4 and K5 run it inside
    (see `product_reference` for the forms): checked and timed on its own by
    chip_smoke.py. On a CPU tensor, the plain version."""
    if _route(a):
        with torch.no_grad():
            out = launch_product(_library(), form, a, b, compute_dtype=compute_dtype)
        product_launches.value += 1
        return out
    _product_shape(form, a, b)
    return product_reference(form, a, b, compute_dtype)


def split_backward(x: torch.Tensor, dz: torch.Tensor, ops: EncoderOps,
                   acts: Sequence[torch.Tensor], stats: Sequence[torch.Tensor],
                   ghost_size: int, compute_dtype: str = "float32") -> EncoderOps:
    """The split backward: K4 for the top layer, then K3 down the stack,
    from K2's activations and block statistics. Returns an EncoderOps of
    gradients, as `mono_backward`."""
    top = len(ops.layers) - 1
    x_in = [x, *acts[:-1]]
    d_layers = [None] * (top + 1)
    d_layers[top], dwp, dbp, dy = top_backward(x_in[top], acts[top], dz, ops.layers[top],
                                               stats[top], ops.wp, ops.bp, ghost_size,
                                               need_dx=top > 0, compute_dtype=compute_dtype)
    for l in reversed(range(top)):
        d_layers[l], dy = layer_backward(x_in[l], acts[l], dy, ops.layers[l], stats[l],
                                         ghost_size, need_dx=l > 0, compute_dtype=compute_dtype)
    return EncoderOps(tuple(d_layers), dwp, dbp)


def mono_backward(x: torch.Tensor, dz: torch.Tensor, ops: EncoderOps, ghost_size: int,
                  chunk_windows: Optional[int] = None, compute_dtype: str = "float32",
                  in_flight: Optional[int] = None) -> EncoderOps:
    """K5: every operand's gradient from x [B, N, C_in] (in
    `activation_dtype`) and dz [B, latent] alone, the forward recomputed one
    chunk of ghost blocks at a time (`mono_chunk`), `in_flight` chunks at
    once (default MONO_IN_FLIGHT). x gets none: it is data."""
    if _route(x):
        with torch.no_grad():
            out = launch_mono_backward(_library(), x, dz, ops, ghost_size, chunk_windows,
                                       compute_dtype, in_flight)
        mono_backward_launches.value += 1
        return out
    (x,) = _plain_inputs(compute_dtype, x=x)
    return mono_backward_reference(x, dz, ops, ghost_size, compute_dtype=compute_dtype)


class FusedGhostEncode(torch.autograd.Function):
    """Ghost-BN STSE encode (the port of `fused_ghost_encode`).
    forward(x [B, N, C_in], ghost_size, n_layers, bwd_mode, compute_dtype, *flat
    operands: N_LAYER_OPS per layer then wp, bp) -> (z, *per-layer sums). The sums
    carry no gradient, and x gets none: it is data. bwd_mode "split" saves
    K2's activations and block statistics for K4 then K3; "mono" (:1089-1104)
    saves only x and the operands, and K5 recomputes the rest from x. x and
    the activations are in `activation_dtype` (bf16 under "bfloat16")."""

    @staticmethod
    def forward(ctx, x, ghost_size, n_layers, bwd_mode, compute_dtype, *flat):
        ops = _unflatten(flat, n_layers)
        z, sums, acts, stats = ghost_forward(x, ops, ghost_size, compute_dtype)
        kept = (*acts, *stats) if bwd_mode == "split" else ()
        ctx.ghost_size, ctx.n_layers, ctx.bwd_mode = ghost_size, n_layers, bwd_mode
        ctx.compute_dtype = compute_dtype
        ctx.save_for_backward(x, *kept, *(t for t in flat if t is not None))
        ctx.present = [t is not None for t in flat]
        ctx.mark_non_differentiable(*sums)
        return (z, *sums)

    @staticmethod
    def backward(ctx, dz, *_):
        n_layers, dz = ctx.n_layers, dz.contiguous()
        x, *saved = ctx.saved_tensors
        if ctx.bwd_mode == "split":
            acts, stats = saved[:n_layers], saved[n_layers:2 * n_layers]
            saved = saved[2 * n_layers:]
        rest = iter(saved)
        ops = _unflatten([next(rest) if p else None for p in ctx.present], n_layers)
        if ctx.bwd_mode == "split":
            d_ops = split_backward(x, dz, ops, acts, stats, ctx.ghost_size, ctx.compute_dtype)
        else:
            d_ops = mono_backward(x, dz, ops, ctx.ghost_size, compute_dtype=ctx.compute_dtype)
        grads = [None if not p else g for g, p in zip(_flatten(d_ops), ctx.present)]
        return (None, None, None, None, None, *grads)


def _flatten(ops: EncoderOps) -> List[Optional[torch.Tensor]]:
    return [t for lay in ops.layers for t in lay] + [ops.wp, ops.bp]


def _unflatten(flat, n_layers: int) -> EncoderOps:
    layers = tuple(LayerOps(*flat[N_LAYER_OPS * i:N_LAYER_OPS * (i + 1)])
                   for i in range(n_layers))
    return EncoderOps(layers, flat[N_LAYER_OPS * n_layers], flat[N_LAYER_OPS * n_layers + 1])


@torch.no_grad()
def update_running_stats(model, sums: Sequence[torch.Tensor], count: "int | torch.Tensor",
                         momentum: float = 0.9) -> None:
    """Fold full-batch pre-BN sums ([4, C_out] per layer) into the model's
    BatchNorm running statistics in place: keep `momentum` of the old value,
    add the rest of the batch mean and biased variance (flax's EMA; the
    counterpart of `updated_batch_stats`). An identity residual has no BN."""
    for i, s in enumerate(sums):
        lay = getattr(model.encoder, f"layer_{i}")
        sites = [(lay.tcn_bn, s[0], s[1])]
        if lay.residual_bn is not None:
            sites.append((lay.residual_bn, s[2], s[3]))
        for bn, total, total_sq in sites:
            mean = total / count
            var = torch.clamp(total_sq / count - mean * mean, min=0.0)
            bn.mean.mul_(momentum).add_((1.0 - momentum) * mean)
            bn.var.mul_(momentum).add_((1.0 - momentum) * var)


def fused_stse_apply(model, x: torch.Tensor, ghost_size: int = 32, momentum: float = 0.9,
                     compute_dtype: str = "float32", bwd_mode: str = "split") -> torch.Tensor:
    """Train-mode STSE encode with ghost BatchNorm: [B, C_in, T, V] -> z
    [B, latent], differentiable in the model's parameters. Updates the
    model's BN running statistics in place from the exact full-batch sums
    (in a sharded scope, `parallel/mesh.py`, the sums and the count summed
    over the ranks first). x gets no gradient (it is data). bwd_mode
    "split" keeps every layer's activations for K3/K4; "mono" keeps only x and recomputes them in K5.
    compute_dtype is one of COMPUTE_DTYPES (see the module's docstring);
    under a bf16 form x is rounded to bf16 here, as JAX casts x_t (:1152),
    and handed to the kernels as a bf16 tensor under "bfloat16"."""
    if bwd_mode not in ("split", "mono"):
        raise ValueError(f"unknown bwd_mode {bwd_mode!r}")
    bf16 = _dtype_index(compute_dtype) > 0
    b, c, t, v = x.shape
    if b % ghost_size:
        raise ValueError(f"batch {b} is not a multiple of ghost_size {ghost_size}")
    ops = encoder_ops(model)
    x_nodes = x.detach().permute(0, 2, 3, 1).reshape(b, t * v, c)
    if bf16:
        x_nodes = x_nodes.to(torch.bfloat16).to(activation_dtype(compute_dtype))
    x_nodes = x_nodes.contiguous()
    z, *sums = FusedGhostEncode.apply(x_nodes, ghost_size, len(ops.layers), bwd_mode,
                                      compute_dtype, *_flatten(ops))
    count = b * t * v
    if mesh.active() is not None:
        # a rank's block of the batch: the running statistics fold the global
        # batch's sums and count (JAX psums both, stse_train.py:1155-1171); the
        # ghost blocks stay the rank's own
        *sums, count = mesh.sum_each([*sums, sums[0].new_full((1,), float(count))],
                                     mesh.active().data_group)
    update_running_stats(model, sums, count, momentum)
    return z


def work(ops: EncoderOps, batch: int, ghost_size: int, compute_dtype: str = "float32") -> dict:
    """(FLOPs, bytes, product FLOPs, per-window FLOPs) that K2, each K3
    layer and K4 need for `batch` windows: every input read once and every
    output written once. The third is the share of the FLOPs in the
    batch-reduction products (`products`), the fourth the rest of K3's, K4's
    and K5's (graph contractions, dense products, dy = dz wp^T): both run on
    the tensor cores (3xTF32, or bf16 operands under a bf16 form). All of
    K2's FLOPs are per-window (g, t, r and the projector), on the tensor
    cores too: its third is 0, its fourth its first. Bytes count the input
    windows at 2 under a bf16 form (they are cast to bf16), activations, dy
    and dx at the store dtype (2 under "bfloat16"), the rest (weights,
    gradients, statistics, z, dz) at 4. K2 reads
    x and the weights and writes z, the activations, block statistics and
    sums. A layer's backward reads x, dy (K4: dz, its output and wp) and
    the weights, and writes dx (not for layer 0), the weight gradients.

    Also "K5", the mono backward: from x and dz alone, every layer's
    forward once (g, t, r; not the projector or the running sums) and its
    backward (dM, M dg, dW, dW_res, dg, dr W_res^T), then the projector's;
    it reads x, dz and the weights and writes the gradients. That is the
    split backward's count, which already holds g, t and r once. Layer 0
    computes no dx (the TPU's `_bwd_kernel` computes it and throws it away,
    :1104; the port's K5 skips it, so it is not counted)."""
    n = ops.layers[0].m.shape[0]
    latent = ops.wp.shape[1]
    nb = batch // ghost_size
    xb = 2.0 if _dtype_index(compute_dtype) > 0 else 4.0  # bytes of an input value
    ab = 2.0 if compute_dtype == "bfloat16" else 4.0  # of a stored activation, dy, dx
    prod = {}
    for pr in products(ops, batch):
        prod[pr["key"]] = prod.get(pr["key"], 0.0) + pr["flops"]
    out = {}
    mono_flops, mono_weights = 0.0, 0.0
    fwd_flops, fwd_bytes = 0.0, xb * batch * n * ops.layers[0].w.shape[0]
    for i, lay in enumerate(ops.layers):
        ci, co = lay.w.shape
        dense = 2.0 * n * ci * co * (1 if lay.identity else 2)
        weights = n * n + ci * co * (1 if lay.identity else 2) + 4 * co + 1
        fwd_flops += batch * (2.0 * n * n * ci + dense)
        fwd_bytes += 4.0 * (weights + nb * 4 * co + 4 * co) + ab * batch * n * co
        top = i == len(ops.layers) - 1
        need_dx = i > 0
        mm, res = 2.0 * n * ci * co, 0 if lay.identity else 1
        # g again, dM and (not on layer 0) M dg; t and r again, dW and dW_res,
        # dg = dt W^T and (not on layer 0) dr W_res^T
        flops = batch * (2.0 * n * n * ci * (3 if need_dx else 2)
                         + mm * (2 * (1 + res) + 1 + (res if need_dx else 0)))
        mono_flops += flops  # the forward once, then the backward: K5's too
        mono_weights += weights
        x_in = xb if i == 0 else ab
        nbytes = (x_in * batch * n * ci + (ab * batch * n * ci if need_dx else 0.0)
                  + 4.0 * (2 * weights + nb * 4 * co))
        if top:
            flops += batch * 2.0 * 2.0 * n * co * latent  # dy = dz wp^T and dwp
            nbytes += (4.0 * (batch * latent + 2 * n * co * latent + latent)
                       + ab * batch * n * co)
        else:
            nbytes += ab * batch * n * co  # dy
        key = "K4" if top else f"K3_layer{i}"
        out[key] = (flops, nbytes, prod[key], flops - prod[key])
    c_h = ops.layers[-1].w.shape[1]
    fwd_flops += batch * 2.0 * n * c_h * latent
    fwd_bytes += 4.0 * (n * c_h * latent + latent + batch * latent)
    out["K2"] = (fwd_flops, fwd_bytes, 0.0, fwd_flops)
    proj = n * c_h * latent + latent
    k5_flops = mono_flops + batch * 2.0 * 2.0 * n * c_h * latent
    out["K5"] = (k5_flops, xb * batch * n * ops.layers[0].w.shape[0]
                 + 4.0 * (batch * latent + 2 * (mono_weights + proj)),
                 sum(prod.values()), k5_flops - sum(prod.values()))
    return out
