"""Fused eval-mode STSE encoder: pose windows -> hidden state in one kernel.

Replaces the Pallas kernel `coskad_tpu/kernels/stse_fused.py::_kernel`
(driven by `fused_stse_forward`). With BatchNorm's running statistics folded
into the dense weights (`fold_stse_params`) and the two separable graph
contractions merged into one [T*V, T*V] matrix (`combined_graph_matrix`),
every layer of the STS-GCN stack is

    y = PReLU((M^T x) W + b + x W_res + b_res),

and the kernel runs all layers of a window with its activations held in
shared memory (`csrc/stse_fused.cu`, CUDA C++ for sm_90a, built by
`build.py` at first use, bound with ctypes). It writes the hidden state
node-major [B, T*V, C_hidden], the (T, V, C) order of the projector's
kernel, so the projector is one `torch.matmul` with the flax `btlnk.kernel`
unpermuted (the TPU version transposed the hidden state to [B, C, N] only
because Mosaic could not merge minor axes).

What bounds it on an H100: operations (~8.9 MFLOP per window at the
flagship width against ~58 KB of device memory traffic; see `work` and
PERF.md), which the kernel runs on the tensor cores as 3xTF32 `mma.sync`,
several windows a block, with M's k-slices staged in shared memory by
`cp.async`. The kernel's header says how.

The bf16 form (`stse_fused_bf16_kernel`, same source) is the eval encoder of
a model whose compute dtype is bf16, at the module path's rounding points
(`models/stsgcn.py`): BatchNorm folded as `dense_bn` folds it and rounded,
M rounded, then per layer x_r = bf16(x), G = bf16(M_r^T x_r), h =
bf16(bf16(G W) + b), res = x_r or bf16(bf16(x_r W_res) + b_res), y =
PReLU(bf16(h + res)) in float32 (`fused_stse_hidden_bf16_reference`). Its
products run on the bf16 `mma.sync` with float32 sums, one a product; its
output is the float32 hidden state, as the float32 form's. A folded or
packed weight set carries its form (`FoldedSTSE.dtype`,
`PackedSTSE.dtype`), and each function here takes the form it is given.

Either form runs any STS-GCN stack its planner takes: the encoder, and the
autoencoder's mirrored decoder (`fold_stse_params(prefix="decoder.")`,
channels 64 -> 32 -> 16 -> 32 -> 2 at the paper's widths), whose input is the
reverse projector's channel-major [B, H, T, V] and whose [B, T*V, 2] output
is the reconstruction, node-major.

Dispatch: each form is a custom op, `coskad_torch::stse_fused_hidden` and
`coskad_torch::stse_fused_hidden_bf16` (registered when this module is
imported; the library still builds at the first launch), so `torch.export`
can trace and serialize a program that calls it. Its CUDA implementation
launches the kernel or raises; its CPU implementation is the plain PyTorch
version on the same packed operand (`unpack_packed`). `fused_stse_hidden`
calls the op for a CUDA tensor and the plain version for a CPU tensor.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from dataclasses import dataclass
from typing import List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.profiling import LaunchCounter

SOURCE = "coskad_tpu_torch/kernels/csrc/stse_fused.cu"
REPLACES = "coskad_tpu/kernels/stse_fused.py:125"
_LAYOUT_COLS = 8  # ci, co, identity, off_m, off_w, off_wr, off_b, off_alpha
_OCCUPANCY = ("windows_per_block", "smem_bytes", "blocks_per_sm")


launches = LaunchCounter()  # both forms, both stacks
bf16_launches = LaunchCounter()  # the bf16 form's alone
decoder_launches = LaunchCounter()  # of `launches`, the decoder stack's (`STSAE.k1_decode`)
# a model's launch plan for a stack (`models/stse.py::_Plan`), both forms,
# both stacks: reused, and built (folded and packed) anew
plan_hits = LaunchCounter()
plan_builds = LaunchCounter()


class FoldedLayer(NamedTuple):
    graph: torch.Tensor  # [T*V, T*V] combined space-time contraction matrix
    w: torch.Tensor  # [C_in, C_out] with BN folded
    b: torch.Tensor  # [C_out]
    w_res: torch.Tensor  # [C_in, C_out] residual (identity if C_in == C_out)
    b_res: torch.Tensor  # [C_out]
    alpha: torch.Tensor  # [] PReLU slope


class FoldedSTSE(NamedTuple):
    layers: List[FoldedLayer]
    # the linear projector, None for another (an MLP head runs after the
    # kernel as a module) and in the bf16 form (the model's own rounding
    # projector runs after it): [T*V*C_hidden, latent] in (t, v, c) order
    w_proj: Optional[torch.Tensor]
    b_proj: Optional[torch.Tensor]  # [latent]
    # the form: float32, or bfloat16 (every tensor a bf16 value held in
    # float32 but the slope, rounded as the module path rounds it)
    dtype: torch.dtype = torch.float32


@dataclass(frozen=True)
class PackedSTSE:
    """The kernel's weight set: one contiguous float32 buffer on the device
    plus a host table of per-layer sizes and offsets; the bf16 form's M^T
    and W^T segments hold bf16 values, two a float. It does not change once
    built, so its op and the op's arguments are made once (`op`,
    `op_args`)."""

    weights: torch.Tensor  # flat float32, every segment 16-byte aligned
    layout: np.ndarray  # [n_layers, 8] int64, see _LAYOUT_COLS
    n_nodes: int
    n_pad: int  # T*V rounded up to 16: M is [n_pad, n_pad]
    dtype: torch.dtype = torch.float32  # the form, as FoldedSTSE's

    @functools.cached_property
    def op(self):
        """The form's custom op under `torch.ops.coskad_torch`, its one
        overload."""
        name = "stse_fused_hidden_bf16" if self.dtype == torch.bfloat16 else "stse_fused_hidden"
        return getattr(torch.ops.coskad_torch, name).default

    @functools.cached_property
    def op_args(self) -> Tuple[torch.Tensor, List[int], int, int]:
        """The custom op's arguments after x: (weights, layout flat as a
        list of ints, n_nodes, n_pad), built once."""
        return self.weights, self.layout.ravel().tolist(), self.n_nodes, self.n_pad


def _fold_dense_bn(state: Mapping[str, torch.Tensor], dense: str, bn: str,
                   eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    kernel = state[f"{dense}.kernel"]
    bias = state.get(f"{dense}.bias")
    scale = state[f"{bn}.scale"] / torch.sqrt(state[f"{bn}.var"] + eps)
    w = kernel * scale[None, :]
    b = ((0.0 if bias is None else bias) - state[f"{bn}.mean"]) * scale
    return w, b + state[f"{bn}.bias"]


def rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to `dtype` (round to nearest even) and held in x's own
    dtype: the JAX package's `x.astype(dtype)` as a rounding point. Autograd
    rounds the gradient at the same point, as JAX's cast rounds its
    cotangent. The identity where `dtype` is float32."""
    if dtype == torch.float32:
        return x
    return x.to(dtype).to(x.dtype)


def fold_dense_bn(kernel: torch.Tensor, bias: Optional[torch.Tensor], scale: torch.Tensor,
                  shift: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                  dtype: torch.dtype, eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """BatchNorm's running statistics folded into a dense layer as the
    module path folds them (`models/stsgcn.py::dense_bn`, JAX's
    `_moment_dense_bn(use_running=True)`): w = kernel * scale * rsqrt(var +
    eps), b = (bias - mean) * that + shift, each rounded to `dtype`.
    Differentiable; the bf16 form's fold, so its weights are the module
    path's bits."""
    inv = scale * torch.rsqrt(var + eps)
    w = rounded(kernel * inv[None, :], dtype)
    b = rounded(((0.0 if bias is None else bias) - mean) * inv + shift, dtype)
    return w, b


def combined_graph_matrix(t_adj: torch.Tensor, a_adj: torch.Tensor) -> torch.Tensor:
    """Fuse the temporal [V, T, T] and spatial [T, V, V] contractions into one
    [T*V, T*V] matrix, node order n = t*V + v:
    M[(t, v), (q, w)] = T[v, t, q] * A[q, v, w]."""
    v, t, _ = t_adj.shape
    return torch.einsum("vtq,qvw->tvqw", t_adj, a_adj).reshape(t * v, t * v)


def _fold_rounded(state: Mapping[str, torch.Tensor], dense: str, bn: str,
                  dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    return fold_dense_bn(state[f"{dense}.kernel"], state.get(f"{dense}.bias"),
                         state[f"{bn}.scale"], state[f"{bn}.bias"], state[f"{bn}.mean"],
                         state[f"{bn}.var"], dtype)


def fold_stse_params(state: Mapping[str, torch.Tensor],
                     dtype: torch.dtype = torch.float32, prefix: str = "encoder.") -> FoldedSTSE:
    """Fold an STS-GCN stack of a model's state (`state_dict()` names, which
    are the flax variable paths joined by '.') into the kernel's weight set
    of the form `dtype`. `prefix` names the stack: "encoder." (an STSE's)
    or "decoder." (an STSAE's or STSVAE's mirrored stack, whose layers are
    the encoder's `STSGCNLayer`). At float32 the encoder's linear projector
    (`btlnk.kernel`) is carried along; with any other projector, for the
    decoder and at bfloat16 w_proj / b_proj are None. At bfloat16 the
    weights are the module path's own, rounded as it rounds them
    (`fold_dense_bn`, M rounded)."""
    bf16 = dtype == torch.bfloat16
    layers = []
    i = 0
    while f"{prefix}layer_{i}.gcn.t_adj" in state:
        pre = f"{prefix}layer_{i}"
        fold = ((lambda d, n: _fold_rounded(state, d, n, dtype)) if bf16
                else (lambda d, n: _fold_dense_bn(state, d, n)))
        w, b = fold(f"{pre}.tcn_dense", f"{pre}.tcn_bn")
        if f"{pre}.residual_dense.kernel" in state:
            w_res, b_res = fold(f"{pre}.residual_dense", f"{pre}.residual_bn")
        else:
            w_res = torch.eye(*w.shape, dtype=w.dtype, device=w.device)
            b_res = torch.zeros_like(b)
        graph = rounded(combined_graph_matrix(state[f"{pre}.gcn.t_adj"],
                                              state[f"{pre}.gcn.a_adj"]), dtype)
        layers.append(FoldedLayer(graph, w, b, w_res, b_res, state[f"{pre}.prelu.alpha"]))
        i += 1
    if not layers:
        raise ValueError(f"state holds no {prefix}layer_0: not an STS-GCN stack")
    if bf16:
        return FoldedSTSE(layers, None, None, torch.bfloat16)
    w_proj = state.get("btlnk.kernel") if prefix == "encoder." else None
    if w_proj is None:
        return FoldedSTSE(layers, None, None)
    b_proj = state.get("btlnk.bias")
    if b_proj is None:
        b_proj = torch.zeros(w_proj.shape[1], dtype=w_proj.dtype, device=w_proj.device)
    return FoldedSTSE(layers, w_proj, b_proj)


def _projector(folded: FoldedSTSE) -> Tuple[torch.Tensor, torch.Tensor]:
    if folded.dtype == torch.bfloat16:
        raise ValueError("the bf16 form carries no projector: run fused_stse_hidden and "
                         "the model's own (rounding) projector")
    if folded.w_proj is None:
        raise ValueError("the folded weights carry no linear projector: run "
                         "fused_stse_hidden and the model's own projector")
    flat = folded.layers[0].graph.shape[0] * folded.layers[-1].w.shape[1]
    if folded.w_proj.shape[0] != flat:
        # a model rank's block of rows (`parallel/mesh.py::shard_model`)
        raise ValueError(f"the folded projector has {folded.w_proj.shape[0]} of the hidden "
                         f"state's {flat} rows, a model-parallel shard: run "
                         "fused_stse_hidden and the model's own (split) projector")
    return folded.w_proj, folded.b_proj


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


class _Segments:
    """A packed operand's float32 buffer as it is laid out: every segment
    starts on 16 bytes (a multiple of four floats), zeros between; a bf16
    tensor of an even count goes in two values a float, the lower index in
    the low half (`Tensor.view`)."""

    def __init__(self, ref: torch.Tensor):
        self.ref, self.parts, self.off = ref, [], 0

    def put(self, t: torch.Tensor) -> int:
        flat = t.reshape(-1)
        if flat.dtype == torch.bfloat16:
            flat = flat.view(torch.float32)
        start, self.off = self.off, self.off + _round_up(flat.numel(), 4)
        self.parts += [flat, self.ref.new_zeros(self.off - start - flat.numel())]
        return start

    def weights(self) -> torch.Tensor:
        return torch.cat(self.parts).to(torch.float32).contiguous()


def _is_identity(lay: FoldedLayer) -> bool:
    ci, co = lay.w.shape
    return ci == co and torch.equal(
        lay.w_res, torch.eye(ci, dtype=lay.w_res.dtype, device=lay.w_res.device))


def pack_folded(folded: FoldedSTSE) -> PackedSTSE:
    """Lay the folded weights out for the kernel: per layer M padded to
    [NP, NP] (NP = T*V rounded up to 16, the kernel's node tile), W and
    W_res padded to [CI8, CO8] (channels rounded up to 8, the mma's k and
    n), one bias b + b_res [CO8], the PReLU slope, and whether the residual
    is the identity (W_res = I, which the kernel adds as x). Padding is
    zeros, so padded nodes and channels never reach a valid output. Every
    segment starts on 16 bytes, for the kernel's cp.async copies of M.

    After the last layer's segments a tail the kernel never reads holds
    each layer's b and b_res apart (the kernel adds their sum), so that
    `unpack_packed` gives the folded weights back exactly.

    The bf16 form packs its own layout (`_pack_bf16`)."""
    if folded.dtype == torch.bfloat16:
        return _pack_bf16(folded)
    n = folded.layers[0].graph.shape[0]
    npad = _round_up(n, 16)
    ref = folded.layers[0].w
    buf, rows = _Segments(ref), []
    put = buf.put
    for lay in folded.layers:
        ci, co = lay.w.shape
        ci8, co8 = _round_up(ci, 8), _round_up(co, 8)
        m = ref.new_zeros(npad, npad)
        m[:n, :n] = lay.graph
        w = ref.new_zeros(ci8, co8)
        w[:ci, :co] = lay.w
        wr = ref.new_zeros(ci8, co8)
        wr[:ci, :co] = lay.w_res
        bias = ref.new_zeros(co8)
        bias[:co] = lay.b + lay.b_res
        rows.append([ci, co, int(_is_identity(lay)), put(m), put(w), put(wr), put(bias),
                     put(lay.alpha.reshape(1).to(ref.dtype))])
    for lay in folded.layers:
        put(lay.b)
        put(lay.b_res)
    return PackedSTSE(buf.weights(), np.asarray(rows, np.int64), n, npad)


def _pack_bf16(folded: FoldedSTSE) -> PackedSTSE:
    """The bf16 form's layout, the same table's columns: per layer M_r^T
    bf16 [NP, NP] (row m holds M_r[:, m]: the graph product's A operand,
    pairs along k one 32-bit load), W^T and W_res^T bf16 [CO8, CI16] (the
    mixes' B operands; C_out rounded up to 8, C_in to 16), b and b_res
    float32 [CO8] each at off_b and off_b + CO8 (kept apart: the kernel
    rounds each sum), the slope float32. Padding is zeros; the bf16
    segments sit in the float32 buffer two values a float (`_Segments`)."""
    n = folded.layers[0].graph.shape[0]
    npad = _round_up(n, 16)
    ref = folded.layers[0].w
    buf, rows = _Segments(ref), []
    put = buf.put

    def bf16_matrix(t: torch.Tensor, r: int, c: int) -> torch.Tensor:
        out = torch.zeros(r, c, dtype=torch.bfloat16, device=ref.device)
        out[:t.shape[0], :t.shape[1]] = t.to(torch.bfloat16)
        return out

    for lay in folded.layers:
        ci, co = lay.w.shape
        co8, ci16 = _round_up(co, 8), _round_up(ci, 16)
        bias = ref.new_zeros(2 * co8)
        bias[:co] = lay.b
        bias[co8:co8 + co] = lay.b_res
        rows.append([ci, co, int(_is_identity(lay)), put(bf16_matrix(lay.graph.t(), npad, npad)),
                     put(bf16_matrix(lay.w.t(), co8, ci16)),
                     put(bf16_matrix(lay.w_res.t(), co8, ci16)), put(bias),
                     put(lay.alpha.reshape(1).to(ref.dtype))])
    return PackedSTSE(buf.weights(), np.asarray(rows, np.int64), n, npad, torch.bfloat16)


def unpack_packed_bf16(weights: torch.Tensor, layout, n_nodes: int, n_pad: int) -> FoldedSTSE:
    """The folded weights a bf16 packed operand holds (the inverse of
    `_pack_bf16`), float32 tensors of bf16 values on the operand's device."""
    lay = np.asarray(layout, np.int64).reshape(-1, _LAYOUT_COLS)

    def bf16_seg(off: int, r: int, c: int) -> torch.Tensor:
        return weights[off:off + r * c // 2].view(torch.bfloat16).reshape(r, c).float()

    layers = []
    for ci, co, _, off_mt, off_wt, off_wrt, off_b, off_alpha in (map(int, row) for row in lay):
        co8, ci16 = _round_up(co, 8), _round_up(ci, 16)
        layers.append(FoldedLayer(
            graph=bf16_seg(off_mt, n_pad, n_pad)[:n_nodes, :n_nodes].t().contiguous(),
            w=bf16_seg(off_wt, co8, ci16)[:co, :ci].t().contiguous(),
            b=weights[off_b:off_b + co].contiguous(),
            w_res=bf16_seg(off_wrt, co8, ci16)[:co, :ci].t().contiguous(),
            b_res=weights[off_b + co8:off_b + co8 + co].contiguous(),
            alpha=weights[off_alpha].contiguous()))
    return FoldedSTSE(layers, None, None, torch.bfloat16)


def unpack_packed(weights: torch.Tensor, layout, n_nodes: int, n_pad: int) -> FoldedSTSE:
    """The folded weights a packed operand holds (the inverse of
    `pack_folded`; `layout` as an array or flat list): each layer's graph,
    W, W_res, b, b_res and slope, as contiguous float32 tensors on the
    operand's device. The projector is not part of the operand: w_proj and
    b_proj are None."""
    lay = np.asarray(layout, np.int64).reshape(-1, _LAYOUT_COLS)

    def seg(off: int, *shape: int) -> torch.Tensor:
        size = int(np.prod(shape))
        return weights[off:off + size].reshape(shape)

    tail = int(lay[-1, 7]) + _round_up(1, 4)  # after the last layer's slope
    layers = []
    for ci, co, _, off_m, off_w, off_wr, _, off_alpha in (map(int, row) for row in lay):
        ci8, co8 = _round_up(ci, 8), _round_up(co, 8)
        b = seg(tail, co)
        b_res = seg(tail + _round_up(co, 4), co)
        tail += 2 * _round_up(co, 4)
        layers.append(FoldedLayer(
            graph=seg(off_m, n_pad, n_pad)[:n_nodes, :n_nodes].contiguous(),
            w=seg(off_w, ci8, co8)[:ci, :co].contiguous(),
            b=b.contiguous(),
            w_res=seg(off_wr, ci8, co8)[:ci, :co].contiguous(),
            b_res=b_res.contiguous(),
            alpha=seg(off_alpha, 1).reshape(()).contiguous()))
    return FoldedSTSE(layers, None, None)


def fused_stse_hidden_reference(x: torch.Tensor, folded: FoldedSTSE) -> torch.Tensor:
    """Plain PyTorch version of the kernel: [B, C, T, V] -> [B, T*V, C_hidden]."""
    b, c, t, v = x.shape
    h = x.permute(0, 2, 3, 1).reshape(b, t * v, c)
    for lay in folded.layers:
        res = h @ lay.w_res + lay.b_res
        g = torch.einsum("bnc,nm->bmc", h, lay.graph)
        y = g @ lay.w + lay.b + res
        h = torch.where(y >= 0, y, lay.alpha * y)
    return h


def fused_stse_hidden_bf16_reference(x: torch.Tensor, folded: FoldedSTSE) -> torch.Tensor:
    """Plain PyTorch version of the bf16 form, the module path's operations
    and rounding points (`STSGCNLayer.forward` in eval mode): [B, C, T, V]
    float32 -> [B, T*V, C_hidden] float32."""
    bf16 = torch.bfloat16
    b, c, t, v = x.shape
    h = x.permute(0, 2, 3, 1).reshape(b, t * v, c)
    for lay in folded.layers:
        xr = rounded(h, bf16)
        g = rounded(torch.einsum("bnc,nm->bmc", xr, lay.graph), bf16)
        out = rounded(rounded(g @ lay.w, bf16) + lay.b, bf16)
        res = rounded(rounded(xr @ lay.w_res, bf16) + lay.b_res, bf16)
        y = rounded(out + res, bf16)
        h = torch.where(y >= 0, y, lay.alpha * y)
    return h


def fused_stse_forward_reference(x: torch.Tensor, folded: FoldedSTSE) -> torch.Tensor:
    """Plain PyTorch version of the whole fused forward: [B, C, T, V] -> [B, latent]."""
    w_proj, b_proj = _projector(folded)
    h = fused_stse_hidden_reference(x, folded)
    return h.reshape(h.shape[0], -1) @ w_proj + b_proj


def bind(lib):
    """Set the argument and return types of the kernel library's C entries
    (the built library, or the host emulation's); returns `lib`."""
    lib.stse_fused_forward.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.stse_fused_forward.restype = ctypes.c_int
    lib.stse_fused_occupancy.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_void_p]
    lib.stse_fused_occupancy.restype = ctypes.c_int
    lib.stse_fused_plan.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]
    lib.stse_fused_plan.restype = ctypes.c_int
    lib.stse_fused_bf16_forward.argtypes = lib.stse_fused_forward.argtypes
    lib.stse_fused_bf16_forward.restype = ctypes.c_int
    lib.stse_fused_bf16_occupancy.argtypes = lib.stse_fused_occupancy.argtypes
    lib.stse_fused_bf16_occupancy.restype = ctypes.c_int
    lib.stse_fused_bf16_plan.argtypes = lib.stse_fused_plan.argtypes
    lib.stse_fused_bf16_plan.restype = ctypes.c_int
    lib.stse_fused_error_string.argtypes = [ctypes.c_int]
    lib.stse_fused_error_string.restype = ctypes.c_char_p
    return lib


def _library():
    from . import build

    return build.load("stse_fused", bind)


def _entry(lib, bf16: bool, name: str):
    """The library's C entry `name` of the form (stse_fused_<name>, or
    stse_fused_bf16_<name> for `bf16`)."""
    return getattr(lib, ("stse_fused_bf16_" if bf16 else "stse_fused_") + name)


def takes(packed: PackedSTSE, lib=None) -> bool:
    """Whether the kernel of `packed`'s form takes its layout, from the
    planner every launch runs (`plan_layout` or `bf16_plan_layout` in the
    source, through `stse_fused_plan` or `stse_fused_bf16_plan`; `lib`
    defaults to the built library). The float32 form refuses more than 8
    layers, a graph contraction wider than 64 channels or an inner layer
    putting out more, and activations that do not fit in a block's shared
    memory (at 18 joints, windows of more than 27 frames); the bf16 form
    more than 8 layers, a layer taking more than 64 channels, and
    activations past a block's shared memory at one window. No device is
    touched."""
    lib = _library() if lib is None else lib
    layout = np.ascontiguousarray(packed.layout, np.int64)
    out = np.zeros(2, np.int32)
    plan = _entry(lib, packed.dtype == torch.bfloat16, "plan")
    return plan(layout.ctypes.data, len(layout), packed.n_nodes, packed.n_pad,
                out.ctypes.data) == 0


def occupancy(packed: PackedSTSE, lib=None) -> dict:
    """What a launch on `packed` uses, from `lib` (default: the built
    library on the current device): windows a block, shared bytes a block
    and blocks an SM (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`);
    for the bf16 form also threads a block."""
    lib = _library() if lib is None else lib
    layout = np.ascontiguousarray(packed.layout, np.int64)
    keys = _OCCUPANCY + (("threads",) if packed.dtype == torch.bfloat16 else ())
    out = np.zeros(len(keys), np.int32)
    err = _entry(lib, packed.dtype == torch.bfloat16, "occupancy")(
        layout.ctypes.data, len(layout), packed.n_nodes, packed.n_pad, out.ctypes.data)
    if err != 0:
        raise RuntimeError(
            f"stse_fused_occupancy failed: {lib.stse_fused_error_string(err).decode()}")
    return {k: int(v) for k, v in zip(keys, out)}


class _Layout(NamedTuple):
    """A flat layout as the C entries take it, and what `_launch` reads of
    it."""

    array: np.ndarray  # [n_layers, 8] int64, contiguous
    pointer: int  # the array's data, for ctypes
    c_in: int  # the first layer's C_in
    c_out: int  # the last layer's C_out


@functools.lru_cache(maxsize=64)
def _layout(flat: Tuple[int, ...]) -> _Layout:
    """The layout `flat` (`PackedSTSE.op_args`' list, as a tuple), made
    once a layout: the op is handed a new list each call."""
    if not flat or len(flat) % _LAYOUT_COLS:
        raise ValueError(f"a layout is rows of {_LAYOUT_COLS} ints, not {len(flat)} ints")
    array = np.array(flat, np.int64).reshape(-1, _LAYOUT_COLS)
    return _Layout(array, array.ctypes.data, int(array[0, 0]), int(array[-1, 1]))


def _launch(x: torch.Tensor, weights: torch.Tensor, layout: Sequence[int], n_nodes: int,
            n_pad: int, bf16: bool) -> torch.Tensor:
    """The kernel of the form (`bf16`) on x, the custom ops' CUDA body. It
    checks what a caller can get wrong: x contiguous float32 [B, C_in, T,
    V] with T*V the layout's nodes, the weights float32, 16-byte aligned
    and on x's device. The layout's limits are the planner's, which the C
    entry runs on every launch: a refused layout raises with its message.
    The launch switches the current device only where x is on another."""
    lay = _layout(tuple(layout))
    b, c, t, v = x.shape
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("the stse_fused kernel takes a contiguous float32 [B, C, T, V]")
    if c != lay.c_in or t * v != n_nodes:
        raise ValueError(
            f"input [B, {c}, {t}, {v}] does not match the packed weights "
            f"(C_in {lay.c_in}, T*V {n_nodes})")
    if weights.device != x.device or weights.dtype != torch.float32 or weights.data_ptr() % 16:
        raise ValueError("packed weights must be 16-byte aligned float32 on the input's device")
    out = torch.empty((b, n_nodes, lay.c_out), dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    lib = _library()
    forward = _entry(lib, bf16, "forward")
    elsewhere = x.device.index != torch.cuda.current_device()
    with torch.cuda.device(x.device) if elsewhere else contextlib.nullcontext():
        err = forward(x.data_ptr(), weights.data_ptr(), lay.pointer, len(lay.array), b, n_nodes,
                      n_pad, out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"stse_fused kernel launch failed: {lib.stse_fused_error_string(err).decode()}")
    launches.value += 1
    if bf16:
        bf16_launches.value += 1
    return out


@torch.library.custom_op(
    "coskad_torch::stse_fused_hidden", mutates_args=(), device_types="cuda",
    schema="(Tensor x, Tensor weights, int[] layout, int n_nodes, int n_pad) -> Tensor")
def stse_fused_hidden_op(x, weights, layout, n_nodes, n_pad):
    """K1 as a custom op: [B, C, T, V] windows and a packed operand
    (`PackedSTSE.op_args`) -> hidden state [B, n_nodes, C_hidden] float32.
    On CUDA it launches the kernel, with every check of `_launch`."""
    return _launch(x, weights, layout, n_nodes, n_pad, False)


@stse_fused_hidden_op.register_kernel("cpu")
def _stse_fused_hidden_cpu(x, weights, layout, n_nodes, n_pad):
    return fused_stse_hidden_reference(x, unpack_packed(weights, layout, n_nodes, n_pad))


@stse_fused_hidden_op.register_fake
def _stse_fused_hidden_fake(x, weights, layout, n_nodes, n_pad):
    c_out = layout[len(layout) - _LAYOUT_COLS + 1]  # the last layer's C_out
    return x.new_empty((x.shape[0], n_nodes, c_out), dtype=torch.float32)


@torch.library.custom_op(
    "coskad_torch::stse_fused_hidden_bf16", mutates_args=(), device_types="cuda",
    schema="(Tensor x, Tensor weights, int[] layout, int n_nodes, int n_pad) -> Tensor")
def stse_fused_hidden_bf16_op(x, weights, layout, n_nodes, n_pad):
    """K1's bf16 form as a custom op: [B, C, T, V] float32 windows and a
    bf16 packed operand -> hidden state [B, n_nodes, C_hidden] float32."""
    return _launch(x, weights, layout, n_nodes, n_pad, True)


@stse_fused_hidden_bf16_op.register_kernel("cpu")
def _stse_fused_hidden_bf16_cpu(x, weights, layout, n_nodes, n_pad):
    return fused_stse_hidden_bf16_reference(
        x, unpack_packed_bf16(weights, layout, n_nodes, n_pad))


stse_fused_hidden_bf16_op.register_fake(_stse_fused_hidden_fake)


def fused_stse_hidden(x: torch.Tensor, folded: FoldedSTSE,
                      packed: Optional[PackedSTSE] = None) -> torch.Tensor:
    """[B, C, T, V] windows -> hidden state [B, T*V, C_hidden], in the form
    of `folded` (float32 or bf16).

    A CUDA tensor launches the kernel through the form's custom op (with
    `packed`, or the weights packed now); a CPU tensor takes the plain
    version."""
    if x.is_cuda:
        packed = packed if packed is not None else pack_folded(folded)
        return packed.op(x, *packed.op_args)
    if x.device.type != "cpu":
        raise ValueError(f"stse_fused runs on CUDA or CPU tensors, not {x.device}")
    if folded.dtype == torch.bfloat16:
        return fused_stse_hidden_bf16_reference(x, folded)
    return fused_stse_hidden_reference(x, folded)


def fused_stse_forward(x: torch.Tensor, folded: FoldedSTSE,
                       packed: Optional[PackedSTSE] = None) -> torch.Tensor:
    """[B, C, T, V] windows -> [B, latent] latents: the fused encoder, then
    the projector as one matmul."""
    w_proj, b_proj = _projector(folded)
    h = fused_stse_hidden(x, folded, packed)
    return h.reshape(h.shape[0], -1) @ w_proj + b_proj


def work(folded: FoldedSTSE, batch: int) -> Tuple[float, float]:
    """(FLOPs, bytes) the kernel's function needs for `batch` windows: per
    layer the graph contraction 2*N^2*min(C_in, C_out) (a narrowing layer
    contracts x W rather than x) and the two denses 2*N*C_in*C_out each; the
    input read once, the hidden state written once, the folded weights read
    once. The kernel runs every one of these FLOPs on the tensor cores as
    3xTF32 (three TF32 products for each). The bf16 form's (`work_bf16`)
    differ."""
    if folded.dtype == torch.bfloat16:
        return work_bf16(folded, batch)
    n = folded.layers[0].graph.shape[0]
    flops = 0.0
    weight_elems = 0
    for lay in folded.layers:
        ci, co = lay.w.shape
        flops += 2.0 * n * n * min(ci, co) + 2.0 * 2.0 * n * ci * co
        weight_elems += n * n + 2 * ci * co + 2 * co + 1
    c_in = folded.layers[0].w.shape[0]
    c_out = folded.layers[-1].w.shape[1]
    nbytes = 4.0 * (batch * n * (c_in + c_out) + weight_elems)
    return batch * flops, nbytes


def work_bf16(folded: FoldedSTSE, batch: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of the bf16 form for `batch` windows: per layer the
    graph contraction 2*N^2*C_in (not reassociated), the dense 2*N*C_in*C_out
    and the residual dense as much again where it is not the identity, each
    product one bf16 mma; the float32 input read once, the float32 hidden
    state written once, M and the dense weights read once at bf16, the
    biases and slopes at float32."""
    n = folded.layers[0].graph.shape[0]
    flops, nbytes = 0.0, 0.0
    for lay in folded.layers:
        ci, co = lay.w.shape
        denses = 1 if _is_identity(lay) else 2
        flops += 2.0 * n * n * ci + 2.0 * n * ci * co * denses
        nbytes += 2.0 * (n * n + ci * co * denses) + 4.0 * (2 * co + 1)
    c_in = folded.layers[0].w.shape[0]
    c_out = folded.layers[-1].w.shape[1]
    return batch * flops, nbytes + 4.0 * batch * n * (c_in + c_out)
