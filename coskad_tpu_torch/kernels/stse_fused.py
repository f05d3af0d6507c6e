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

Dispatch: a CUDA tensor launches the kernel or raises; a CPU tensor takes
the plain PyTorch version (`fused_stse_hidden_reference`).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

SOURCE = "coskad_tpu_torch/kernels/csrc/stse_fused.cu"
REPLACES = "coskad_tpu/kernels/stse_fused.py:125"
_LAYOUT_COLS = 8  # ci, co, identity, off_m, off_w, off_wr, off_b, off_alpha
_OCCUPANCY = ("windows_per_block", "smem_bytes", "blocks_per_sm")


class LaunchCounter:
    """Counts kernel launches, so a run can show its path went through the
    kernel. Only a wrapper's CUDA branch adds to it."""

    def __init__(self):
        self.value = 0


launches = LaunchCounter()


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
    # kernel as a module): [T*V*C_hidden, latent] in (t, v, c) flatten order
    w_proj: Optional[torch.Tensor]
    b_proj: Optional[torch.Tensor]  # [latent]


@dataclass
class PackedSTSE:
    """The kernel's weight set: one contiguous float32 buffer on the device
    plus a host table of per-layer sizes and offsets."""

    weights: torch.Tensor  # flat float32, every segment 16-byte aligned
    layout: np.ndarray  # [n_layers, 8] int64, see _LAYOUT_COLS
    n_nodes: int
    n_pad: int  # T*V rounded up to 16: M is [n_pad, n_pad]


def _fold_dense_bn(state: Mapping[str, torch.Tensor], dense: str, bn: str,
                   eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    kernel = state[f"{dense}.kernel"]
    bias = state.get(f"{dense}.bias")
    scale = state[f"{bn}.scale"] / torch.sqrt(state[f"{bn}.var"] + eps)
    w = kernel * scale[None, :]
    b = ((0.0 if bias is None else bias) - state[f"{bn}.mean"]) * scale
    return w, b + state[f"{bn}.bias"]


def combined_graph_matrix(t_adj: torch.Tensor, a_adj: torch.Tensor) -> torch.Tensor:
    """Fuse the temporal [V, T, T] and spatial [T, V, V] contractions into one
    [T*V, T*V] matrix, node order n = t*V + v:
    M[(t, v), (q, w)] = T[v, t, q] * A[q, v, w]."""
    v, t, _ = t_adj.shape
    return torch.einsum("vtq,qvw->tvqw", t_adj, a_adj).reshape(t * v, t * v)


def fold_stse_params(state: Mapping[str, torch.Tensor]) -> FoldedSTSE:
    """Fold an STSE's state (`STSE.state_dict()` names, which are the flax
    variable paths joined by '.') into the kernel's weight set. The linear
    projector (`btlnk.kernel`) is carried along; with any other projector
    the encoder is folded alone and w_proj / b_proj are None."""
    layers = []
    i = 0
    while f"encoder.layer_{i}.gcn.t_adj" in state:
        pre = f"encoder.layer_{i}"
        w, b = _fold_dense_bn(state, f"{pre}.tcn_dense", f"{pre}.tcn_bn")
        if f"{pre}.residual_dense.kernel" in state:
            w_res, b_res = _fold_dense_bn(
                state, f"{pre}.residual_dense", f"{pre}.residual_bn")
        else:
            w_res = torch.eye(*w.shape, dtype=w.dtype, device=w.device)
            b_res = torch.zeros_like(b)
        graph = combined_graph_matrix(state[f"{pre}.gcn.t_adj"], state[f"{pre}.gcn.a_adj"])
        layers.append(FoldedLayer(graph, w, b, w_res, b_res, state[f"{pre}.prelu.alpha"]))
        i += 1
    if not layers:
        raise ValueError("state holds no encoder.layer_0: not an STS-GCN STSE")
    w_proj = state.get("btlnk.kernel")
    if w_proj is None:
        return FoldedSTSE(layers, None, None)
    b_proj = state.get("btlnk.bias")
    if b_proj is None:
        b_proj = torch.zeros(w_proj.shape[1], dtype=w_proj.dtype, device=w_proj.device)
    return FoldedSTSE(layers, w_proj, b_proj)


def _projector(folded: FoldedSTSE) -> Tuple[torch.Tensor, torch.Tensor]:
    if folded.w_proj is None:
        raise ValueError("the folded weights carry no linear projector: run "
                         "fused_stse_hidden and the model's own projector")
    return folded.w_proj, folded.b_proj


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def pack_folded(folded: FoldedSTSE) -> PackedSTSE:
    """Lay the folded weights out for the kernel: per layer M padded to
    [NP, NP] (NP = T*V rounded up to 16, the kernel's node tile), W and
    W_res padded to [CI8, CO8] (channels rounded up to 8, the mma's k and
    n), one bias b + b_res [CO8], the PReLU slope, and whether the residual
    is the identity (W_res = I, which the kernel adds as x). Padding is
    zeros, so padded nodes and channels never reach a valid output. Every
    segment starts on 16 bytes, for the kernel's cp.async copies of M."""
    n = folded.layers[0].graph.shape[0]
    npad = _round_up(n, 16)
    ref = folded.layers[0].w
    segments, rows, off = [], [], 0

    def put(t: torch.Tensor) -> int:
        nonlocal off
        start = off
        segments.append(t.reshape(-1))
        off += _round_up(t.numel(), 4)
        if off > start + t.numel():
            segments.append(ref.new_zeros(off - start - t.numel()))
        return start

    for lay in folded.layers:
        ci, co = lay.w.shape
        ci8, co8 = _round_up(ci, 8), _round_up(co, 8)
        identity = ci == co and torch.equal(
            lay.w_res, torch.eye(ci, dtype=lay.w_res.dtype, device=lay.w_res.device))
        m = ref.new_zeros(npad, npad)
        m[:n, :n] = lay.graph
        w = ref.new_zeros(ci8, co8)
        w[:ci, :co] = lay.w
        wr = ref.new_zeros(ci8, co8)
        wr[:ci, :co] = lay.w_res
        bias = ref.new_zeros(co8)
        bias[:co] = lay.b + lay.b_res
        rows.append([ci, co, int(identity), put(m), put(w), put(wr), put(bias),
                     put(lay.alpha.reshape(1).to(ref.dtype))])
    weights = torch.cat(segments).to(torch.float32).contiguous()
    return PackedSTSE(weights, np.asarray(rows, np.int64), n, npad)


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
    lib.stse_fused_error_string.argtypes = [ctypes.c_int]
    lib.stse_fused_error_string.restype = ctypes.c_char_p
    return lib


def _library():
    from . import build

    lib = build.load("stse_fused")
    if not getattr(lib, "_coskad_typed", False):
        bind(lib)
        lib._coskad_typed = True
    return lib


def takes(packed: PackedSTSE, lib=None) -> bool:
    """Whether the kernel takes `packed`'s layout, from the planner every
    launch runs (`plan_layout` in the source, through `stse_fused_plan`;
    `lib` defaults to the built library). It refuses more than 8 layers, a
    graph contraction wider than 64 channels or an inner layer putting out
    more, and activations that do not fit in a block's shared memory (at 18
    joints, windows of more than 27 frames). No device is touched."""
    lib = _library() if lib is None else lib
    layout = np.ascontiguousarray(packed.layout, np.int64)
    out = np.zeros(2, np.int32)
    return lib.stse_fused_plan(layout.ctypes.data, len(layout), packed.n_nodes, packed.n_pad,
                               out.ctypes.data) == 0


def occupancy(packed: PackedSTSE, lib=None) -> dict:
    """What a launch on `packed` uses, from `lib` (default: the built
    library on the current device): windows a block, shared bytes a block
    and blocks an SM (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`)."""
    lib = _library() if lib is None else lib
    layout = np.ascontiguousarray(packed.layout, np.int64)
    out = np.zeros(len(_OCCUPANCY), np.int32)
    err = lib.stse_fused_occupancy(layout.ctypes.data, len(layout), packed.n_nodes,
                                   packed.n_pad, out.ctypes.data)
    if err != 0:
        raise RuntimeError(
            f"stse_fused_occupancy failed: {lib.stse_fused_error_string(err).decode()}")
    return {k: int(v) for k, v in zip(_OCCUPANCY, out)}


def _launch(x: torch.Tensor, packed: PackedSTSE) -> torch.Tensor:
    lay = packed.layout
    b, c, t, v = x.shape
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("the stse_fused kernel takes a contiguous float32 [B, C, T, V]")
    if c != lay[0, 0] or t * v != packed.n_nodes:
        raise ValueError(
            f"input [B, {c}, {t}, {v}] does not match the packed weights "
            f"(C_in {lay[0, 0]}, T*V {packed.n_nodes})")
    w = packed.weights
    if w.device != x.device or w.dtype != torch.float32 or w.data_ptr() % 16:
        raise ValueError("packed weights must be 16-byte aligned float32 on the input's device")
    if len(lay) > 8:
        raise ValueError("the stse_fused kernel takes at most 8 layers")
    if max(min(int(ci), int(co)) for ci, co in lay[:, :2]) > 64 or int(lay[:-1, 1].max(
            initial=0)) > 64:
        raise ValueError("the stse_fused kernel contracts at most 64 channels a layer, and "
                         "an inner layer puts out at most 64")
    out = torch.empty((b, packed.n_nodes, int(lay[-1, 1])), dtype=torch.float32,
                      device=x.device)
    if b == 0:
        return out
    lib = _library()
    layout = np.ascontiguousarray(lay, np.int64)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.stse_fused_forward(
            x.data_ptr(), w.data_ptr(), layout.ctypes.data, len(layout), b,
            packed.n_nodes, packed.n_pad, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"stse_fused kernel launch failed: {lib.stse_fused_error_string(err).decode()}")
    launches.value += 1
    return out


def fused_stse_hidden(x: torch.Tensor, folded: FoldedSTSE,
                      packed: Optional[PackedSTSE] = None) -> torch.Tensor:
    """[B, C, T, V] windows -> hidden state [B, T*V, C_hidden].

    A CUDA tensor launches the kernel (with `packed`, or the weights packed
    now); a CPU tensor takes the plain version."""
    if x.is_cuda:
        return _launch(x, packed if packed is not None else pack_folded(folded))
    if x.device.type != "cpu":
        raise ValueError(f"stse_fused runs on CUDA or CPU tensors, not {x.device}")
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
    3xTF32 (three TF32 products for each)."""
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
