"""Frozen operation and byte counts of the STSE model and of the port's
kernels, from shapes alone.

The kernel counts are copies of `coskad_tpu_torch/kernels/stse_fused.py::work`
(K1) and `coskad_tpu_torch/kernels/stse_train.py::work` (K2, K3 a layer, K4;
float32) as they stand when the benchmark was defined, so that the
yardstick does not move when a later change edits those files; a test
holds the two equal at the flagship shapes. Every input is read once and
every output written once.

The model's own FLOPs (for `mfu.*`) count the products of the STSE as the
paper writes it, per window: each layer's graph contraction 2 N^2 C_in,
its dense 2 N C_in C_out and the residual dense as much again where C_in
differs from C_out, then the projector; a training step is three times the
forward (the backward's two products for each of the forward's), plus the
loss; an eval pass the forward plus the distance. Element-wise work
(BatchNorm, PReLU, Adam) is not counted.
"""

from __future__ import annotations

from typing import Dict, List, Tuple


def layers_of(arch: dict) -> List[Tuple[int, int]]:
    """(C_in, C_out) of each encoder layer."""
    chans = [arch["in_dim"]] + list(arch["channels"]) + [arch["hidden"]]
    return list(zip(chans[:-1], chans[1:]))


def nodes_of(arch: dict) -> int:
    return arch["frames"] * arch["joints"]


def forward_flops(arch: dict) -> float:
    """One window's forward FLOPs."""
    n = nodes_of(arch)
    flops = 0.0
    for ci, co in layers_of(arch):
        flops += 2.0 * n * n * ci + 2.0 * n * ci * co * (1 if ci == co else 2)
    flat = n * arch["hidden"]
    if arch["projector"] == "linear":
        flops += 2.0 * flat * arch["latent"]
    else:
        flops += 2.0 * flat * arch["latent"] + 2.0 * arch["latent"] * arch["latent"]
    return flops


def model_flops(arch: dict, kind: str) -> float:
    """One window's FLOPs in a training step ("train") or a scoring pass
    ("eval"): the loss and the distance are 3 FLOPs a latent value."""
    if kind == "train":
        return 3.0 * (forward_flops(arch) + 3.0 * arch["latent"])
    return forward_flops(arch) + 3.0 * arch["latent"]


def k1_work(arch: dict, batch: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one K1 launch over `batch` windows (the encoder,
    BatchNorm folded; not the projector)."""
    n = nodes_of(arch)
    flops, weight_elems = 0.0, 0
    layers = layers_of(arch)
    for ci, co in layers:
        flops += 2.0 * n * n * min(ci, co) + 2.0 * 2.0 * n * ci * co
        weight_elems += n * n + 2 * ci * co + 2 * co + 1
    nbytes = 4.0 * (batch * n * (layers[0][0] + layers[-1][1]) + weight_elems)
    return batch * flops, nbytes


def train_kernel_work(arch: dict, batch: int, ghost: int) -> Dict[str, Tuple[float, float]]:
    """(FLOPs, bytes) of K2 (the ghost-BN forward and projector), of K3 for
    each layer below the top and of K4 (the top layer and the projector's
    backward), float32, for one step of `batch` windows."""
    layers = layers_of(arch)
    n, latent, nb = nodes_of(arch), arch["latent"], batch // ghost
    xb = ab = 4.0
    out = {}
    fwd_flops, fwd_bytes = 0.0, xb * batch * n * layers[0][0]
    for i, (ci, co) in enumerate(layers):
        identity = ci == co
        dense = 2.0 * n * ci * co * (1 if identity else 2)
        weights = n * n + ci * co * (1 if identity else 2) + 4 * co + 1
        fwd_flops += batch * (2.0 * n * n * ci + dense)
        fwd_bytes += 4.0 * (weights + nb * 4 * co + 4 * co) + ab * batch * n * co
        top = i == len(layers) - 1
        need_dx = i > 0
        mm, res = 2.0 * n * ci * co, 0 if identity else 1
        flops = batch * (2.0 * n * n * ci * (3 if need_dx else 2)
                         + mm * (2 * (1 + res) + 1 + (res if need_dx else 0)))
        x_in = xb if i == 0 else ab
        nbytes = (x_in * batch * n * ci + (ab * batch * n * ci if need_dx else 0.0)
                  + 4.0 * (2 * weights + nb * 4 * co))
        if top:
            flops += batch * 2.0 * 2.0 * n * co * latent
            nbytes += 4.0 * (batch * latent + 2 * n * co * latent + latent) + ab * batch * n * co
        else:
            nbytes += ab * batch * n * co
        out["K4" if top else f"K3_layer{i}"] = (flops, nbytes)
    c_h = layers[-1][1]
    fwd_flops += batch * 2.0 * n * c_h * latent
    fwd_bytes += 4.0 * (n * c_h * latent + latent + batch * latent)
    out["K2"] = (fwd_flops, fwd_bytes)
    return out


def bound_s(flops: float, nbytes: float, peaks: dict, dtype: str) -> float:
    """The least time: the larger of operations over the dtype's peak and
    bytes over the memory's."""
    return max(flops / peaks["flops_per_s"][dtype], nbytes / peaks["bytes_per_s"])
