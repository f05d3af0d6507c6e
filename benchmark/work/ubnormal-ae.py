"""Frozen work counts of the `ubnormal-ae` config: the autoencoder's eval.

`model_flops` counts the products of the model as the paper writes it, per
window, as `stse_counts` does: the encoder and its MLP head
(`stse_counts.forward_flops`), the distance, the reverse projector's
2 L (H T V), the decoder's layers (each graph contraction 2 N^2 C_in, its
dense 2 N C_in C_out and a residual dense as much again where the channels
change) and the reconstruction error's 3 C_in N (a difference, a square
and a sum a value).

`k1_bound_s` is the least time of K1's work on both stacks for one batch, in
the bf16 form's terms, from the formulas of
`coskad_tpu_torch/kernels/stse_fused.py::work_bf16` as they stand when the
cell was defined: per layer the graph contraction 2 N^2 C_in (not
reassociated), the dense 2 N C_in C_out and the residual dense as much
again where it is not the identity; the float32 input read once, the
float32 output written once, M and the dense weights read once at bf16,
the biases and slopes at float32. A stack's bound is the larger of its
operations over the bf16 peak and its bytes over the memory's; the
encoder's and the decoder's add, whether one launch or two runs them.
"""

from __future__ import annotations

from typing import Tuple

from benchmark.reference.stse import arch_of
from benchmark.reference.stsae import decoder_layers
from benchmark.work import stse_counts


def _stack_flops(n: int, layers) -> float:
    return sum(2.0 * n * n * ci + 2.0 * n * ci * co * (1 if ci == co else 2)
               for ci, co in layers)


def model_flops(config: dict, kind: str) -> float:
    """One window's model FLOPs in a scoring pass ("eval")."""
    if kind != "eval":
        raise ValueError(f"the ubnormal-ae config is scored, not trained: no {kind!r} count")
    arch = arch_of(config)
    n = stse_counts.nodes_of(arch)
    flat = n * arch["hidden"]
    return (stse_counts.forward_flops(arch) + 3.0 * arch["latent"]
            + 2.0 * arch["latent"] * flat + _stack_flops(n, decoder_layers(arch))
            + 3.0 * arch["in_dim"] * n)


def k1_stack_work_bf16(n: int, layers, batch: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of K1's bf16 form on one stack for `batch` windows."""
    flops, nbytes = 0.0, 0.0
    for ci, co in layers:
        denses = 1 if ci == co else 2
        flops += 2.0 * n * n * ci + 2.0 * n * ci * co * denses
        nbytes += 2.0 * (n * n + ci * co * denses) + 4.0 * (2 * co + 1)
    return batch * flops, nbytes + 4.0 * batch * n * (layers[0][0] + layers[-1][1])


def k1_bound_s(config: dict, batch: int, peaks: dict) -> float:
    """The least time of K1's work on the encoder and the decoder for one
    batch of `batch` windows."""
    arch = arch_of(config)
    n = stse_counts.nodes_of(arch)
    return sum(stse_counts.bound_s(*k1_stack_work_bf16(n, layers, batch), peaks, "bfloat16")
               for layers in (stse_counts.layers_of(arch), decoder_layers(arch)))
