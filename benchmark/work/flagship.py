"""Frozen work counts of the `flagship` config (see `stse_counts`)."""

from __future__ import annotations

from benchmark.reference.stse import arch_of
from benchmark.work import stse_counts


def model_flops(config: dict, kind: str) -> float:
    """One window's model FLOPs in a training step or a scoring pass."""
    return stse_counts.model_flops(arch_of(config), kind)


def k1_bound_s(config: dict, batch: int, peaks: dict) -> float:
    """K1's least time for one launch of `batch` windows (float32: 3xTF32)."""
    return stse_counts.bound_s(*stse_counts.k1_work(arch_of(config), batch), peaks, "float32")


def train_kernels_bound_s(config: dict, batch: int, ghost: int, peaks: dict) -> float:
    """K2 + K3 (each layer below the top) + K4's least time for one step."""
    work = stse_counts.train_kernel_work(arch_of(config), batch, ghost)
    return sum(stse_counts.bound_s(f, b, peaks, "float32") for f, b in work.values())
