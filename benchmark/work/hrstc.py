"""Frozen work counts of the `hrstc` config (see `stse_counts`)."""

from __future__ import annotations

from benchmark.reference.stse import arch_of
from benchmark.work import stse_counts


def model_flops(config: dict, kind: str) -> float:
    """One window's model FLOPs in a training step or a scoring pass."""
    return stse_counts.model_flops(arch_of(config), kind)
