"""Scoring state: the center and the geometry around it.

Counterpart of the geometry fields of `coskad_tpu/train/state.py::TrainState`.
The model's weights live in the `nn.Module` (PyTorch idiom); this state holds
what the variants score against. The optimizer state and the epoch
accumulators come with the training slice.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass
class TrainState:
    center: torch.Tensor  # [D]
    inv_cov: torch.Tensor  # [D, D] (mahalanobis; identity otherwise)
    mean_vector: torch.Tensor  # [D] (VAE empirical latent mean)

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


def init_state(latent_dim: int, device: torch.device) -> TrainState:
    return TrainState(
        center=torch.zeros(latent_dim, dtype=torch.float32, device=device),
        inv_cov=torch.eye(latent_dim, dtype=torch.float32, device=device),
        mean_vector=torch.zeros(latent_dim, dtype=torch.float32, device=device),
    )


def clamp_center(c: torch.Tensor, eps: float) -> torch.Tensor:
    """Push near-zero center coordinates to +-eps so the trivial solution
    z == 0 is excluded. Exact zeros stay zero, like the reference."""
    small = torch.abs(c) < eps
    c = torch.where(small & (c < 0), torch.full_like(c, -eps), c)
    return torch.where(small & (c > 0), torch.full_like(c, eps), c)
