"""Training state: the step, the center and the geometry around it, and the
epoch accumulators.

Counterpart of `coskad_tpu/train/state.py::TrainState`. The model's weights
and BatchNorm statistics live in the `nn.Module`, and the optimizer on the
Trainer (PyTorch idiom); this state holds what the variants train and score
against. The accumulators are sufficient statistics of one epoch:
acc_vec / acc_weight the latent sum and count (euclidean_dynamic's center),
acc_outer the sum of (z - c)(z - c)^T (Mahalanobis covariance).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass
class TrainState:
    step: int
    center: torch.Tensor  # [D]
    inv_cov: torch.Tensor  # [D, D] (mahalanobis; identity otherwise)
    mean_vector: torch.Tensor  # [D] (VAE empirical latent mean)
    acc_vec: torch.Tensor  # [D]
    acc_weight: torch.Tensor  # []
    acc_outer: torch.Tensor  # [D, D]

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)

    def reset_accumulators(self) -> "TrainState":
        return self.replace(acc_vec=torch.zeros_like(self.acc_vec),
                            acc_weight=torch.zeros_like(self.acc_weight),
                            acc_outer=torch.zeros_like(self.acc_outer))


def init_state(latent_dim: int, device: torch.device) -> TrainState:
    f32 = dict(dtype=torch.float32, device=device)
    return TrainState(
        step=0,
        center=torch.zeros(latent_dim, **f32),
        inv_cov=torch.eye(latent_dim, **f32),
        mean_vector=torch.zeros(latent_dim, **f32),
        acc_vec=torch.zeros(latent_dim, **f32),
        acc_weight=torch.zeros((), **f32),
        acc_outer=torch.zeros(latent_dim, latent_dim, **f32),
    )


def clamp_center(c: torch.Tensor, eps: float) -> torch.Tensor:
    """Push near-zero center coordinates to +-eps so the trivial solution
    z == 0 is excluded. Exact zeros stay zero, like the reference."""
    small = torch.abs(c) < eps
    c = torch.where(small & (c < 0), torch.full_like(c, -eps), c)
    return torch.where(small & (c > 0), torch.full_like(c, eps), c)
