"""Euclidean latent-space distances (counterpart of
`coskad_tpu/geometry/euclidean.py`):

- per-window MSE distance = mean over latent dims of (z - c)^2,
- Mahalanobis distance sqrt((z-c)^T VI (z-c)), VI the inverse covariance,
- the spherical VAE's cosine distance 1 - cos(z, c).
"""

from __future__ import annotations

import torch


def mse_to_center(z: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Per-sample mean squared distance to the center. [B, D] -> [B]."""
    return torch.mean((z - c) ** 2, dim=-1)


def mahalanobis(z: torch.Tensor, c: torch.Tensor, inv_cov: torch.Tensor) -> torch.Tensor:
    """Per-sample Mahalanobis distance sqrt((z-c)^T VI (z-c)). [B, D] -> [B]."""
    d = z - c
    return torch.sqrt(torch.clamp(torch.einsum("bi,ij,bj->b", d, inv_cov, d), min=0.0))


def cosine_distance_to_center(z: torch.Tensor, c: torch.Tensor, eps: float = 1e-8
                              ) -> torch.Tensor:
    """Per-sample 1 - cosine similarity to the center. [B, D] -> [B]. Each
    norm is clamped from below by eps before the division, as
    `torch.nn.functional.cosine_similarity` does."""
    zn = torch.clamp(torch.linalg.vector_norm(z, dim=-1), min=eps)
    cn = torch.clamp(torch.linalg.vector_norm(c, dim=-1), min=eps)
    return 1.0 - torch.sum(z * c, dim=-1) / (zn * cn)
