"""Euclidean latent-space distances (counterpart of
`coskad_tpu/geometry/euclidean.py`):

- per-window MSE distance = mean over latent dims of (z - c)^2,
- Mahalanobis distance sqrt((z-c)^T VI (z-c)), VI the inverse covariance.
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
