"""Per-window anomaly scores in the variant's geometry (counterpart of
`coskad_tpu/train/objectives.py::window_scores`).

The encoder-only euclidean variants score by MSE or Mahalanobis distance to
the center. The losses come with the training slice (ROADMAP.md, Queue 1
item 2); the VAE and hyperbolic scores with their variants (item 5).
"""

from __future__ import annotations

import torch

from ..config import Config
from ..geometry import euclidean as euc


def window_scores(cfg: Config, z: torch.Tensor, center: torch.Tensor,
                  inv_cov: torch.Tensor, mean_vector: torch.Tensor) -> torch.Tensor:
    """Per-window anomaly score. [B, D] -> [B]."""
    variant = cfg.model.variant
    if variant in ("vae", "hyperbolic"):
        raise NotImplementedError(
            f"{variant} scoring is not ported yet (ROADMAP.md, Queue 1 item 5)")
    if cfg.model.distance == "mahalanobis":
        return euc.mahalanobis(z, center, inv_cov)
    return euc.mse_to_center(z, center)
