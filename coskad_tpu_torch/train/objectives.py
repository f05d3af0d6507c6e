"""Training objectives and window scores of the euclidean variants
(counterpart of `coskad_tpu/train/objectives.py`).

The encoder-only euclidean variants (`euclidean_static`,
`euclidean_dynamic`) contract latents toward the center by MSE or by
Mahalanobis distance, plus a weight regularizer; they score windows by the
same distance. The VAE, autoencoder and hyperbolic objectives and scores
come with their variants (ROADMAP.md, Queue 1 item 5).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..config import Config
from ..geometry import euclidean as euc

EUCLIDEAN = ("euclidean_static", "euclidean_dynamic")


def _unported(variant: str, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{variant} {what} is not ported yet (ROADMAP.md, Queue 1 item 5)")


def reg_loss(model: nn.Module) -> torch.Tensor:
    """Mean over the non-`bias` parameter tensors of 0.5 * ||W||^2 (the
    reference's `'bias' not in name`). BatchNorm's running statistics are
    buffers, not parameters, so they are not among them."""
    vals = [0.5 * torch.sum(p * p) for name, p in model.named_parameters()
            if name.rsplit(".", 1)[-1] != "bias"]
    return sum(vals) / len(vals)


def compute_loss(cfg: Config, z: torch.Tensor, batch: torch.Tensor, model: nn.Module,
                 center: torch.Tensor, inv_cov: torch.Tensor
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Loss and scalar metrics for one batch of latents z [B, D]."""
    variant = cfg.model.variant
    if variant not in EUCLIDEAN:
        raise _unported(variant, "training")
    l_reg = reg_loss(model)
    if cfg.model.distance == "mahalanobis":
        l_center = torch.mean(euc.mahalanobis(z, center, inv_cov))
    else:
        l_center = torch.mean((z - center) ** 2)
    loss = l_center + cfg.opt.alpha * l_reg
    return loss, {"regularization": l_reg, "hypersphere_loss": l_center, "loss": loss}


def latent_of(variant: str, variant_outputs) -> torch.Tensor:
    """The latent used for center/covariance accumulation."""
    if variant not in EUCLIDEAN:
        raise _unported(variant, "training")
    return variant_outputs


def accumulate_stats(state_acc: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                     variant: str, distance: str, z: torch.Tensor, center: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Add one batch's center/covariance sufficient statistics: the latent
    sum and count, and for Mahalanobis the sum of (z - c)(z - c)^T."""
    if variant not in EUCLIDEAN:
        raise _unported(variant, "training")
    acc_vec, acc_weight, acc_outer = state_acc
    z = z.detach()
    acc_vec = acc_vec + torch.sum(z, dim=0)
    acc_weight = acc_weight + z.shape[0]
    if distance == "mahalanobis":
        d = z - center
        acc_outer = acc_outer + d.T @ d
    return acc_vec, acc_weight, acc_outer


def window_scores(cfg: Config, z: torch.Tensor, center: torch.Tensor,
                  inv_cov: torch.Tensor, mean_vector: torch.Tensor) -> torch.Tensor:
    """Per-window anomaly score. [B, D] -> [B]."""
    variant = cfg.model.variant
    if variant in ("vae", "hyperbolic"):
        raise _unported(variant, "scoring")
    if cfg.model.distance == "mahalanobis":
        return euc.mahalanobis(z, center, inv_cov)
    return euc.mse_to_center(z, center)
