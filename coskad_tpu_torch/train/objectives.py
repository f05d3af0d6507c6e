"""Training objectives and window scores of the encoder-only variants
(counterpart of `coskad_tpu/train/objectives.py`).

The euclidean variants (`euclidean_static`, `euclidean_dynamic`) contract
latents toward the center by MSE or by Mahalanobis distance, plus a weight
regularizer; they score windows by the same distance. The hyperbolic
variant maps latents onto the Poincaré ball (`project(expmap0(z))`) and
contracts them toward the center by geodesic distance; its center is the
Einstein midpoint of the epoch's ball points, accumulated batch by batch
as (sum of gamma x_Klein, sum of gamma), and it scores a window by its
geodesic distance to the center. The VAE and autoencoder objectives and
scores come with their variants (ROADMAP.md, Queue 1 item 3).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..config import Config
from ..geometry import euclidean as euc
from ..geometry import poincare as hyp

EUCLIDEAN = ("euclidean_static", "euclidean_dynamic")
ENCODER_ONLY = EUCLIDEAN + ("hyperbolic",)


def _unported(variant: str, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{variant} {what} is not ported yet (ROADMAP.md, Queue 1 item 3)")


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
    if variant not in ENCODER_ONLY:
        raise _unported(variant, "training")
    l_reg = reg_loss(model)
    if variant == "hyperbolic":
        z_h = hyp.project(hyp.expmap0(z))
        l_poincare = torch.mean(hyp.dist(center, z_h))
        loss = l_poincare + cfg.opt.alpha * l_reg
        return loss, {"regularization": l_reg, "poincare_loss": l_poincare,
                      "hyperlatent_norm": torch.mean(torch.linalg.vector_norm(z_h, dim=-1)),
                      "loss": loss}
    if cfg.model.distance == "mahalanobis":
        l_center = torch.mean(euc.mahalanobis(z, center, inv_cov))
    else:
        l_center = torch.mean((z - center) ** 2)
    loss = l_center + cfg.opt.alpha * l_reg
    return loss, {"regularization": l_reg, "hypersphere_loss": l_center, "loss": loss}


def latent_of(variant: str, variant_outputs) -> torch.Tensor:
    """The latent used for center/covariance accumulation."""
    if variant not in ENCODER_ONLY:
        raise _unported(variant, "training")
    return variant_outputs


def accumulate_stats(state_acc: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                     variant: str, distance: str, z: torch.Tensor, center: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Add one batch's center/covariance sufficient statistics: the latent
    sum and count (hyperbolic: the midpoint's statistics of the ball
    points), and for Mahalanobis the sum of (z - c)(z - c)^T."""
    if variant not in ENCODER_ONLY:
        raise _unported(variant, "training")
    acc_vec, acc_weight, acc_outer = state_acc
    z = z.detach()
    if variant == "hyperbolic":
        ws, w = hyp.streaming_midpoint_stats(hyp.project(hyp.expmap0(z)))
        acc_vec = acc_vec + ws
        acc_weight = acc_weight + w.squeeze()
    else:
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
    if variant == "hyperbolic":
        return hyp.dist(hyp.project(hyp.expmap0(z)), center)
    if variant == "vae":
        raise _unported(variant, "scoring")
    if cfg.model.distance == "mahalanobis":
        return euc.mahalanobis(z, center, inv_cov)
    return euc.mse_to_center(z, center)
