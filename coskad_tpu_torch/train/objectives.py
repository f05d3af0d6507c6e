"""Training objectives and window scores of every variant (counterpart of
`coskad_tpu/train/objectives.py`).

The euclidean variants (`euclidean_static`, `euclidean_dynamic`) contract
latents toward the center by MSE or by Mahalanobis distance, plus a weight
regularizer; they score windows by the same distance. The hyperbolic
variant maps latents onto the Poincaré ball (`project(expmap0(z))`) and
contracts them toward the center by geodesic distance; its center is the
Einstein midpoint of the epoch's ball points, accumulated batch by batch
as (sum of gamma x_Klein, sum of gamma), and it scores a window by its
geodesic distance to the center. The autoencoder adds the reconstruction
MSE (weight lambda_) to the latent MSE and scores by latent distance; the
VAE trains on its ELBO (reconstruction, KL to the prior, the 1/z_var term,
and the opt-in contraction of the posterior means toward the anchor) and
scores a window by its cosine distance to the anchor `mean_vector`, the
previous epoch's latent mean.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..config import Config
from ..geometry import euclidean as euc
from ..geometry import poincare as hyp
from ..geometry.sphere import PowerSpherical, normal_kl_standard
from ..parallel import mesh

EUCLIDEAN = ("euclidean_static", "euclidean_dynamic")
ENCODER_ONLY = EUCLIDEAN + ("hyperbolic",)


def reg_loss(model: nn.Module) -> torch.Tensor:
    """Mean over the non-`bias` parameter tensors of 0.5 * ||W||^2 (the
    reference's `'bias' not in name`). BatchNorm's running statistics are
    buffers, not parameters, so they are not among them. A kernel split over
    a model axis sums its blocks' squares over the model group."""
    lay = mesh.model_layout(model)

    def squares(name, p):
        s = torch.sum(p * p)
        if lay is None or mesh.split_dim(name, p.dim()) is None:
            return s
        return mesh.model_sum(s, lay)

    vals = [0.5 * squares(name, p) for name, p in model.named_parameters()
            if name.rsplit(".", 1)[-1] != "bias"]
    return sum(vals) / len(vals)


def compute_loss(cfg: Config, outputs, batch: torch.Tensor, model: nn.Module,
                 center: torch.Tensor, inv_cov: torch.Tensor,
                 mean_vector: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Loss and scalar metrics for one batch. `outputs` is the model's
    forward: z [B, D] (STSE), (z, recon) (STSAE) or (z, recon, (z_mean,
    z_var)) (STSVAE). `mean_vector`, the VAE's anchor, feeds only the opt-in
    `opt.vae_contraction` term."""
    variant = cfg.model.variant
    opt = cfg.opt
    l_reg = reg_loss(model)
    metrics = {"regularization": l_reg}
    if variant in EUCLIDEAN:
        z = outputs
        if cfg.model.distance == "mahalanobis":
            l_center = torch.mean(euc.mahalanobis(z, center, inv_cov))
        else:
            l_center = torch.mean((z - center) ** 2)
        loss = l_center + opt.alpha * l_reg
        metrics["hypersphere_loss"] = l_center
    elif variant == "autoencoder":
        z, recon = outputs
        l_rec = torch.mean((recon - batch) ** 2)
        l_center = torch.mean((z - center) ** 2)
        loss = opt.lambda_ * l_rec + l_center + opt.alpha * l_reg
        metrics.update(reconstruction_loss=l_rec, hypersphere_loss=l_center)
    elif variant == "vae":
        z, recon, (z_mean, z_var) = outputs
        l_rec = torch.mean((recon - batch) ** 2)
        if cfg.model.distribution == "ps":
            l_kl = torch.mean(PowerSpherical(z_mean, z_var.squeeze(-1)).kl_to_uniform())
        else:
            l_kl = torch.mean(torch.sum(normal_kl_standard(z_mean, z_var), dim=-1))
        l_exp = torch.mean(1.0 / z_var)
        loss = opt.phi * l_rec + opt.alpha * l_reg + opt.beta * l_kl + opt.gamma * l_exp
        metrics.update(reconstruction_loss=l_rec, kl_loss=l_kl, exp_dist_loss=l_exp)
        if opt.vae_contraction > 0 and mean_vector is not None:
            # 1 - cos of the posterior means to the anchor, gated off while
            # the anchor is still zero (the first epoch)
            mv_norm = torch.linalg.vector_norm(mean_vector)
            mv_dir = mean_vector / (mv_norm + 1e-12)
            zdir = z_mean
            if cfg.model.distribution != "ps":  # 'ps' means are unit already
                zdir = z_mean / (torch.linalg.vector_norm(z_mean, dim=-1, keepdim=True) + 1e-12)
            l_con = torch.mean(1.0 - torch.sum(zdir * mv_dir, dim=-1))
            loss = loss + opt.vae_contraction * (mv_norm > 1e-6).to(loss.dtype) * l_con
            metrics["vae_contraction_loss"] = l_con
    elif variant == "hyperbolic":
        z_h = hyp.project(hyp.expmap0(outputs))
        l_poincare = torch.mean(hyp.dist(center, z_h))
        loss = l_poincare + opt.alpha * l_reg
        metrics.update(poincare_loss=l_poincare,
                       hyperlatent_norm=torch.mean(torch.linalg.vector_norm(z_h, dim=-1)))
    else:
        raise ValueError(f"Unknown variant {variant!r}")
    metrics["loss"] = loss
    return loss, metrics


def latent_of(variant: str, outputs) -> torch.Tensor:
    """The latent used for center/covariance accumulation: the forward's z
    (the first of the decoder variants' outputs)."""
    return outputs if variant in ENCODER_ONLY else outputs[0]


def accumulate_stats(state_acc: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                     variant: str, distance: str, z: torch.Tensor, center: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Add one batch's center/covariance sufficient statistics: the latent
    sum and count (hyperbolic: the midpoint's statistics of the ball
    points), and for Mahalanobis the sum of (z - c)(z - c)^T."""
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
        return euc.cosine_distance_to_center(z, mean_vector)
    if cfg.model.distance == "mahalanobis":
        return euc.mahalanobis(z, center, inv_cov)
    return euc.mse_to_center(z, center)
