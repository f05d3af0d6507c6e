"""Per-window anomaly scores of the autoencoder's eval modes, and the pose
helpers of the reference's analysis notebooks (numpy; counterpart of
`coskad_tpu/score/window_losses.py`).

The autoencoder's eval scores a window in one of three modes, chosen by the
reconstruction weight: 'hyp' (weight 0: the latent distance to the center,
the default), 'rec' (weight > 100: the reconstruction MSE) and 'rec+hyp'
(both, the reconstruction term divided by the weight): `mode_scores`, which
`cli.eval` applies to the Trainer's scores. The notebook helpers below it
(`extract_single_pose`, `calculate_loss`, `compute_fig_matrix`) have no
caller in the package; they are kept for parity with the JAX module.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def mode_from_rec_weight(rec_loss_weight: float) -> str:
    """The scoring mode of a reconstruction weight."""
    if rec_loss_weight == 0:
        return "hyp"
    if rec_loss_weight > 100:
        return "rec"
    return "rec+hyp"


def mode_scores(latent: np.ndarray, rec: np.ndarray, rec_loss_weight: float) -> np.ndarray:
    """[B] window scores in the weight's mode from the latent scores and the
    reconstruction errors."""
    mode = mode_from_rec_weight(rec_loss_weight)
    if mode == "hyp":
        return latent
    if mode == "rec":
        return rec
    return rec / rec_loss_weight + latent


def reconstruction_window_scores(x: np.ndarray, recon: np.ndarray, z: np.ndarray,
                                 center: np.ndarray, rec_loss_weight: float = 0.0
                                 ) -> np.ndarray:
    """[B, C, T, V] input and reconstruction, [B, D] latents -> [B] window
    scores in the weight's mode: the reconstruction term is the MSE over a
    window's elements, the latent term the MSE over the latent dimensions."""
    return mode_scores(np.mean((z - center) ** 2, axis=-1),
                       np.mean((recon - x) ** 2, axis=(1, 2, 3)), rec_loss_weight)


def extract_single_pose(pose_matrix: np.ndarray, method: str = "median",
                        return_std: bool = False, std_method: str = "mean",
                        std_lift: float = 1e-7) -> Tuple[np.ndarray, np.ndarray]:
    """Consolidate a [num_detections, n_frames, D] pose matrix into one
    [n_frames, D] pose by unique / mean / median over the non-zero
    detections of each frame; optionally a min-max-scaled per-frame
    disagreement score."""
    _, n_frames, d = pose_matrix.shape
    single = np.zeros((n_frames, d))
    std_vec = np.zeros(n_frames)
    for idx in sorted(set(np.nonzero(pose_matrix)[1])):
        used = np.stack([row for row in pose_matrix[:, idx, :] if np.sum(row) != 0], 0)
        if method == "unique":
            single[idx] = used[0]
        elif method == "mean":
            single[idx] = np.mean(used, 0)
        elif method == "median":
            single[idx] = np.median(used, 0)
        else:
            raise ValueError(f"Unknown method {method!r}")
        if return_std:
            per_dim_std = np.std(used, 0)
            std_vec[idx] = np.mean(per_dim_std) if std_method == "mean" else np.median(
                per_dim_std)
    if not return_std:
        return single, np.array([])
    s = std_vec + std_lift
    lo, hi = s.min(), s.max()
    return single, (s - lo) / (hi - lo) if hi > lo else np.zeros_like(s)


def calculate_loss(x: np.ndarray, target: np.ndarray, to_pow: bool = False) -> np.ndarray:
    """Per-row MSE in float64, optionally raised to the 4th power."""
    loss = np.mean((np.asarray(target, np.float64) - np.asarray(x, np.float64)) ** 2, axis=-1)
    return loss ** 4 if to_pow else loss


def compute_fig_matrix(pos: np.ndarray, frames_pos: np.ndarray, n_frames: int) -> np.ndarray:
    """Scatter per-window poses [W, C, T, V] into a [W, n_frames, V*C]
    matrix at their (1-based) frame positions."""
    if pos.ndim != 4:
        raise ValueError(f"pos must be [W, C, T, V], got shape {pos.shape}")
    w, dim, timesteps, joints = pos.shape
    flat = pos.transpose(0, 2, 3, 1).reshape(w, timesteps, joints * dim)
    pose = np.zeros((w, n_frames, joints * dim))
    for n in range(w):
        pose[n, frames_pos[n] - 1, :] = flat[n]
    return pose
