"""Geometric (affine) pose augmentations, applied on the device.

Counterpart of `coskad_tpu/data/transforms.py`. Windows stay resident on the
device once; a batch is built by gathering rows by logical index and
applying the per-item 3x3 affine matrix to the xy channels. The canonical
5-transform list (identity, flip, rot90, rot90+flip, rot45) is the
reference's `ae_trans_list`.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch


def affine_matrix(
    sx: float = 1.0,
    sy: float = 1.0,
    tx: float = 0.0,
    ty: float = 0.0,
    rot_deg: float = 0.0,
    flip: bool = False,
) -> np.ndarray:
    """3x3 affine matrix: flip @ rot @ scale_translate (reference order)."""
    cos_r = math.cos(math.radians(rot_deg))
    sin_r = math.sin(math.radians(rot_deg))
    flip_mat = np.eye(3, dtype=np.float32)
    if flip:
        flip_mat[0, 0] = -1.0
    trans_scale = np.array([[sx, 0, tx], [0, sy, ty], [0, 0, 1]], dtype=np.float32)
    rot = np.array([[cos_r, -sin_r, 0], [sin_r, cos_r, 0], [0, 0, 1]], dtype=np.float32)
    return flip_mat @ (rot @ trans_scale)


def canonical_transforms(num_transform: int = 5) -> np.ndarray:
    """The reference's 5-transform table, first `num_transform` rows. [K, 3, 3]."""
    table = np.stack(
        [
            affine_matrix(),
            affine_matrix(flip=True),
            affine_matrix(rot_deg=90),
            affine_matrix(rot_deg=90, flip=True),
            affine_matrix(rot_deg=45),
        ]
    )
    return table[:num_transform]


def apply_transforms(pose: torch.Tensor, mats: torch.Tensor) -> torch.Tensor:
    """Apply a per-sample affine matrix to pose windows.

    pose: [B, C, T, V] with C >= 2, channels 0 and 1 are x and y; further
    channels (confidence) pass through. mats: [B, 3, 3]. -> [B, C, T, V]."""
    x, y = pose[:, 0], pose[:, 1]

    def m(i, j):
        return mats[:, i, j][:, None, None]

    out_xy = torch.stack(
        [
            m(0, 0) * x + m(0, 1) * y + m(0, 2),
            m(1, 0) * x + m(1, 1) * y + m(1, 2),
        ],
        dim=1,
    )
    if pose.shape[1] > 2:
        return torch.cat([out_xy, pose[:, 2:]], dim=1)
    return out_xy


def gather_batch(
    data: torch.Tensor,
    indices: torch.Tensor,
    trans_table: torch.Tensor,
    num_coords: int = 2,
    window_shape: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """Build a batch from device-resident windows.

    Logical index i in [0, K*N) maps to (sample i % N, transform i // N),
    the reference's indexing: gather the window and its 3x3 matrix, apply,
    keep the first `num_coords` channels.

    data: [N, C, T, V], or flat [N, C*T*V] with `window_shape` = (C, T, V).
    indices: [B] logical indices (int64). trans_table: [K, 3, 3].
    """
    n = data.shape[0]
    sample_idx = torch.remainder(indices, n)
    trans_idx = torch.div(indices, n, rounding_mode="floor")
    batch = data.index_select(0, sample_idx)
    if window_shape is not None and batch.dim() == 2:
        batch = batch.reshape((batch.shape[0],) + tuple(window_shape))
    mats = trans_table.index_select(0, trans_idx)
    if num_coords == 2 and batch.shape[1] > 2:
        # The affine never reads the confidence channel: drop it first.
        return apply_transforms(batch[:, :2], mats)
    return apply_transforms(batch, mats)[:, :num_coords]
