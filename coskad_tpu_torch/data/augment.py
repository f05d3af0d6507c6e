"""Contrastive-style skeleton augmentation toolbox (host side, numpy).

Counterpart of `coskad_tpu/data/augment.py`: the reference's utils/tools.py
ops (its `_old_aug` / `_old_strong_aug` dataset paths and the `double_item`
contrastive mode). All randomness flows through an explicit numpy Generator,
so an augmentation is reproducible from its seed. The trainer's contrastive
view runs the batched device ops of `data/augment_device.py` instead.

Also provides `batched_temporal_crop`, the reflection-padded temporal crop
over a batch of torch windows with given starts, and `process_stream`
(joint / motion / bone / 2s / 3s input streams).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .augment_device import random_temporal_crop

# NTU left-right joint swap order (reference utils/tools.py:11-13).
NTU_FLIP_ORDER = [0, 1, 2, 3, 8, 9, 10, 11, 4, 5, 6, 7, 16, 17, 18, 19,
                  12, 13, 14, 15, 20, 23, 24, 21, 22]

NTU_BONES = [(1, 2), (2, 21), (3, 21), (4, 3), (5, 21), (6, 5), (7, 6),
             (8, 7), (9, 21), (10, 9), (11, 10), (12, 11), (13, 1), (14, 13),
             (15, 14), (16, 15), (17, 1), (18, 17), (19, 18), (20, 19),
             (21, 21), (22, 23), (23, 8), (24, 25), (25, 12)]

RIGHT_LIMBS = [9, 10, 11, 17, 18, 19, 23, 24]
LEFT_LIMBS = [5, 6, 7, 13, 14, 15, 21, 22]


def temporal_crop(pose: np.ndarray, padding_ratio: int = 6,
                  rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Reflection-pad T by T//ratio on both sides, crop a random T-window."""
    rng = rng or np.random.default_rng()
    c, t, v = pose.shape
    pad = t // padding_ratio
    start = int(rng.integers(0, 2 * pad + 1))
    padded = np.concatenate(
        [pose[:, :pad][:, ::-1], pose, pose[:, -pad:][:, ::-1]], axis=1
    )
    return padded[:, start : start + t]


def shear(pose: np.ndarray, r: float = 0.5,
          rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Random 3x3 shear applied over the channel dim (reference :52-63)."""
    rng = rng or np.random.default_rng()
    s1 = rng.uniform(-r, r, 3)
    s2 = rng.uniform(-r, r, 3)
    m = np.array([[1, s1[0], s2[0]], [s1[1], 1, s2[1]], [s1[2], s2[2], 1]]).T
    c = pose.shape[0]
    out = np.einsum("ctv,ck->ktv", _pad_channels(pose, 3), m[:3, :3])
    return out[:c]


def _pad_channels(pose: np.ndarray, n: int) -> np.ndarray:
    """Cyclically extend the channel dim to n (the reference's repeat trick
    for applying 3D ops to 2D skeletons, utils/tools.py:117)."""
    c = pose.shape[0]
    if c >= n:
        return pose[:n]
    reps = int(np.ceil(n / c))
    return np.concatenate([pose] * reps, axis=0)[:n]


def random_spatial_flip(pose: np.ndarray, p: float = 0.5,
                        rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """NTU left-right swap with probability p (25-joint layout)."""
    rng = rng or np.random.default_rng()
    if pose.shape[2] == len(NTU_FLIP_ORDER) and rng.random() < p:
        return pose[:, :, NTU_FLIP_ORDER]
    return pose


def random_time_flip(pose: np.ndarray, p: float = 0.5,
                     rng: Optional[np.random.Generator] = None) -> np.ndarray:
    rng = rng or np.random.default_rng()
    if rng.random() < p:
        return pose[:, ::-1]
    return pose


def random_rotate(pose: np.ndarray,
                  rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Small random rotation: up to 30 degrees around a random main axis,
    up to 1 degree around the others, computed on the xy(x) pseudo-3D
    representation like the reference (utils/tools.py:98-138)."""
    rng = rng or np.random.default_rng()

    def rot_matrix(axis: int, angle: float) -> np.ndarray:
        ca, sa = math.cos(angle), math.sin(angle)
        if axis == 0:
            return np.array([[1, 0, 0], [0, ca, sa], [0, -sa, ca]])
        return np.array([[ca, 0, -sa], [0, 1, 0], [sa, 0, ca]])

    c = pose.shape[0]
    seq = np.transpose(pose, (1, 2, 0))  # T, V, C
    main_axis = int(rng.integers(0, 3))
    for axis in (0, 1):
        deg = rng.uniform(0, 30) if axis == main_axis else rng.uniform(0, 1)
        r = rot_matrix(axis, math.radians(deg)).T
        seq3 = np.concatenate([seq] * 2, axis=-1)[..., :3]
        seq = (seq3 @ r)[..., :2]
    return np.transpose(seq, (2, 0, 1))[:c]


def gaussian_noise(pose: np.ndarray, mean: float = 0.0, std: float = 0.01,
                   p: float = 0.5,
                   rng: Optional[np.random.Generator] = None) -> np.ndarray:
    rng = rng or np.random.default_rng()
    if rng.random() < p:
        return pose + rng.normal(mean, std, size=pose.shape)
    return pose


def gaussian_blur(pose: np.ndarray, kernel: int = 15, sigma_range=(0.1, 2.0),
                  p: float = 0.5,
                  rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Temporal Gaussian blur with random sigma, probability p
    (reference GaussianBlurConv, utils/tools.py:156-182). The unnormalized
    kernel (matching the reference's conv weights) is applied along T with
    zero padding."""
    rng = rng or np.random.default_rng()
    if rng.random() >= p:
        return pose
    sigma = rng.uniform(*sigma_range)
    radius = kernel // 2
    idx = np.arange(-radius, radius + 1)
    k = np.exp(-(idx**2) / (2.0 * sigma**2))  # NOT normalized, like the ref
    c, t, v = pose.shape
    padded = np.pad(pose, ((0, 0), (radius, radius), (0, 0)))
    out = np.empty_like(pose, dtype=np.float64)
    for dt in range(t):
        out[:, dt] = np.tensordot(k, padded[:, dt : dt + kernel], axes=(0, 1))
    return out


def axis_mask(pose: np.ndarray, p: float = 0.5, axis: Optional[int] = None,
              rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Zero out one coordinate channel with probability p."""
    rng = rng or np.random.default_rng()
    if rng.random() >= p:
        return pose
    out = pose.copy()
    out[axis if axis is not None else int(rng.integers(0, 2))] = 0.0
    return out


def resample(pose: np.ndarray,
             rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Fourier resampling of T by a random 0.7-1.3 rate (scipy semantics)."""
    from scipy.signal import resample as sp_resample

    rng = rng or np.random.default_rng()
    rate = int(rng.integers(7, 14)) * 0.1
    n = int(pose.shape[1] * rate)
    return sp_resample(pose, n, axis=1)


def savgol_smooth(pose: np.ndarray, p: float = 0.5,
                  rng: Optional[np.random.Generator] = None) -> np.ndarray:
    from scipy.signal import savgol_filter

    rng = rng or np.random.default_rng()
    if rng.random() < p:
        return savgol_filter(pose, 15, 2, axis=1)
    return pose


def limbs_mask(pose: np.ndarray, p: float = 0.5,
               rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Drop all left or all right limb joints (NTU 25-joint indices)."""
    rng = rng or np.random.default_rng()
    out = pose.copy()
    if rng.random() < p:
        drop = RIGHT_LIMBS if rng.random() < 0.5 else LEFT_LIMBS
        out[:, :, drop] = 0.0
    return out


def temporal_shift(pose: np.ndarray,
                   rng: Optional[np.random.Generator] = None) -> np.ndarray:
    rng = rng or np.random.default_rng()
    offset = int(rng.integers(0, pose.shape[1]))
    return np.concatenate([pose[:, offset:], pose[:, :offset]], axis=1)


def weak_augment(pose: np.ndarray, padding_ratio: int = 6,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """The reference's `_old_aug`: temporal crop only (utils/dataset.py:123-128)."""
    return temporal_crop(pose, padding_ratio, rng)


def strong_augment(pose: np.ndarray, padding_ratio: int = 6,
                   rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """The reference's `_old_strong_aug` chain (utils/dataset.py:110-121)."""
    rng = rng or np.random.default_rng()
    out = temporal_crop(pose, padding_ratio, rng)
    out = random_rotate(out, rng)
    out = gaussian_noise(out, rng=rng)
    out = gaussian_blur(out, rng=rng)
    out = axis_mask(out, rng=rng)
    out = random_time_flip(out, rng=rng)
    return np.ascontiguousarray(out)


def process_stream(data: np.ndarray, stream: str = "joint") -> np.ndarray:
    """joint / motion / bone / 2s / 3s input streams over [N, C, T, V, M]
    (reference utils/tools.py:16-49; NTU bone list)."""
    if stream == "joint":
        return data
    if stream == "motion":
        motion = np.zeros_like(data)
        motion[:, :, :-1] = data[:, :, 1:] - data[:, :, :-1]
        return motion
    if stream == "bone":
        bone = np.zeros_like(data)
        for v1, v2 in NTU_BONES:
            bone[:, :, :, v1 - 1] = data[:, :, :, v1 - 1] - data[:, :, :, v2 - 1]
        return bone
    if stream == "2s":
        return np.concatenate(
            [process_stream(data, "joint"), process_stream(data, "bone")], axis=1
        )
    if stream == "3s":
        return np.concatenate(
            [process_stream(data, s) for s in ("joint", "motion", "bone")], axis=1
        )
    raise ValueError(f"Unknown stream {stream!r}")


def batched_temporal_crop(pose, starts, padding_ratio: int = 6):
    """Batched temporal crop on torch windows: [B, C, T, V] + per-sample
    start indices in [0, 2 * (T // ratio)] -> [B, C, T, V]
    (`augment_device.random_temporal_crop` with the starts given)."""
    return random_temporal_crop(pose, {"starts": torch.as_tensor(starts, device=pose.device)},
                                padding_ratio)
