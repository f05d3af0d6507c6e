"""Pose-window normalization strategies (numpy, host side).

Counterpart of `coskad_tpu/data/normalize.py`, over [N, T, V, F] windows
(F = x, y, conf):

- 'markovitz': divide by video resolution, optional shift to [-1, 1], optional
  per-window mean subtraction over (T, V) returning the means,
- 'robust':    resolution scale + [-1, 1] shift, then a 10-90% quantile
  RobustScaler over flattened (x, y) features with exact-zero -> NaN masking;
  the fitted scaler state is returned for reuse at test time,
- 'stan':      temporal-mean subtraction + spatial std division,
- 'bbox':      per-frame bounding-box width/height scaling.

`RobustScalerState` is sklearn's RobustScaler (with_centering=True,
quantile_range=(10, 90)) for the NaN-masked case: center = nanmedian,
scale = nanpercentile(90) - nanpercentile(10), zeros in scale replaced by 1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class RobustScalerState:
    center: np.ndarray  # [D]
    scale: np.ndarray  # [D]

    @classmethod
    def fit(cls, x: np.ndarray, quantile_range: Tuple[float, float] = (10.0, 90.0)
            ) -> "RobustScalerState":
        q_lo, q_hi = quantile_range
        center = np.nanmedian(x, axis=0)
        scale = np.nanpercentile(x, q_hi, axis=0) - np.nanpercentile(x, q_lo, axis=0)
        scale = np.where(scale == 0.0, 1.0, scale)  # sklearn _handle_zeros_in_scale
        return cls(center=center, scale=scale)

    def transform(self, x: np.ndarray) -> np.ndarray:
        return (x - self.center) / self.scale

    def inverse_transform(self, x: np.ndarray) -> np.ndarray:
        return x * self.scale + self.center


def _res_scale(pose: np.ndarray, vid_res, symm_range: bool) -> np.ndarray:
    """Scale (x, y, conf) by (w, h, 1); optionally shift xy to [-1, 1]."""
    norm = np.asarray(list(vid_res) + [1], dtype=np.float64)
    out = pose / norm
    if symm_range:
        out[..., :2] = 2 * out[..., :2] - 1
    return out


def normalize_markovitz(
    pose: np.ndarray,
    vid_res=(856, 480),
    symm_range: bool = True,
    sub_mean: bool = True,
    **_,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """[N, T, V, F] -> normalized, plus per-window xy means if sub_mean."""
    out = _res_scale(np.array(pose, dtype=np.float64), vid_res, symm_range)
    mean = None
    if sub_mean:
        mean = np.mean(out[..., :2], axis=(1, 2))  # [N, 2]
        out[..., :2] -= mean[:, None, None, :]
    return out, mean


def normalize_robust(
    pose: np.ndarray,
    vid_res=(640, 360),
    symm_range: bool = True,
    scaler: Optional[RobustScalerState] = None,
    **_,
) -> Tuple[np.ndarray, RobustScalerState]:
    """Resolution scale + RobustScaler over flattened xy with 0 -> NaN
    masking: missing keypoints (exact 0.0 in AlphaPose exports) do not move
    the quantiles and are restored to 0 after scaling. The confidence
    channel becomes ones. Fits a scaler when none is given."""
    out = _res_scale(np.array(pose, dtype=np.float64), vid_res, symm_range)
    xy = out[..., :2]
    orig_shape = xy.shape
    flat = xy.reshape(-1, orig_shape[-1] * orig_shape[-2])
    flat = np.where(flat == 0.0, np.nan, flat)
    if scaler is None:
        scaler = RobustScalerState.fit(flat)
    scaled = scaler.transform(flat)
    scaled = np.where(np.isnan(scaled), 0.0, scaled).reshape(orig_shape)
    ones = np.ones((*orig_shape[:-1], 1))
    return np.concatenate([scaled, ones], axis=-1), scaler


def normalize_stan(
    pose: np.ndarray, vid_res=(640, 360), symm_range: bool = True, **_
) -> Tuple[np.ndarray, None]:
    """Temporal-mean subtraction (all channels) + spatial std division (xy)."""
    out = _res_scale(np.array(pose, dtype=np.float64), vid_res, symm_range)
    out -= np.mean(out, axis=1, keepdims=True)
    xy = out[..., :2]
    spatial_mean = np.mean(xy, axis=(2, 3), keepdims=True)
    std = np.sqrt(np.mean((xy - spatial_mean) ** 2, axis=(2, 3), keepdims=True) + 1e-5)
    out[..., :2] = xy / std
    return out, None


def normalize_bbox(
    pose: np.ndarray, vid_res=(640, 360), symm_range: bool = True, **_
) -> Tuple[np.ndarray, None]:
    """Per-frame bounding-box width/height scaling of x and y."""
    out = _res_scale(np.array(pose, dtype=np.float64), vid_res, symm_range)
    w = out[..., 0].max(axis=-2, keepdims=True) - out[..., 0].min(axis=-2, keepdims=True)
    h = out[..., 1].max(axis=-2, keepdims=True) - out[..., 1].min(axis=-2, keepdims=True)
    out[..., 0] = out[..., 0] / w
    out[..., 1] = out[..., 1] / h
    return out, None


STRATEGIES = {
    "markovitz": normalize_markovitz,
    "robust": normalize_robust,
    "stan": normalize_stan,
    "bbox": normalize_bbox,
}


def normalize(pose: np.ndarray, strategy: str = "markovitz", **kwargs):
    """Dispatch on strategy name; 'none' passes through."""
    if strategy in (None, "none"):
        return np.asarray(pose, dtype=np.float64), None
    try:
        fn = STRATEGIES[strategy]
    except KeyError:
        raise ValueError(
            f"Unknown normalization strategy {strategy!r}; "
            f"choose from {sorted(STRATEGIES)} or 'none'"
        ) from None
    return fn(pose, **kwargs)
