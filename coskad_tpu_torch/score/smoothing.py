"""Temporal post-processing of per-frame anomaly scores.

Reimplements the reference's `score_process` (utils/eval_utils.py:200-207)
exactly: shift scores forward by 8 + 8//2 - 1 = 11 frames (zero-filled head),
then smooth with a Gaussian of sigma=30 using scipy's gaussian_filter1d
semantics (truncate=4.0, 'reflect' boundary) — implemented here directly so
the scoring path has no scipy dependency.
"""

from __future__ import annotations

import numpy as np

SHIFT = 8 + (8 // 2) - 1  # 11 frames; window stride bookkeeping constant


def gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    """scipy.ndimage._gaussian_kernel1d for order 0."""
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 / (sigma * sigma) * x**2)
    return phi / phi.sum()


def _reflect_pad(x: np.ndarray, pad: int) -> np.ndarray:
    """scipy 'reflect' boundary (d c b a | a b c d), any pad length."""
    out = x
    left_needed, right_needed = pad, pad
    while left_needed > 0 or right_needed > 0:
        lp = min(left_needed, len(out))
        rp = min(right_needed, len(out))
        out = np.concatenate([out[:lp][::-1], out, out[-rp:][::-1] if rp else out[:0]])
        left_needed -= lp
        right_needed -= rp
    return out


def gaussian_filter1d(x: np.ndarray, sigma: float, truncate: float = 4.0) -> np.ndarray:
    """1-D Gaussian filter matching scipy.ndimage.gaussian_filter1d defaults."""
    x = np.asarray(x, dtype=np.float64)
    if x.size == 0:
        # scipy returns empty for empty input; _reflect_pad would otherwise
        # LOOP FOREVER (pad can never be satisfied from zero rows) — hit in
        # production by flushing an empty stream through the HTTP server
        # while it held the device lock (scripts/soak_server.py, round 5).
        return x.copy()
    radius = int(truncate * sigma + 0.5)
    kernel = gaussian_kernel1d(sigma, radius)
    padded = _reflect_pad(x, radius)
    return np.convolve(padded, kernel, mode="valid")


def score_process(score: np.ndarray, sigma: float = 30.0, shift: int = SHIFT) -> np.ndarray:
    """Shift by `shift` frames (zero head) then Gaussian-smooth."""
    score = np.asarray(score, dtype=np.float64)
    shifted = np.zeros_like(score)
    if shift > 0:
        shifted[shift:] = score[:-shift]
    else:
        shifted = score
    return gaussian_filter1d(shifted, sigma)
