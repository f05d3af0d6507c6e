"""Window-level anomaly scores -> per-frame scores.

Vectorized replacement for the reference's scatter-into-matrix-then-nanmean
pipeline (utils/eval_utils.py:57-74 `windows_based_loss_hy` +
eval_COSKAD.py:201-203): each window writes its scalar score at its actual
frame positions (1-based keys, scattered at key-1); a frame's score for one
actor is the mean of the non-zero window scores covering it, 0 if uncovered.
Instead of materializing a [num_windows, n_frames] matrix per actor and
looping in Python, we do two bincounts over (actor, frame) ids — identical
output, O(W*T) instead of O(W*n_frames).

Also ports `pad_scores` (utils/eval_utils.py:232-248) faithfully, including
its quirks: only frames 0..len(gt)-2 are considered for absence intervals,
an interval ending at len(gt)-2 is treated as running to the end, and the
whole-clip-absent case is skipped.
"""

from __future__ import annotations

import numpy as np


def actor_frame_scores(
    window_scores: np.ndarray,
    actor_idx: np.ndarray,
    frame_ids: np.ndarray,
    n_frames: int,
    n_actors: int,
) -> np.ndarray:
    """Mean non-zero window score per (actor, frame).

    Args:
        window_scores: [W] scalar anomaly score per window.
        actor_idx: [W] dense actor index in [0, n_actors).
        frame_ids: [W, T] actual (1-based) frame keys each window covers.
        n_frames: clip length.
        n_actors: number of distinct actors.

    Returns:
        [n_actors, n_frames] matrix; frames covered by no (non-zero-score)
        window are exactly 0, matching the reference's NaN->0 round-trip.
    """
    w, t = frame_ids.shape
    scores = np.asarray(window_scores, dtype=np.float64)
    # A score of exactly 0.0 is treated as "no observation" by the reference
    # (zeros -> NaN -> nanmean), reproduce that.
    valid = scores != 0.0
    flat_actor = np.repeat(actor_idx, t)
    flat_frame = (frame_ids - 1).reshape(-1)
    flat_score = np.repeat(scores, t)
    flat_valid = np.repeat(valid, t) & (flat_frame >= 0) & (flat_frame < n_frames)

    ids = flat_actor[flat_valid] * n_frames + flat_frame[flat_valid]
    size = n_actors * n_frames
    sums = np.bincount(ids, weights=flat_score[flat_valid], minlength=size)
    counts = np.bincount(ids, minlength=size)
    out = np.where(counts > 0, sums / np.maximum(counts, 1), 0.0)
    return out.reshape(n_actors, n_frames)


def actor_frame_scores_multi(
    window_scores: np.ndarray,
    actor_idx: np.ndarray,
    frame_ids: np.ndarray,
    n_frames: int,
    n_actors: int,
) -> np.ndarray:
    """`actor_frame_scores` for K score vectors over the SAME windows.

    Args:
        window_scores: [K, W] — one score vector per transform for identical
            window metadata (the shared-meta case of
            aggregate.evaluate_windows: the reference tiles the dataset
            num_transform times with the same (actor, frame) layout,
            utils/dataset.py:65-80).
        actor_idx / frame_ids / n_frames / n_actors: as in
            actor_frame_scores.

    Returns:
        [K, n_actors, n_frames]; row k is bit-identical to
        actor_frame_scores(window_scores[k], ...) — the flat ids are offset
        by k * n_actors * n_frames so each transform occupies its own
        bincount segment and accumulates in the same element order as the
        single-transform call. One bincount for all K transforms amortizes
        the flat-id construction K-fold (the host-aggregation hot spot at
        UBnormal scale, scripts/bench_eval_aggregation.py).
    """
    scores = np.asarray(window_scores, dtype=np.float64)
    k, w = scores.shape
    t = frame_ids.shape[1]
    flat_actor = np.repeat(actor_idx, t)
    flat_frame = (frame_ids - 1).reshape(-1)
    in_bounds = (flat_frame >= 0) & (flat_frame < n_frames)
    size = n_actors * n_frames
    base_ids = flat_actor * n_frames + flat_frame  # [W*T]; garbage where oob
    flat_scores = np.repeat(scores, t, axis=1)  # [K, W*T]
    # Exactly-0.0 scores mean "no observation" (reference zeros->NaN->nanmean)
    flat_valid = (flat_scores != 0.0) & in_bounds[None, :]
    ids = base_ids[None, :] + (np.arange(k, dtype=base_ids.dtype) * size)[:, None]
    sel = flat_valid.reshape(-1)
    ids_sel = ids.reshape(-1)[sel]
    sums = np.bincount(ids_sel, weights=flat_scores.reshape(-1)[sel],
                       minlength=k * size)
    counts = np.bincount(ids_sel, minlength=k * size)
    out = np.where(counts > 0, sums / np.maximum(counts, 1), 0.0)
    return out.reshape(k, n_actors, n_frames)


def _zero_runs(mask: np.ndarray):
    """[(start, end)] inclusive index ranges where mask is True."""
    if not mask.any():
        return []
    padded = np.concatenate([[False], mask, [False]])
    diff = np.diff(padded.astype(np.int8))
    starts = np.nonzero(diff == 1)[0]
    ends = np.nonzero(diff == -1)[0] - 1
    return list(zip(starts, ends))


def pad_scores(fig_scores: np.ndarray, n_frames_gt: int, pad_size: int) -> np.ndarray:
    """Zero out `pad_size` frames around each actor-absence interval.

    Faithful port of reference utils/eval_utils.py:232-248. `fig_scores` is
    one actor's [n_frames] score row; absence = score exactly 0. Only frames
    0..n_frames_gt-2 participate in interval detection (reference's
    `range(len(gt)-1)`).
    """
    out = np.array(fig_scores, dtype=np.float64)
    considered = out[: n_frames_gt - 1] == 0.0
    for start, end in _zero_runs(considered):
        if start == 0 and end == n_frames_gt - 2:
            continue  # actor absent for the whole clip
        if start == 0:
            lo, hi = start, min(end + pad_size, n_frames_gt)
        elif end == n_frames_gt - 2:
            lo, hi = max(start - pad_size, 0), end
        else:
            lo, hi = max(start - pad_size, 0), min(end + pad_size, n_frames_gt)
        out[lo:hi] = 0.0
    return out
