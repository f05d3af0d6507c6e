"""Full anomaly-scoring pipeline: window scores -> frame AUC-ROC.

Replaces the reference's 4-deep Python loop (eval_COSKAD.py:140-253 and the
per-module `post_processing` copies, e.g. euclidean_encoder_staticCenter.py:
228-310) with a vectorized pass. Semantics are kept exactly:

  for each transformation:
    for each (scene, clip) in sorted ground-truth order:
      for each actor: scatter window scores to frames, mean non-zero,
                      optional pad_scores
      clip score = max over actors per frame
      optional HR mask (Avenue hardcoded table / UBnormal npy masks)
      shift + Gaussian smooth (score_process)
    concat clips -> transform score vector
  final score = mean over transformations; AUC against ground truth.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .auc import roc_auc_score
from .frames import actor_frame_scores, actor_frame_scores_multi, pad_scores
from .smoothing import SHIFT, score_process


@dataclass
class ScoringConfig:
    num_transform: int = 5
    pad_size: int = -1  # -1 disables pad_scores
    smoothing_sigma: float = 30.0
    shift: int = SHIFT


@dataclass
class EvalResult:
    auc: float
    per_transform_auc: List[float]
    # transform-0 per-clip AUCs (back-compat convenience view)
    per_clip_auc: Dict[Tuple[int, int], float] = field(default_factory=dict)
    # every transform, like the reference's per-iteration printout
    # (eval_COSKAD.py:222-230): {(transform, scene, clip): auc}
    per_clip_auc_all: Dict[Tuple[int, int, int], float] = field(default_factory=dict)
    scores: Optional[np.ndarray] = None  # final per-frame scores (masked+smoothed)
    gt: Optional[np.ndarray] = None
    # per-transform smoothed score/gt vectors (the reference's
    # model_scores_transf/dataset_gt_transf, eval_COSKAD.py:244-245) —
    # feed the per-transform ROC PNGs and best thresholds
    per_transform_scores: List[np.ndarray] = field(default_factory=list)
    per_transform_gt: List[np.ndarray] = field(default_factory=list)


def evaluate_windows(
    window_scores: np.ndarray,
    trans: np.ndarray,
    meta: np.ndarray,
    frame_ids: np.ndarray,
    ground_truths: Dict[Tuple[int, int], np.ndarray],
    cfg: ScoringConfig,
    hr_clip_masks: Optional[Dict[Tuple[int, int], np.ndarray]] = None,
    avenue_clip_masks: Optional[Dict[int, np.ndarray]] = None,
    save_scores_dir: Optional[str] = None,
) -> EvalResult:
    """Aggregate per-window anomaly scores into a frame-level AUC.

    Raises a clear error for an empty ground-truth dict up front — the
    np.concatenate it would otherwise hit deep in the transform loop says
    nothing about the actual cause (an empty or mispointed gt_dir).

    Args:
        window_scores: [N] scalar anomaly score per (window, transform) item,
            transform-major (item i = window i % NW of transform i // NW).
        trans: [N] transform index per item.
        meta: [N, 4] (scene_id, clip_id, person_id, start_frame) — or
            [NW, 4] with NW = N / num_transform, shared across transforms
            (what the CLI/validation call sites have: the reference expands
            the dataset 5x with identical metadata per transform,
            utils/dataset.py:65-80; passing the base array skips re-sorting
            and re-gathering identical rows num_transform times, the
            dominant host cost at UBnormal scale). With shared meta, trans
            may be None.
        frame_ids: [N, T] actual frame keys covered by each window ([NW, T]
            in the shared-meta form).
        ground_truths: {(scene, clip): [n_frames] binary labels}, iterated in
            sorted key order like the reference's sorted gt-file listing.
        cfg: scoring configuration.
        hr_clip_masks: optional {(scene, clip): bool mask} (HR-UBnormal).
        avenue_clip_masks: optional {clip: bool mask} (HR-Avenue table).
        save_scores_dir: when set, dump transform-0 per-clip artifacts in the
            layout the reference's analysis notebook reads
            (visualize/visualize.ipynb: `saved_clip_scores/
            error_per_person_scene_{s}_scenario_{c}.npy` [P, F] + `gt_masks/
            scene_{s}_scenario_{c}.npy`) for plot_person_scores et al.
    """
    if not ground_truths:
        raise ValueError(
            "ground_truths is empty — no '<scene>_<clip>.npy' masks were "
            "found; check the configured gt directory (test_path / gt_path)"
        )
    window_scores = np.asarray(window_scores)
    meta = np.asarray(meta)
    frame_ids = np.asarray(frame_ids)
    hr_clip_masks = hr_clip_masks or {}
    avenue_clip_masks = avenue_clip_masks or {}

    clip_keys = sorted(ground_truths.keys())
    per_transform_scores: List[np.ndarray] = []
    per_transform_gt: List[np.ndarray] = []
    per_transform_auc: List[float] = []
    per_clip_auc: Dict[Tuple[int, int], float] = {}
    per_clip_auc_all: Dict[Tuple[int, int, int], float] = {}

    # Shared-meta fast path: metadata identical across transforms -> sort
    # and gather the NW base rows once instead of num_transform times.
    n_items = len(window_scores)
    nw = n_items // max(cfg.num_transform, 1)
    shared = len(meta) == nw and (cfg.num_transform == 1 or nw != n_items)
    if shared:
        order = np.lexsort((meta[:, 1], meta[:, 0]))
        trans_s = None
    else:
        trans = np.asarray(trans)
        # One lexicographic sort by (transform, scene, clip) replaces
        # num_transform * num_clips full-array boolean masks (O(T*C*N) ->
        # O(N log N)); per-group rows are contiguous searchsorted slices.
        order = np.lexsort((meta[:, 1], meta[:, 0], trans))
        trans_s = trans[order]
    meta_s = meta[order]
    frames_s = frame_ids[order]
    scores_s = None if shared else window_scores[order]
    # Composite sort key for range lookup. Multipliers must cover the ids in
    # BOTH meta and the ground-truth keys: a gt clip with no detections and a
    # larger id than any detected clip would otherwise collide with another
    # (scene, clip) group's key and steal its windows.
    max_clip = int(meta[:, 1].max()) if len(meta) else 0
    max_scene = int(meta[:, 0].max()) if len(meta) else 0
    if clip_keys:
        max_scene = max(max_scene, max(k[0] for k in clip_keys))
        max_clip = max(max_clip, max(k[1] for k in clip_keys))
    scene_mult = max(max_clip, 0) + 1
    trans_mult = (max(max_scene, 0) + 1) * scene_mult
    key_s = meta_s[:, 0] * scene_mult + meta_s[:, 1]
    if not shared:
        key_s = key_s + trans_s * trans_mult

    # Clip-outer / transform-inner: with shared metadata, the window->frame
    # scatter structure (slice, fig_ids, flat ids) of a clip is identical
    # across transforms, so it is computed ONCE per clip and all transforms
    # scatter in a single bincount (actor_frame_scores_multi). Output is
    # bit-identical to the transform-outer formulation; only the host time
    # changes (0.83 s -> see scripts/bench_eval_aggregation.py).
    k_t = cfg.num_transform
    clip_scores_by_t: List[List[np.ndarray]] = [[] for _ in range(k_t)]
    gt_list: List[np.ndarray] = []
    for scene_idx, clip_idx in clip_keys:
        gt_full = np.asarray(ground_truths[(scene_idx, clip_idx)])
        n_frames = gt_full.shape[0]
        base_key = scene_idx * scene_mult + clip_idx

        per_actor_all = fig_ids = None
        if shared:
            lo = np.searchsorted(key_s, base_key, side="left")
            hi = np.searchsorted(key_s, base_key, side="right")
            meta_sc = meta_s[lo:hi]
            frames_sc = frames_s[lo:hi]
            if len(meta_sc):
                fig_ids = np.unique(meta_sc[:, 2])
                dense = np.searchsorted(fig_ids, meta_sc[:, 2])
                rows = order[lo:hi]
                scores_mat = window_scores[
                    (np.arange(k_t) * nw)[:, None] + rows[None, :]
                ]
                per_actor_all = actor_frame_scores_multi(
                    scores_mat, dense, frames_sc, n_frames, len(fig_ids)
                )

        for transformation in range(k_t):
            gt = gt_full
            if shared:
                per_actor = (per_actor_all[transformation]
                             if per_actor_all is not None else None)
            else:
                key = base_key + transformation * trans_mult
                lo = np.searchsorted(key_s, key, side="left")
                hi = np.searchsorted(key_s, key, side="right")
                meta_sc = meta_s[lo:hi]
                frames_sc = frames_s[lo:hi]
                scores_sc = scores_s[lo:hi]
                per_actor = None
                if len(meta_sc):
                    fig_ids = np.unique(meta_sc[:, 2])
                    dense = np.searchsorted(fig_ids, meta_sc[:, 2])
                    per_actor = actor_frame_scores(
                        scores_sc, dense, frames_sc, n_frames, len(fig_ids)
                    )

            if per_actor is None:
                # No detected person at all: the clip scores 0 everywhere.
                fig_ids = np.zeros((0,), np.int64)
                per_actor_raw = np.zeros((1, n_frames))
                clip_score = np.zeros(n_frames)
            else:
                # Raw (pre-pad) per-person scores: the notebook's
                # error_per_person dumps are the raw scatter output, before
                # the pad_scores zeroing pass (visualize.ipynb reads them to
                # re-apply shift+smoothing itself).
                per_actor_raw = per_actor
                if cfg.pad_size != -1:
                    per_actor = np.stack(
                        [pad_scores(row, n_frames, cfg.pad_size)
                         for row in per_actor]
                    )
                clip_score = np.amax(per_actor, axis=0)

            if save_scores_dir is not None and transformation == 0:
                import os

                os.makedirs(os.path.join(save_scores_dir, "gt_masks"),
                            exist_ok=True)
                np.save(os.path.join(
                    save_scores_dir,
                    f"error_per_person_scene_{scene_idx}_scenario_{clip_idx}.npy",
                ), per_actor_raw)
                # Row->actor map for the epp matrix: only actors that
                # produced windows get a row, and the viewer cannot infer
                # that set from the clip JSON (short trajectories yield no
                # windows). Columns are absolute 0-based frame indices.
                np.save(os.path.join(
                    save_scores_dir,
                    f"fig_ids_scene_{scene_idx}_scenario_{clip_idx}.npy",
                ), fig_ids)
                np.save(os.path.join(
                    save_scores_dir, "gt_masks",
                    f"scene_{scene_idx}_scenario_{clip_idx}.npy"), gt)

            if (scene_idx, clip_idx) in hr_clip_masks:
                m = hr_clip_masks[(scene_idx, clip_idx)]
                if m.shape[0] != clip_score.shape[0]:
                    raise ValueError(
                        f"HR mask for clip ({scene_idx}, {clip_idx}) has "
                        f"{m.shape[0]} frames but the clip scored "
                        f"{clip_score.shape[0]} — the hr_bool_masks tree "
                        "does not belong to this dataset"
                    )
                clip_score = clip_score[m]
                gt = gt[m]
            elif clip_idx in avenue_clip_masks:
                m = avenue_clip_masks[clip_idx]
                if m.shape[0] != clip_score.shape[0]:
                    # Built-in HR-Avenue masks are keyed by clip id alone
                    # (reference eval_COSKAD.py:22-39); data that is not the
                    # real Avenue test set but reuses its clip ids would
                    # otherwise die on an opaque boolean-index mismatch.
                    raise ValueError(
                        f"built-in HR-Avenue mask for clip {clip_idx} covers "
                        f"{m.shape[0]} frames but the clip scored "
                        f"{clip_score.shape[0]} — is non-Avenue data running "
                        "under dataset_choice HR-Avenue? Use a different "
                        "dataset_choice (or use_hr: false) for non-Avenue "
                        "data"
                    )
                clip_score = clip_score[m]
                gt = gt[m]

            clip_score = score_process(clip_score, cfg.smoothing_sigma,
                                       cfg.shift)
            clip_scores_by_t[transformation].append(clip_score)
            if transformation == 0:
                gt_list.append(gt)

            # The reference computes per-clip AUC inside EVERY transform
            # iteration (eval_COSKAD.py:222-230); keep all of them.
            try:
                clip_auc = roc_auc_score(gt, clip_score)
            except ValueError:
                clip_auc = float("nan")  # single-class clip
            per_clip_auc_all[(transformation, scene_idx, clip_idx)] = clip_auc
            if transformation == 0 and not np.isnan(clip_auc):
                per_clip_auc[(scene_idx, clip_idx)] = clip_auc

    dataset_gt = np.concatenate(gt_list, axis=0)
    for transformation in range(k_t):
        model_scores = np.concatenate(clip_scores_by_t[transformation], axis=0)
        per_transform_scores.append(model_scores)
        per_transform_gt.append(dataset_gt)
        per_transform_auc.append(roc_auc_score(dataset_gt, model_scores))

    final_scores = np.mean(np.stack(per_transform_scores, 0), 0)
    final_gt = per_transform_gt[0]
    auc = roc_auc_score(final_gt, final_scores)
    return EvalResult(
        auc=auc,
        per_transform_auc=per_transform_auc,
        per_clip_auc=per_clip_auc,
        per_clip_auc_all=per_clip_auc_all,
        scores=final_scores,
        gt=final_gt,
        per_transform_scores=per_transform_scores,
        per_transform_gt=per_transform_gt,
    )
