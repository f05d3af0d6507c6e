"""Serving API: score pose windows and clips (counterpart of `coskad_tpu/serve.py`).

    scorer = AnomalyScorer(cfg, state, trainer)       # device="cuda" by default
    scores = scorer.score_windows(windows)            # [B] anomaly scores
    frames = scorer.score_clip_json("01_0014.json")   # per-frame scores

Scoring runs the Trainer's eager pass (gather, eval forward through the
fused encoder kernel on CUDA, variant distance). Windows are scored
unpadded: the JAX package pads requests to size buckets only to bound its
recompiles, and eval rows are independent. Clip scoring reuses the offline
aggregation (actor max, shift + Gaussian smoothing) without ground truth.
Loading a checkpoint comes with the checkpoint slice (ROADMAP.md, Queue 1
item 3).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from .config import Config, config_from_snapshot
from .data.alphapose import parse_clip_json
from .data.normalize import normalize
from .data.windows import SegmentDataset, keypoints17_to_coco18, segment_clip
from .score.frames import actor_frame_scores, pad_scores
from .score.smoothing import score_process
from .train.loop import Trainer
from .train.state import TrainState

__all__ = ["AnomalyScorer", "config_from_snapshot"]


class AnomalyScorer:
    """Scorer for one trained encoder-only COSKAD variant.

    `trainer.model` holds the weights and `state` the center; without a
    trainer one is built on `device` over a placeholder dataset."""

    def __init__(self, cfg: Config, state: TrainState, trainer: Optional[Trainer] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.cfg = cfg
        if trainer is None:
            dummy = SegmentDataset(
                data=np.zeros(
                    (1, cfg.model.num_coords + 1, cfg.data.seg_len, cfg.data.n_joints),
                    np.float32),
                meta=np.zeros((1, 4), np.int64),
                frame_ids=np.zeros((1, cfg.data.seg_len), np.int32),
                num_transform=cfg.data.num_transform,
            )
            trainer = Trainer(cfg, dummy, device=device)
        self.trainer = trainer
        self.state = state

    @classmethod
    def from_checkpoint(cls, ckpt_path: str, cfg: Optional[Config] = None):
        raise NotImplementedError(
            "checkpoints are not ported yet (ROADMAP.md, Queue 1 item 3); build the "
            "scorer from a Trainer whose model holds the weights")

    def score_windows(self, windows: np.ndarray) -> np.ndarray:
        """[B, C, T, V] normalized windows -> [B] anomaly scores (higher =
        more anomalous)."""
        windows = np.ascontiguousarray(windows, np.float32)
        n = len(windows)
        if n == 0:
            return np.zeros(0, np.float32)
        ds = SegmentDataset(
            data=windows,
            meta=np.zeros((n, 4), np.int64),
            frame_ids=np.zeros((n, self.cfg.data.seg_len), np.int32),
            num_transform=1,
        )
        scores, _ = self.trainer.score_all(self.state, ds, self.trainer._device_data(ds))
        return scores

    def preprocess_windows(self, raw: np.ndarray) -> np.ndarray:
        """Raw keypoint windows [N, T, V, F] -> model-ready [N, C, T, V]:
        17->18 conversion, headless crop, the config's normalization."""
        d = self.cfg.data
        if d.kp18_format and raw.shape[-2] == 17:
            raw = keypoints17_to_coco18(raw)
        if d.headless:
            raw = raw[:, :, :14]
        if d.normalize_pose:
            raw, _ = normalize(raw, d.normalization_strategy, vid_res=d.vid_res,
                               symm_range=d.symm_range, sub_mean=d.sub_mean)
        return np.transpose(raw, (0, 3, 1, 2)).astype(np.float32)

    def score_clip_json(self, path: str, n_frames: Optional[int] = None,
                        smooth: bool = True) -> np.ndarray:
        """AlphaPose clip JSON -> per-frame anomaly scores.

        Windows each tracked person at stride 1, scores all windows, scatters
        to frames (mean per actor, max over actors) and optionally applies
        the shift + smooth post-processing, as offline eval does."""
        d = self.cfg.data
        trajectories = parse_clip_json(path, d.kp_threshold)
        data, meta, ids = segment_clip(trajectories, 0, 0, d.start_offset, 1, d.seg_len)
        if len(meta) == 0:
            if n_frames is None:
                raise ValueError(
                    f"clip {path!r} has no tracked people; pass n_frames to get an "
                    "all-zero score vector")
            return np.zeros(n_frames)
        scores = self.score_windows(self.preprocess_windows(data))

        meta = np.asarray(meta)
        ids = np.asarray(ids)
        if n_frames is None:
            n_frames = int(ids.max())
        actors = np.unique(meta[:, 2])
        dense = np.searchsorted(actors, meta[:, 2])
        per_actor = actor_frame_scores(scores, dense, ids, n_frames, len(actors))
        if self.cfg.eval.pad_size != -1:
            per_actor = np.stack([
                pad_scores(row, n_frames, self.cfg.eval.pad_size) for row in per_actor])
        clip_score = per_actor.max(axis=0)
        if smooth:
            clip_score = score_process(clip_score)
        return clip_score
