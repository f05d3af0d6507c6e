"""Serving API: score pose windows and clips (counterpart of `coskad_tpu/serve.py`).

    scorer = AnomalyScorer.from_checkpoint("best.ckpt")  # device="cuda" by default
    scorer = AnomalyScorer(cfg, state, trainer)           # or from a live Trainer
    scores = scorer.score_windows(windows)                # [B] anomaly scores
    frames = scorer.score_clip_json("01_0014.json")       # per-frame scores

Scoring runs the Trainer's eager pass (gather, eval forward through the
fused encoder kernel on CUDA, K1 or its bf16 form, variant distance): the latent
distance to the center for the euclidean variants and the autoencoder, the
geodesic distance for the hyperbolic one, and the cosine distance to the
anchor `mean_vector` for the VAE. Windows are scored
unpadded: the JAX package pads requests to size buckets only to bound its
recompiles, and eval rows are independent. Clip scoring reuses the offline
aggregation (actor max, shift + Gaussian smoothing) without ground truth.
A checkpoint of either package loads through `from_checkpoint`, with the
config from its `<ckpt>.config.json` snapshot and the robust scaler it
carries.
"""

from __future__ import annotations

import itertools
from typing import Optional, Union

import numpy as np
import torch

from .config import Config, config_from_snapshot
from .data.alphapose import parse_clip_json
from .data.normalize import RobustScalerState, normalize, normalize_robust
from .data.windows import SegmentDataset, keypoints17_to_coco18, segment_clip
from .score.frames import actor_frame_scores, pad_scores
from .score.smoothing import score_process
from .train import checkpoint
from .train.loop import Trainer
from .train.state import TrainState
from .utils.profiling import span

__all__ = ["AnomalyScorer", "config_from_snapshot"]

# each request's number in the process, the `request` span's label in a trace
_request_numbers = itertools.count(1)


class AnomalyScorer:
    """Scorer for one trained COSKAD variant.

    `trainer.model` holds the weights and `state` the center; without a
    trainer one is built on `device` over a placeholder dataset. `scaler` is
    the training-fitted robust scaler, which robust normalization needs
    (`from_checkpoint` sets it from the checkpoint)."""

    def __init__(self, cfg: Config, state: TrainState, trainer: Optional[Trainer] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.cfg = cfg
        self.scaler: Optional[RobustScalerState] = None
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
    def from_checkpoint(cls, ckpt_path: str, cfg: Optional[Config] = None,
                        device: Union[str, torch.device] = "cuda") -> "AnomalyScorer":
        """A scorer from a checkpoint written by either package; the config
        defaults to the `<ckpt>.config.json` snapshot beside it."""
        if cfg is None:
            cfg = config_from_snapshot(ckpt_path + ".config.json")
        scorer = cls(cfg, None, device=device)
        scorer.state, scorer.scaler, _ = checkpoint.restore(ckpt_path, scorer.trainer)
        checkpoint.require_vae_anchor(cfg, scorer.state, ckpt_path)
        return scorer

    def score_windows(self, windows: np.ndarray) -> np.ndarray:
        """[B, C, T, V] normalized windows -> [B] anomaly scores (higher =
        more anomalous)."""
        with span("request", str(next(_request_numbers))):
            with span("request.prepare"):
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
            with span("request.upload"):
                data = self.trainer._device_data(ds)
            scores, _ = self.trainer.score_all(self.state, ds, data)
            return scores

    def preprocess_windows(self, raw: np.ndarray) -> np.ndarray:
        """Raw keypoint windows [N, T, V, F] -> model-ready [N, C, T, V]:
        17->18 conversion, headless crop, the config's normalization."""
        d = self.cfg.data
        if d.kp18_format and raw.shape[-2] == 17:
            raw = keypoints17_to_coco18(raw)
        if d.headless:
            raw = raw[:, :, :14]
        if d.normalize_pose and d.normalization_strategy == "robust":
            # Quantiles fitted on each request would put every batch in its
            # own coordinates: robust scoring takes the training scaler only.
            if self.scaler is None:
                raise ValueError("robust normalization needs the training-fitted scaler: "
                                 "load the checkpoint that carries it")
            raw, _ = normalize_robust(raw, vid_res=d.vid_res, symm_range=d.symm_range,
                                      scaler=self.scaler)
        elif d.normalize_pose:
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
