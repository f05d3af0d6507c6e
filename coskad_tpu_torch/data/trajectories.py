"""Morais-format trajectory toolkit, the UBnormal 'robust' data path (numpy).

Counterpart of `coskad_tpu/data/trajectories.py`, for what
`data/robust.py` runs: CSV trajectories per (clip folder, person),
bounding boxes with 10% margins, global (bbox centre + size) and local
(bbox-centre-relative) coordinates, short-trajectory filtering,
sliding-window aggregation with frame subsampling, and three scaling
strategies with exact-zero -> NaN missing-value masking. A split's CSVs are
read in one batch by the native C++ reader (`data/native.py`, float64 then
float32) unless COSKAD_NATIVE=0 or no toolchain builds it; then one by one
by `_read_csv`.

Window semantics: windows hop by ONE frame; `seg_stride` becomes an
intra-window frame gap (step = stride, window span = L + (stride-1) * (L-1)).
"""

from __future__ import annotations

import os
from collections import OrderedDict
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from .normalize import RobustScalerState


def compute_bounding_box(keypoints: np.ndarray, video_resolution) -> Tuple:
    """(left, right, top, bottom) ints of the non-missing keypoints with a
    10% margin, clipped to the frame."""
    width, height = video_resolution
    kp = np.asarray(keypoints).reshape(-1, 2)
    x, y = kp[:, 0], kp[:, 1]
    x, y = x[x != 0.0], y[y != 0.0]
    if len(x) == 0 or len(y) == 0:
        return 0, 0, 0, 0
    left, right, top, bottom = np.min(x), np.max(x), np.min(y), np.max(y)
    extra_w, extra_h = 0.1 * (right - left + 1), 0.1 * (bottom - top + 1)
    left = np.clip(left - extra_w, 0, width - 1)
    right = np.clip(right + extra_w, 0, width - 1)
    top = np.clip(top - extra_h, 0, height - 1)
    bottom = np.clip(bottom + extra_h, 0, height - 1)
    return int(round(left)), int(round(right)), int(round(top)), int(round(bottom))


@dataclass
class Trajectory:
    """One person's keypoint trajectory: frames [T], coordinates [T, 2*V]."""

    trajectory_id: str
    frames: np.ndarray
    coordinates: np.ndarray

    @property
    def person_id(self) -> str:
        return self.trajectory_id.split("_")[1]

    def __len__(self) -> int:
        return len(self.frames)

    def is_short(self, input_length: int, input_gap: int) -> bool:
        return len(self) < input_length + input_gap * (input_length - 1)

    def global_features(self, video_resolution) -> np.ndarray:
        """[T, 4]: bbox centre (x, y) + bbox (width, height) per frame."""
        n = len(self.coordinates)
        centre = np.zeros((n, 2), dtype=np.float32)
        size = np.zeros((n, 2), dtype=np.float32)
        for i, kps in enumerate(self.coordinates):
            left, right, top, bottom = compute_bounding_box(kps, video_resolution)
            centre[i] = [(left + right) / 2, (top + bottom) / 2]
            size[i] = [right - left, bottom - top]
        return np.hstack([centre, size])

    def use_global_features(self, video_resolution) -> "Trajectory":
        self.coordinates = self.global_features(video_resolution)
        return self

    def to_global_coordinates(self, video_resolution) -> "Trajectory":
        """Divide all coordinate pairs by the video resolution."""
        res = np.asarray(video_resolution, dtype=np.float32)
        shape = self.coordinates.shape
        self.coordinates = (self.coordinates.reshape(-1, 2) / res).reshape(shape)
        return self

    def to_bounding_box_centre(self, video_resolution) -> "Trajectory":
        """Per frame: subtract the bbox centre, divide by the bbox width and
        height; missing keypoints land at the centre (= 0)."""
        coords = self.coordinates
        for idx in range(len(coords)):
            kps = coords[idx]
            if not np.any(kps):
                continue
            left, right, top, bottom = compute_bounding_box(kps, video_resolution)
            cx, cy = (left + right) / 2.0, (top + bottom) / 2.0
            xs = kps.reshape(-1, 2)[:, 0].copy()
            ys = kps.reshape(-1, 2)[:, 1].copy()
            xs = np.where(xs == 0.0, cx, xs) - cx
            ys = np.where(ys == 0.0, cy, ys) - cy
            width, height = float(right - left), float(bottom - top)
            xs = xs / width if width != 0 else np.zeros_like(xs)
            ys = ys / height if height != 0 else np.zeros_like(ys)
            coords[idx] = np.stack([xs, ys], axis=1).ravel()
        return self


def _read_csv(path: str) -> np.ndarray:
    """One Morais CSV -> float32 [rows, cols] by numpy's loadtxt."""
    return np.loadtxt(path, dtype=np.float32, delimiter=",", ndmin=2)


def load_trajectories(trajectories_path: str, debug: bool = False, split: str = "train"
                      ) -> "OrderedDict[str, Trajectory]":
    """Walk <path>/<clip_folder>/<person>.csv in os.listdir order; id =
    '<folder>_<person>'. A debug train split keeps the first 5 folders. The
    files are parsed in one batch on the native reader's thread pool unless
    COSKAD_NATIVE=0 (or it does not build), else by `_read_csv`."""
    trajectories: OrderedDict[str, Trajectory] = OrderedDict()
    folders = os.listdir(trajectories_path)
    if debug and split == "train":
        folders = folders[:5]
    tids, paths = [], []
    for folder in folders:
        for csv_name in os.listdir(os.path.join(trajectories_path, folder)):
            tids.append(folder + "_" + csv_name.split(".")[0])
            paths.append(os.path.join(trajectories_path, folder, csv_name))
    arrays = None
    if paths and os.environ.get("COSKAD_NATIVE", "1") != "0":
        from .native import load_csv_files_native

        arrays = load_csv_files_native(paths)
        if arrays is not None:
            arrays = [a.astype(np.float32) for a in arrays]
    if arrays is None:
        arrays = [_read_csv(p) for p in paths]
    for tid, arr in zip(tids, arrays):
        trajectories[tid] = Trajectory(trajectory_id=tid, frames=arr[:, 0].astype(np.int32),
                                       coordinates=arr[:, 1:])
    return trajectories


def remove_short_trajectories(trajectories, input_length: int, input_gap: int):
    return {tid: tr for tid, tr in trajectories.items()
            if not tr.is_short(input_length, input_gap)}


def scene_clip_of(trajectory_id: str) -> Tuple[int, int]:
    """Folder names encode '<scene>-<clip>' before the person suffix."""
    scene, clip = trajectory_id.split("_")[0].split("-")
    return int(scene), int(clip)


def aggregate_windows(trajectories, input_length: int, input_gap: int = 0
                      ) -> Tuple[np.ndarray, List[List[int]], List[np.ndarray]]:
    """Sliding windows over every trajectory, hopping by one frame; frames
    within a window step by input_gap + 1. Returns (X [N, L, D], meta
    [scene, clip, person, start_frame], frame_ids [N, L])."""
    xs, metas, ids = [], [], []
    span = input_length + input_gap * (input_length - 1)
    step = input_gap + 1
    for tr in trajectories.values():
        stop = len(tr.coordinates) - span + 1
        if stop <= 0:
            continue
        scene_id, clip_id = scene_clip_of(tr.trajectory_id)
        for start in range(stop):
            xs.append(tr.coordinates[start:start + span:step])
            metas.append([scene_id, clip_id, int(tr.person_id), int(tr.frames[start])])
            ids.append(tr.frames[start:start + span:step])
    return np.stack(xs, axis=0), metas, ids


def aggregate_all_coordinates(trajectories) -> np.ndarray:
    """Every frame of every trajectory, stacked (the scaler's fitting input)."""
    return np.vstack([tr.coordinates for tr in trajectories.values()])


@dataclass
class MinMaxState:
    data_min: np.ndarray
    data_max: np.ndarray

    @classmethod
    def fit(cls, x):
        return cls(data_min=np.min(x, axis=0), data_max=np.max(x, axis=0))

    def transform(self, x):
        rng = self.data_max - self.data_min
        rng = np.where(rng == 0.0, 1.0, rng)
        return (x - self.data_min) / rng


@dataclass
class StdState:
    mu: np.ndarray
    sigma: np.ndarray
    stds: float = 3.0

    @classmethod
    def fit(cls, x, stds=3.0):
        return cls(mu=np.nanmean(x, axis=0), sigma=np.nanstd(x, axis=0), stds=stds)

    def transform(self, x):
        lo = self.mu - self.stds * self.sigma
        return (x - lo) / (2 * self.stds * self.sigma)


def scale_trajectories(x: np.ndarray, scaler=None, strategy: str = "robust"):
    """Strategy-dispatched scaling with exact-zero missing masking; fits a
    scaler when none is given. Returns (scaled x, scaler)."""
    shape = x.shape
    flat = x.reshape(-1, shape[-1]).astype(np.float64)
    if strategy == "zero_one":
        if scaler is None:
            masked = np.where(flat == 0.0, np.nan, flat)
            x_min = np.nanmin(masked, axis=0)
            x_min = np.where(np.isnan(x_min), 0.0, x_min)
            scaler = MinMaxState.fit(np.where(np.isnan(masked), x_min - 1e-3, masked))
        out = scaler.transform(np.where(flat == 0.0, scaler.data_min, flat))
    elif strategy in ("three_stds", "robust"):
        masked = np.where(flat == 0.0, np.nan, flat)
        if scaler is None:
            scaler = (StdState if strategy == "three_stds" else RobustScalerState).fit(masked)
        out = scaler.transform(masked)
        out = np.where(np.isnan(out), 0.0, out)
    else:
        raise ValueError(f"Unknown scaling strategy {strategy!r}")
    return out.reshape(shape), scaler
