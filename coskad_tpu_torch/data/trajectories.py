"""Morais-format trajectory toolkit, the UBnormal 'robust' data path (numpy).

Counterpart of `coskad_tpu/data/trajectories.py`: CSV trajectories per
(clip folder, person), bounding boxes with 10% margins, global (bbox centre
+ size) and local (bbox-centre- or top-left-relative) coordinates,
short-trajectory filtering, missing-step interpolation, sliding-window
aggregation with frame subsampling, and three scaling strategies with
exact-zero -> NaN missing-value masking, which `data/robust.py` runs; and
the reference's Morais-style tools no path of the package calls: the
ground-truth masks and their frame-level assembly, the length-stratified
train / validation split and the removal of missing skeletons. A split's CSVs are
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
from typing import Dict, List, Tuple

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

    def is_short(self, input_length: int, input_gap: int, pred_length: int = 0) -> bool:
        return len(self) < input_length + input_gap * (input_length - 1) + pred_length

    def global_features(self, video_resolution, extract_delta: bool = False,
                        use_first_step_as_reference: bool = False) -> np.ndarray:
        """[T, 4]: bbox centre (x, y) + bbox (width, height) per frame; with
        `extract_delta` [T, 6], the centre's step-to-step change (1e-7 at
        the first step) after the centre; `use_first_step_as_reference`
        makes the centre relative to the first step's (plus 1e-6 there)."""
        n = len(self.coordinates)
        centre = np.zeros((n, 2), dtype=np.float32)
        size = np.zeros((n, 2), dtype=np.float32)
        for i, kps in enumerate(self.coordinates):
            left, right, top, bottom = compute_bounding_box(kps, video_resolution)
            centre[i] = [(left + right) / 2, (top + bottom) / 2]
            size[i] = [right - left, bottom - top]
        delta = None
        if extract_delta:
            delta = np.vstack([np.full((1, 2), 1e-7, np.float32), np.diff(centre, axis=0)])
        if use_first_step_as_reference:
            centre = centre - centre[0]
            centre[0] += 1e-6
        if extract_delta:
            return np.hstack([centre, delta, size])
        return np.hstack([centre, size])

    def size_features(self, video_resolution) -> np.ndarray:
        """[T, 2]: the bbox (width, height) per frame."""
        return self.global_features(video_resolution)[:, 2:]

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

    def to_bounding_box_top_left(self, video_resolution) -> "Trajectory":
        """Per frame: relative to the bbox's top-left corner, divided by its
        width and height; missing keypoints land at the corner (= 0)."""
        coords = self.coordinates
        for idx in range(len(coords)):
            kps = coords[idx]
            if not np.any(kps):
                continue
            left, right, top, bottom = compute_bounding_box(kps, video_resolution)
            xs = kps.reshape(-1, 2)[:, 0].copy()
            ys = kps.reshape(-1, 2)[:, 1].copy()
            xs = (np.where(xs == 0.0, float(left), xs) - left) / (right - left)
            ys = (np.where(ys == 0.0, float(top), ys) - top) / (bottom - top)
            coords[idx] = np.stack([xs, ys], axis=1).ravel()
        return self

    def change_coordinate_system(self, video_resolution, coordinate_system="global"):
        """One of 'global', 'bounding_box_centre', 'bounding_box_top_left'."""
        if coordinate_system == "global":
            return self.to_global_coordinates(video_resolution)
        if coordinate_system == "bounding_box_centre":
            return self.to_bounding_box_centre(video_resolution)
        if coordinate_system == "bounding_box_top_left":
            return self.to_bounding_box_top_left(video_resolution)
        raise ValueError(f"Unknown coordinate system {coordinate_system!r}")

    def input_missing_steps(self) -> "Trajectory":
        """Fully missing steps filled by linear interpolation between the
        nearest observed ones; a coordinate missing at either end stays 0
        (reference utils/data.py:192-216)."""
        coords = self.coordinates
        t, d = coords.shape
        missing = np.sum(coords == 0, axis=1) == d
        last_obs, i = 0, 1
        while i < t:
            if not missing[i]:
                last_obs = i
                i += 1
                continue
            j = i
            while j < t and missing[j]:
                j += 1
            if j < t:
                start, end = coords[last_obs], coords[j]
                gap = j - last_obs
                for n in range(1, gap):
                    fill = (gap - n) / gap * start + n / gap * end
                    coords[last_obs + n] = np.where((start == 0) | (end == 0), 0.0, fill)
            i = j
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


def remove_short_trajectories(trajectories, input_length: int, input_gap: int,
                              pred_length: int = 0):
    return {tid: tr for tid, tr in trajectories.items()
            if not tr.is_short(input_length, input_gap, pred_length)}


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


# ---------------------------------------------------------------- gt masks


def load_anomaly_masks(anomaly_masks_path: str) -> Dict[str, np.ndarray]:
    """{video id: frame mask} from <path>/<video id>.npy."""
    return {fn.split(".")[0]: np.load(os.path.join(anomaly_masks_path, fn))
            for fn in os.listdir(anomaly_masks_path)}


def assemble_ground_truth_and_reconstructions(anomaly_masks: Dict[str, np.ndarray],
                                              trajectory_ids: np.ndarray,
                                              reconstruction_frames: np.ndarray,
                                              reconstruction_errors: np.ndarray,
                                              return_video_ids: bool = False):
    """Morais-style frame-level assembly: each video's score at a (1-based)
    frame is the largest of its trajectories' there (reference
    utils/data.py:434-463). Returns (y_true, y_hat) over the videos in
    sorted order, and each frame's video id with `return_video_ids`."""
    y_true = {vid: m.astype(np.int32) for vid, m in anomaly_masks.items()}
    y_hat = {vid: np.zeros_like(m, dtype=np.float32) for vid, m in y_true.items()}
    for tid in np.unique(trajectory_ids):
        video_id = tid.split("_")[0]
        sel = trajectory_ids == tid
        frames = reconstruction_frames[sel] - 1
        y_hat[video_id][frames] = np.maximum(y_hat[video_id][frames],
                                             reconstruction_errors[sel])
    ys, hats, vids = [], [], []
    for vid in sorted(y_true):
        ys.append(y_true[vid])
        hats.append(y_hat[vid])
        vids.extend([vid] * len(y_true[vid]))
    out = (np.concatenate(ys), np.concatenate(hats))
    return (*out, vids) if return_video_ids else out


def split_into_train_and_test(trajectories, train_ratio: float = 0.8, seed: int = 42):
    """A random split stratified by length quartile (reference
    utils/data.py:265-293), seeding numpy's legacy global generator as the
    reference does, so a seed gives its split."""
    np.random.seed(seed)
    ids = list(trajectories.keys())
    order = np.argsort([len(trajectories[t]) for t in ids])
    q1, q2, q3 = (round(len(order) * q) for q in (0.25, 0.5, 0.75))
    sorted_ids = np.array(ids)[order]
    train_ids, val_ids = [], []
    bounds = [0, q1, q2, q3, len(order)]
    for i in range(1, len(bounds)):
        q_ids = np.random.permutation(sorted_ids[bounds[i - 1]:bounds[i]])
        k = round(len(q_ids) * train_ratio)
        train_ids.extend(q_ids[:k])
        val_ids.extend(q_ids[k:])
    return (OrderedDict((t, trajectories[t]) for t in train_ids),
            OrderedDict((t, trajectories[t]) for t in val_ids))


def remove_missing_skeletons(x: np.ndarray, *arrs):
    """Drop the rows whose keypoints are all missing (reference
    utils/data.py:406-414): (x's kept rows, [each array's kept rows])."""
    keep = np.sum(np.abs(x), axis=1) > 0.0
    return x[keep], [a[keep] for a in arrs]
