"""Sliding-window segmentation of per-person keypoint trajectories.

Host-side, one-time preprocessing: turns ragged per-person frame dicts into
dense [N, T, V, F] window tensors + metadata. Semantics mirror the reference
exactly (utils/dataset_utils.py:155-253):

- windows start at `start_offset + i * stride`, and the final possible start
  position (clip_len - seg_len) is never emitted (ceil((len - seg_len) /
  stride) windows are attempted),
- a window is kept only if at most 2 of its expected consecutive frame keys
  are missing (`is_seg_continuous`, missing_th=2),
- metadata per window is [scene_id, clip_id, person_id, start_frame_key] and
- the actual (possibly gappy) frame keys covered are recorded for the
  window->frame scatter at scoring time.

Also provides the 17->18 keypoint COCO conversion (utils/dataset_utils.py:
7-19): neck = mean of shoulders, then a fixed reorder.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# COCO17 -> OpenPose18 ordering with the synthesized neck joint at index 17.
COCO17_TO_18_ORDER = np.array(
    [0, 17, 6, 8, 10, 5, 7, 9, 12, 14, 16, 11, 13, 15, 2, 1, 4, 3]
)


def keypoints17_to_coco18(kps: np.ndarray) -> np.ndarray:
    """[..., 17, F] -> [..., 18, F]; neck = mean of the two shoulders."""
    kps = np.asarray(kps)
    neck = 0.5 * (kps[..., 5, :] + kps[..., 6, :])
    kps18 = np.concatenate([kps, neck[..., None, :]], axis=-2)
    return kps18[..., COCO17_TO_18_ORDER, :]


def is_seg_continuous(
    sorted_keys: Sequence[int], start_key: int, seg_len: int, missing_th: int = 2
) -> bool:
    """True if at most `missing_th` of the expected consecutive frame keys
    starting at `start_key` are absent from the trajectory."""
    start_idx = sorted_keys.index(start_key)
    expected = set(range(start_key, start_key + seg_len))
    actual = sorted_keys[start_idx : start_idx + seg_len]
    return len(expected.intersection(actual)) >= seg_len - missing_th


def is_person_dict_continuous(frame_keys: Sequence[int]) -> bool:
    """Whole-trajectory continuity check (reference utils/dataset_utils.py:
    202-210): at most 2 frames missing over the person's full span."""
    keys = sorted(int(k) for k in frame_keys)
    return is_seg_continuous(keys, keys[0], len(keys))


@dataclass
class PersonTrajectory:
    """One tracked person's keypoints within one clip."""

    person_id: int
    frame_keys: List[int]  # numerically sorted frame keys
    keypoints: np.ndarray  # [len(frame_keys), V, F] in the same order


def split_trajectory_to_windows(
    traj: PersonTrajectory,
    scene_id: int,
    clip_id: int,
    start_offset: int = 0,
    stride: int = 1,
    seg_len: int = 12,
) -> Tuple[np.ndarray, List[List[int]], List[List[int]]]:
    """Window one trajectory; returns (data [n, seg_len, V, F], meta, frame_ids)."""
    clip_t = traj.keypoints.shape[0]
    keys = traj.frame_keys
    num_segs = int(np.ceil((clip_t - seg_len) / stride)) if clip_t > seg_len else 0
    out_data, out_meta, out_ids = [], [], []
    for seg_ind in range(max(num_segs, 0)):
        start_ind = start_offset + seg_ind * stride
        if start_ind >= clip_t:
            break
        start_key = keys[start_ind]
        if is_seg_continuous(keys, start_key, seg_len):
            window = traj.keypoints[start_ind : start_ind + seg_len]
            if window.shape[0] < seg_len:
                continue  # tail window shorter than seg_len
            out_data.append(window)
            out_meta.append([scene_id, clip_id, traj.person_id, start_key])
            out_ids.append(list(keys[start_ind : start_ind + seg_len]))
    if out_data:
        data = np.stack(out_data, axis=0)
    else:
        v, f = traj.keypoints.shape[1:]
        data = np.empty((0, seg_len, v, f))
    return data, out_meta, out_ids


def segment_clip(
    trajectories: Sequence[PersonTrajectory],
    scene_id: int,
    clip_id: int,
    start_offset: int = 0,
    stride: int = 1,
    seg_len: int = 12,
):
    """Window every person of a clip; returns (data, meta, frame_ids) stacked."""
    datas, metas, ids = [], [], []
    for traj in trajectories:
        d, m, i = split_trajectory_to_windows(
            traj, scene_id, clip_id, start_offset, stride, seg_len
        )
        datas.append(d)
        metas += m
        ids += i
    if datas:
        data = np.concatenate(datas, axis=0)
    else:
        data = np.empty((0, seg_len, 0, 0))
    return data, metas, ids


@dataclass
class SegmentDataset:
    """Dense window tensors + metadata for a whole split.

    `data` is [N, C, T, V] (channels first at the API boundary like the
    reference's NCHW transpose, utils/dataset.py:185); normalization has
    already been applied. The geometric-augmentation axis is NOT expanded
    here — transforms are applied on device (see data/transforms.py), so a
    logical dataset of N windows x K transforms stores only N windows.
    """

    data: np.ndarray  # [N, C, T, V] float32
    meta: np.ndarray  # [N, 4] int64: scene, clip, person, start_frame
    frame_ids: np.ndarray  # [N, T] int32 actual frame keys
    num_transform: int = 1
    means: Optional[np.ndarray] = None  # per-window mean (markovitz sub_mean)
    scaler: Optional[object] = None  # fitted RobustScaler state, if any

    @property
    def num_windows(self) -> int:
        return self.data.shape[0]

    def __len__(self) -> int:  # logical length includes the transform axis
        return self.num_windows * max(self.num_transform, 1)
