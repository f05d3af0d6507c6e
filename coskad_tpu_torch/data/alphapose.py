"""AlphaPose tracked-person JSON ingestion (host side).

Counterpart of `coskad_tpu/data/alphapose.py`. A directory holds one JSON
per clip, named '<scene>_<clip>[...].json', each mapping person_id ->
{frame_key -> {'keypoints': flat [x, y, conf] * V}};
`load_alphapose_split` turns a directory into a SegmentDataset of
normalized [N, C, T, V] windows, `load_alphapose_store` into a
device-resident TrajectoryStore (`data/device_pipeline.py`).

Ordering is the reference's: persons in numeric order of their ids; a
person's keypoint rows stacked in lexicographic frame-key order while
windowing consults the numeric key order (identical whenever frame keys are
zero-padded). A clip is parsed by the native C++ parser (`data/native.py`)
unless COSKAD_NATIVE=0 or no toolchain builds it; the `json.load` path
below is its semantics.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .normalize import normalize
from .windows import PersonTrajectory, SegmentDataset, keypoints17_to_coco18, segment_clip


def parse_person(person_entry, person_id: int, kp_threshold: float = 0.0) -> PersonTrajectory:
    """One person's {frame_key: {'keypoints': [...]}} -> PersonTrajectory."""
    if isinstance(person_entry, list):  # some exports shard the dict
        merged: Dict = {}
        for sub in person_entry:
            merged.update(**sub)
        person_entry = merged
    lex_keys = sorted(person_entry.keys())  # lexicographic: row order
    rows = []
    for key in lex_keys:
        kp = np.array(person_entry[key]["keypoints"], dtype=np.float64).reshape(-1, 3)
        if kp_threshold > 0:
            low = kp[:, 2] < kp_threshold
            kp[low, :2] = 0.0
        rows.append(kp)
    keypoints = np.stack(rows, axis=0)
    numeric_keys = sorted(int(k) for k in lex_keys)  # numeric: window order
    return PersonTrajectory(person_id=person_id, frame_keys=numeric_keys, keypoints=keypoints)


def parse_clip_json(path: str, kp_threshold: float = 0.0) -> List[PersonTrajectory]:
    """Clip JSON -> one PersonTrajectory per tracked person with detections.
    The native parser first (same result), unless COSKAD_NATIVE=0."""
    if os.environ.get("COSKAD_NATIVE", "1") != "0":
        from .native import parse_clip_json_native

        native = parse_clip_json_native(path, kp_threshold)
        if native is not None:
            return native
    with open(path, "r") as f:
        clip_dict = json.load(f)
    trajectories = []
    for pid in sorted(clip_dict.keys(), key=lambda x: int(x)):
        entry = clip_dict[pid]
        # A tracked id with no detections contributes no windows.
        if not entry or (isinstance(entry, list) and not any(entry)):
            continue
        trajectories.append(parse_person(entry, int(pid), kp_threshold))
    return trajectories


def scene_clip_from_filename(filename: str):
    scene_id, clip_id = filename.split("_")[:2]
    return int(scene_id), int(clip_id.split(".")[0])


def load_alphapose_split(
    json_dir: str,
    seg_len: int = 12,
    seg_stride: int = 1,
    start_offset: int = 0,
    num_clips: Optional[int] = None,
    kp_threshold: float = 0.0,
    kp18_format: bool = True,
    headless: bool = False,
    normalize_pose: bool = True,
    normalization_strategy: str = "markovitz",
    vid_res: Sequence[int] = (856, 480),
    symm_range: bool = True,
    sub_mean: bool = True,
    scaler=None,
    num_transform: int = 5,
) -> SegmentDataset:
    """Directory of per-clip AlphaPose JSONs -> normalized SegmentDataset:
    sorted *.json, each person windowed, optional 17->18 conversion and
    headless crop to the first 14 joints, normalization (robust fits a
    scaler unless one is given), then [N, T, V, F] -> [N, F, T, V]."""
    json_list = sorted(fn for fn in os.listdir(json_dir) if fn.endswith(".json"))
    if num_clips is not None:
        json_list = json_list[:num_clips]

    all_data, all_meta, all_ids = [], [], []
    for fn in json_list:
        scene_id, clip_id = scene_clip_from_filename(fn)
        trajectories = parse_clip_json(os.path.join(json_dir, fn), kp_threshold)
        data, meta, ids = segment_clip(trajectories, scene_id, clip_id, start_offset,
                                       seg_stride, seg_len)
        if data.shape[0]:
            all_data.append(data)
        all_meta += meta
        all_ids += ids
    if not all_data:
        raise ValueError(f"No windows produced from {json_dir}")
    segs = np.concatenate(all_data, axis=0)  # [N, T, V, F]

    if kp18_format and segs.shape[-2] == 17:
        segs = keypoints17_to_coco18(segs)
    if headless:
        segs = segs[:, :, :14]

    means, scaler_out = None, scaler
    if normalize_pose:
        if normalization_strategy == "robust":
            segs, scaler_out = normalize(segs, "robust", vid_res=vid_res,
                                         symm_range=symm_range, scaler=scaler)
        else:
            segs, means = normalize(segs, normalization_strategy, vid_res=vid_res,
                                    symm_range=symm_range, sub_mean=sub_mean)

    return SegmentDataset(
        data=np.transpose(segs, (0, 3, 1, 2)).astype(np.float32),
        meta=np.asarray(all_meta, dtype=np.int64),
        frame_ids=np.asarray(all_ids, dtype=np.int32),
        num_transform=num_transform,
        means=means,
        scaler=scaler_out,
    )


def load_alphapose_store(
    json_dir: str,
    seg_len: int = 12,
    seg_stride: int = 1,
    start_offset: int = 0,
    num_clips: Optional[int] = None,
    kp_threshold: float = 0.0,
    kp18_format: bool = True,
    headless: bool = False,
    normalization_strategy: str = "markovitz",
    vid_res: Sequence[int] = (856, 480),
    symm_range: bool = True,
    sub_mean: bool = True,
    scaler=None,
    num_transform: int = 5,
    device=None,
):
    """Directory of per-clip AlphaPose JSONs -> device-resident
    TrajectoryStore (`data/device_pipeline.py`): the raw trajectories go to
    the device once; windowing, normalization and the affine transforms
    happen per batch. Same window enumeration and normalization as
    load_alphapose_split, with whole trajectories resident instead of
    overlapping windows. `device` follows `build_store`.

    The 'robust' strategy needs a host-fitted scaler (pass `scaler`); the
    store cannot fit one on the fly.
    """
    from .device_pipeline import build_store

    if normalization_strategy == "robust" and scaler is None:
        raise ValueError(
            "device_pipeline with robust normalization needs a pre-fitted "
            "scaler (fit once via the host pipeline or restore from a "
            "checkpoint)")
    json_list = sorted(fn for fn in os.listdir(json_dir) if fn.endswith(".json"))
    if num_clips is not None:
        json_list = json_list[:num_clips]
    clips = []
    for fn in json_list:
        scene_id, clip_id = scene_clip_from_filename(fn)
        clips.append((scene_id, clip_id,
                      parse_clip_json(os.path.join(json_dir, fn), kp_threshold)))
    return build_store(
        clips, seg_len=seg_len, seg_stride=seg_stride, start_offset=start_offset,
        kp18_format=kp18_format, headless=headless, num_transform=num_transform,
        normalization=normalization_strategy, vid_res=tuple(vid_res),
        symm_range=symm_range, sub_mean=sub_mean, scaler=scaler, device=device)
