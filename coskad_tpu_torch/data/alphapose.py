"""AlphaPose tracked-person JSON ingestion (host side, pure Python).

Counterpart of `coskad_tpu/data/alphapose.py::parse_person` and
`parse_clip_json` on its pure-Python JSON path. A clip JSON maps
person_id -> {frame_key -> {'keypoints': flat [x, y, conf] * V}}.

Ordering is the reference's: persons in numeric order of their ids; a
person's keypoint rows stacked in lexicographic frame-key order while
windowing consults the numeric key order (identical whenever frame keys are
zero-padded). The native C++ parser is not ported yet (ROADMAP.md, Queue 1
item 4).
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np

from .windows import PersonTrajectory


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
    """Clip JSON -> one PersonTrajectory per tracked person with detections."""
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
