"""Human-related (HR) frame masks.

- HR-Avenue: hardcoded per-clip boolean masks for clips 1, 2, 3, 6 and 16
  (the reference duplicates these tables in six files; single source of truth
  here — reference eval_COSKAD.py:22-39).
- HR-UBnormal: per-clip boolean masks loaded from .npy files named
  '<scene>_<clip>.npy' (reference utils/model_utils.py:149-161).
"""

from __future__ import annotations

import glob
import os

import numpy as np

V_01 = [1] * 75 + [0] * 46 + [1] * 269 + [0] * 47 + [1] * 427 + [0] * 47 + [1] * 20 + [0] * 70 + [1] * 438  # 1439 frames
V_02 = [1] * 272 + [0] * 48 + [1] * 403 + [0] * 41 + [1] * 447  # 1211 frames
V_03 = [1] * 293 + [0] * 48 + [1] * 582  # 923 frames
V_04 = [1] * 947
V_05 = [1] * 1007
V_06 = [1] * 561 + [0] * 64 + [1] * 189 + [0] * 193 + [1] * 276  # 1283 frames
V_07_to_15 = [1] * 6457
V_16 = [1] * 728 + [0] * 12  # 740 frames
V_17_to_21 = [1] * 1317

AVENUE_MASK = (
    np.array(V_01 + V_02 + V_03 + V_04 + V_05 + V_06 + V_07_to_15 + V_16 + V_17_to_21)
    == 1
)

# Per-clip HR masks for HR-Avenue; clips not listed are fully human-related.
AVENUE_MASKED_CLIPS = {
    1: np.array(V_01) == 1,
    2: np.array(V_02) == 1,
    3: np.array(V_03) == 1,
    6: np.array(V_06) == 1,
    16: np.array(V_16) == 1,
}


def hr_ubnormal(path_glob: str) -> dict:
    """{(scene_id, clip_id): boolean mask} from '<scene>_<clip>.npy' files."""
    masks = {}
    for path in glob.glob(path_glob):
        name = os.path.basename(path).split(".")[0]
        scene_id, clip_id = (int(x) for x in name.split("_"))
        masks[(scene_id, clip_id)] = np.load(path).astype(bool)
    return masks
