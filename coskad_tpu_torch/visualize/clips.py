"""Clip visualization: skeleton overlays and video frame extraction
(counterpart of `coskad_tpu/visualize/clips.py`).

The reference's visualize/vis.py (ClipVisualizer: a matplotlib
FuncAnimation of tracked skeletons over extracted frames, per-dataset
resolutions and fps, the COCO bone list with per-part colors) and
visualize/extract_frames.py (an OpenCV video to jpg frames). The renderer
works headlessly (Agg) and saves mp4 or gif. matplotlib and cv2 are
imported inside the functions that draw or read video (the card's machine
has neither): importing this module needs numpy alone.
"""

from __future__ import annotations

import json
import os
from glob import glob
from typing import Dict, List, Optional

import numpy as np

# COCO-17 bone list with per-part colors (reference visualize/vis.py:31-40)
BONES = [
    (0, 1), (0, 2), (1, 2), (1, 3), (2, 4), (3, 5), (4, 6),  # head
    (5, 6), (5, 11), (6, 12), (11, 12),  # body
    (5, 7), (7, 9), (6, 8), (8, 10),  # arms
    (11, 13), (12, 14), (13, 15), (14, 16),  # legs
]
BONE_COLORS = (
    ["magenta"] * 7
    + ["darkorange"] * 4
    + ["forestgreen", "lime", "midnightblue", "deepskyblue"]
    + ["midnightblue", "deepskyblue", "forestgreen", "lime"]
)

FRAME_DIMS = {
    "avenue": (640, 360),
    "hr-avenue": (640, 360),
    "ucf_crime": (320, 240),
    "hr_crime": (320, 240),
    "ubnormal": (1080, 720),
    "hr-ubnormal": (1080, 720),
}
FPS = {
    "avenue": 25, "hr-avenue": 25, "ucf_crime": 30, "hr_crime": 30,
    "ubi_fight": 30, "ubnormal": 30, "hr-ubnormal": 30,
}


class ClipVisualizer:
    """Render tracked skeletons of one clip, optionally over extracted
    frames, optionally color-coded by per-frame anomaly score."""

    def __init__(self, dataset: str = "ubnormal"):
        self.dataset = dataset.lower()
        self.frame_dim = FRAME_DIMS.get(self.dataset, (856, 480))
        self.fps = FPS.get(self.dataset, 30)
        self.clip: Optional[Dict] = None

    def load_clip_json(self, path: str) -> "ClipVisualizer":
        """Load an AlphaPose tracked-person JSON (same format the data layer
        ingests)."""
        with open(path) as f:
            self.clip = json.load(f)
        return self

    def actors_in_frame(self, frame_key: str) -> Dict[str, np.ndarray]:
        """{person_id: [V, 3] keypoints} present at the given frame key."""
        if self.clip is None:
            raise ValueError("no clip loaded: call load_clip_json first")
        out = {}
        for pid, frames in self.clip.items():
            if frame_key in frames:
                out[pid] = np.asarray(frames[frame_key]["keypoints"]).reshape(-1, 3)
        return out

    def frame_keys(self) -> List[str]:
        keys = set()
        for frames in (self.clip or {}).values():
            keys.update(frames.keys())
        return sorted(keys)

    def _draw_skeleton(self, ax, kps: np.ndarray, label: str = "",
                       score: Optional[float] = None):
        for (i, j), color in zip(BONES, BONE_COLORS):
            if i < len(kps) and j < len(kps):
                if kps[i, :2].any() and kps[j, :2].any():
                    ax.plot(
                        [kps[i, 0], kps[j, 0]], [kps[i, 1], kps[j, 1]],
                        color=color, linewidth=2,
                    )
        visible = kps[(kps[:, 0] != 0) | (kps[:, 1] != 0)]
        if len(visible):
            ax.scatter(visible[:, 0], visible[:, 1], s=6, c="white",
                       edgecolors="black", linewidths=0.5, zorder=3)
            if label or score is not None:
                text = label if score is None else f"{label}: {score:.2f}"
                ax.annotate(text, (visible[:, 0].min(), visible[:, 1].min() - 5),
                            color="yellow", fontsize=8)

    def render_frame(self, ax, frame_key: str, frames_dir: Optional[str] = None,
                     scores: Optional[Dict[str, float]] = None):
        """Draw one frame's skeletons (over the jpg frame if available)."""
        ax.clear()
        if frames_dir:
            img_path = os.path.join(frames_dir, f"{int(frame_key)}.jpg")
            if os.path.exists(img_path):
                import matplotlib.image as mpimg

                ax.imshow(mpimg.imread(img_path))
        for pid, kps in self.actors_in_frame(frame_key).items():
            self._draw_skeleton(ax, kps, label=pid,
                                score=(scores or {}).get(pid))
        ax.set_xlim(0, self.frame_dim[0])
        ax.set_ylim(self.frame_dim[1], 0)
        ax.set_title(f"frame {frame_key}")
        ax.axis("off")

    def animate(self, out_path: str, frames_dir: Optional[str] = None,
                max_frames: Optional[int] = None,
                frame_scores: Optional[Dict[str, Dict[str, float]]] = None
                ) -> str:
        """Write an animation (mp4 if ffmpeg available, else gif).

        frame_scores: optional {frame_key: {person_id: anomaly_score}}
        (e.g. from scores npys written by `eval --save-scores`) — each
        skeleton gets its per-frame score annotated."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib.animation import FuncAnimation, PillowWriter

        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        fig, ax = plt.subplots(figsize=(8, 5))
        keys = self.frame_keys()
        if max_frames:
            keys = keys[:max_frames]
        anim = FuncAnimation(
            fig,
            lambda k: self.render_frame(ax, k, frames_dir,
                                        scores=(frame_scores or {}).get(k)),
            frames=keys,
            interval=1000 // self.fps,
        )
        try:
            anim.save(out_path, fps=self.fps)
        except Exception:
            gif = os.path.splitext(out_path)[0] + ".gif"
            anim.save(gif, writer=PillowWriter(fps=min(self.fps, 10)))
            out_path = gif
        plt.close(fig)
        return out_path


def extract_frames(video_path: str, out_dir: str) -> int:
    """Video -> '<n>.jpg' frames, 1-indexed (reference
    visualize/extract_frames.py:10-26). Returns the frame count."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    count = 0
    while True:
        ok, image = cap.read()
        if not ok:
            cap.release()
            break
        cv2.imwrite(os.path.join(out_dir, f"{count + 1}.jpg"), image)
        count += 1
    return count


def extract_frames_tree(input_loc: str, output_loc: str) -> None:
    """Directory of .mp4s (or a single file) -> per-video frame folders."""
    os.makedirs(output_loc, exist_ok=True)
    videos = (
        sorted(glob(os.path.join(input_loc, "*.mp4")))
        if os.path.isdir(input_loc)
        else [input_loc]
    )
    for video in videos:
        name = os.path.splitext(os.path.basename(video))[0]
        out = os.path.join(output_loc, name)
        if not os.path.exists(out):
            extract_frames(video, out)
