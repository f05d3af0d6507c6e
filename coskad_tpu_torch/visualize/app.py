"""Optional Streamlit front-end over the clip visualizer (counterpart of
`coskad_tpu/visualize/app.py`).

The reference's `visualize/vis.py` WebApp: a Streamlit page titled after
the dataset that plays the rendered skeleton animation (reference
vis.py:14-23 and 252-257). Streamlit is optional: the module imports
without it. Run with:

    streamlit run -m coskad_tpu_torch.visualize.app -- --data-dir <alphapose-root>

or `python -m coskad_tpu_torch.visualize.app --data-dir ... --out-dir ...`,
which renders every clip headlessly, one gif a clip, where streamlit is not
running the page. Rendering needs matplotlib.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from glob import glob
from typing import List, Optional

from .clips import ClipVisualizer

TRACKED_JSON = "alphapose-results-forvis-tracked.json"


def find_clip_jsons(data_dir: str) -> List[str]:
    """Tracked-pose JSONs under an AlphaPose results tree (the glob the
    reference's __main__ uses, vis.py:264)."""
    hits = sorted(glob(os.path.join(data_dir, "*", TRACKED_JSON)))
    if not hits:  # flat layout or arbitrary JSON clips
        hits = sorted(glob(os.path.join(data_dir, "*.json")))
    return hits


def clip_label(clip_json: str) -> str:
    """Display/output name for a clip JSON: the containing directory for the
    AlphaPose per-clip layout, the file stem for flat layouts."""
    base = os.path.basename(clip_json)
    if base == TRACKED_JSON:
        return os.path.basename(os.path.dirname(clip_json)) or "clip"
    return os.path.splitext(base)[0]


def load_clip_scores(clip_json: str, scores_dir: str):
    """Per-frame per-person scores for one clip from an `eval --save-scores`
    dump: reads error_per_person_scene_{S}_scenario_{C}.npy ([P, F] — rows
    follow the eval aggregation's fig_ids = actors that actually produced
    windows, columns are absolute 0-based frame indices, i.e. frame_key-1)
    plus the sibling fig_ids_*.npy row map. Returns {frame_key: {pid:
    score}} or None when no matching npy exists."""
    import re

    import numpy as np

    m = re.match(r"(\d+)_(\d+)", clip_label(clip_json))
    if not m:
        return None
    stem = f"scene_{int(m.group(1))}_scenario_{int(m.group(2))}.npy"
    path = os.path.join(scores_dir, f"error_per_person_{stem}")
    if not os.path.exists(path):
        return None
    epp = np.load(path)  # [P, F]
    fid_path = os.path.join(scores_dir, f"fig_ids_{stem}")
    vis = ClipVisualizer()
    vis.load_clip_json(clip_json)
    keys = vis.frame_keys()
    if os.path.exists(fid_path):
        pids = [str(int(p)) for p in np.load(fid_path)]
    else:
        # Older dumps without the row map: best-effort sorted-person order
        # (fig_ids is np.unique of the person ids, i.e. sorted); actors too
        # short to produce windows are not distinguishable here.
        pids = sorted({pid for k in keys for pid in vis.actors_in_frame(k)},
                      key=lambda p: int(p))
    out = {}
    for key in keys:
        # epp columns are scattered by 1-based frame id (actor_frame_scores)
        col = int(key) - 1
        if not (0 <= col < epp.shape[1]):
            continue
        out[key] = {pid: float(epp[row, col])
                    for row, pid in enumerate(pids) if row < epp.shape[0]}
    return out


def render_clip_video(
    clip_json: str,
    dataset: str = "ubnormal",
    frames_dir: Optional[str] = None,
    out_path: Optional[str] = None,
    fmt: str = "gif",
    scores_dir: Optional[str] = None,
) -> str:
    """Render one clip's skeleton animation to mp4/gif and return the path.
    Headless (Agg); the Streamlit layer is display-only on top of this."""
    if out_path is None:
        out_path = os.path.join(tempfile.gettempdir(),
                                f"coskad_vis_{clip_label(clip_json)}.{fmt}")
    vis = ClipVisualizer(dataset)
    vis.load_clip_json(clip_json)
    frame_scores = (load_clip_scores(clip_json, scores_dir)
                    if scores_dir else None)
    vis.animate(out_path, frames_dir=frames_dir, frame_scores=frame_scores)
    return out_path


def streamlit_app():  # pragma: no cover - exercised only under streamlit
    """The Streamlit page: dataset title, clip picker, rendered animation."""
    import streamlit as st

    params = _parse_args()
    st.title(f"Visualization of {params.dataset.upper()}")
    clips = find_clip_jsons(params.data_dir)
    if not clips:
        st.error(f"No tracked-pose JSONs under {params.data_dir}")
        return
    labels = [clip_label(c) for c in clips]
    choice = st.selectbox("Clip", labels)
    clip_json = clips[labels.index(choice)]
    frames_dir = (os.path.join(params.frames_dir, choice)
                  if params.frames_dir else None)
    with st.spinner("Rendering skeleton animation..."):
        video = render_clip_video(clip_json, params.dataset, frames_dir,
                                  fmt="mp4", scores_dir=params.scores_dir)
    st.video(video)


def _parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-dir", required=True,
                   help="AlphaPose results root (one subdir per clip)")
    p.add_argument("--dataset", default="ubnormal")
    p.add_argument("--frames-dir", default=None,
                   help="optional extracted-frames root for backgrounds")
    p.add_argument("--scores-dir", default=None,
                   help="optional `eval --save-scores` dump: annotate each "
                        "skeleton with its per-frame anomaly score")
    p.add_argument("--out-dir", default=None,
                   help="headless mode: write animations here")
    return p.parse_args(argv)


def main(argv=None):
    try:
        import streamlit  # noqa: F401
        from streamlit.runtime.scriptrunner import get_script_run_ctx
        in_streamlit = get_script_run_ctx() is not None
    except Exception:
        in_streamlit = False
    if in_streamlit:
        streamlit_app()
        return
    # headless fallback: render every clip to --out-dir
    params = _parse_args(argv)
    out_dir = params.out_dir or os.path.join(tempfile.gettempdir(),
                                             "coskad_vis")
    os.makedirs(out_dir, exist_ok=True)
    for clip_json in find_clip_jsons(params.data_dir):
        name = clip_label(clip_json)
        frames_dir = (os.path.join(params.frames_dir, name)
                      if params.frames_dir else None)
        out = render_clip_video(
            clip_json, params.dataset, frames_dir,
            out_path=os.path.join(out_dir, f"{name}.gif"),
            scores_dir=params.scores_dir)
        print(out)


if __name__ == "__main__":
    main()
