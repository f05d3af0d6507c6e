"""Batch scoring entry point: score clip JSONs without ground truth.

    python -m coskad_tpu_torch.cli.serve --ckpt best.ckpt clip1.json [clip2.json ...]
    python -m coskad_tpu_torch.cli.serve --ckpt best.ckpt --clips-dir tracked/ \
        --out scores/ [--n-frames-from-gt gt_dir/] [--no-smooth] [--json] [--device cpu]

Counterpart of `coskad_tpu/cli/serve.py`. Loads a checkpoint of either
package once (`AnomalyScorer.from_checkpoint`) and scores any number of
AlphaPose tracked-clip JSONs, writing one float array per clip:

  * `<out>/<clip-stem>_scores.npy`: per-frame anomaly scores (actor max,
    pad_scores, shift + Gaussian smoothing: the offline pipeline without
    ground truth, `serve.py::score_clip_json`), or
  * `--json`: `<out>/<clip-stem>_scores.json`.

The frame count of a clip defaults to its last window-covered frame key;
`--n-frames N` forces a length, `--n-frames-from-gt <dir>` reads each
clip's length from the dataset's ground-truth masks (the length only).
Runs on CUDA unless `--device cpu`. Exit status 1 if any clip fails; the
rest still score.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys


def _clip_stem(path: str) -> str:
    base = os.path.basename(path)
    for suffix in ("_alphapose_tracked_person.json", ".json"):
        if base.endswith(suffix):
            return base[: -len(suffix)]
    return base


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="COSKAD batch clip scoring, PyTorch (no ground truth needed)")
    parser.add_argument("clips", nargs="*", help="clip JSON paths")
    parser.add_argument("--clips-dir", default=None,
                        help="score every *.json under this directory")
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--config", default=None,
                        help="config YAML (default: the <ckpt>.config.json "
                             "snapshot written at train time)")
    parser.add_argument("--out", default=None, metavar="DIR",
                        help="output directory (default: print per-clip "
                             "summary stats only)")
    parser.add_argument("--json", action="store_true",
                        help="write JSON score arrays instead of .npy")
    parser.add_argument("--no-smooth", action="store_true",
                        help="skip the shift+Gaussian post-processing "
                             "(raw actor-max frame scores)")
    parser.add_argument("--n-frames", type=int, default=None)
    parser.add_argument("--n-frames-from-gt", default=None, metavar="DIR",
                        help="read each clip's frame count from "
                             "<DIR>/<stem>.npy ground-truth masks (length "
                             "only; labels are not used)")
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    import numpy as np

    from ..serve import AnomalyScorer

    clips = list(args.clips)
    if args.clips_dir:
        clips += sorted(glob.glob(os.path.join(args.clips_dir, "*.json")))
    if not clips:
        parser.error("no clips given (positional paths or --clips-dir)")

    cfg = None
    if args.config:
        from .common import load_config

        cfg = load_config(args.config)
    scorer = AnomalyScorer.from_checkpoint(args.ckpt, cfg=cfg, device=args.device)
    print(f"[coskad] serving {len(clips)} clip(s) with {args.ckpt} "
          f"(variant={scorer.cfg.model.variant})")

    if args.out:
        os.makedirs(args.out, exist_ok=True)
    failures = 0
    for path in clips:
        stem = _clip_stem(path)
        n_frames = args.n_frames
        if n_frames is None and args.n_frames_from_gt:
            # GT masks are named by scene_clip (01_0014.npy) while clip JSONs
            # carry tracker suffixes (01_0014_tracked.json,
            # 01_0014_alphapose_tracked_person.json): try the full stem,
            # then the scene_clip prefix the eval pipeline keys by.
            for cand in (stem, "_".join(stem.split("_")[:2])):
                gt_path = os.path.join(args.n_frames_from_gt, cand + ".npy")
                if os.path.exists(gt_path):
                    n_frames = int(np.load(gt_path).shape[0])
                    break
            else:
                # Silent fallback would defeat the flag's purpose (the
                # default length is the last covered key, a few frames
                # short of the GT mask): warn so misaligned arrays are
                # traceable.
                print(f"[coskad] WARNING: no GT mask for {stem} under "
                      f"{args.n_frames_from_gt} (tried {stem}.npy and "
                      "scene_clip prefix); falling back to the last "
                      "window-covered frame key", file=sys.stderr)
        try:
            scores = scorer.score_clip_json(
                path, n_frames=n_frames, smooth=not args.no_smooth)
            stats = (f"max={scores.max():.6f} mean={scores.mean():.6f}"
                     if scores.size else "EMPTY (0 frames)")
            print(f"[coskad] {stem}: {scores.shape[0]} frames, {stats}")
            if args.out:
                if args.json:
                    with open(os.path.join(args.out, f"{stem}_scores.json"),
                              "w") as f:
                        json.dump([float(s) for s in scores], f)
                else:
                    np.save(os.path.join(args.out, f"{stem}_scores.npy"),
                            scores)
        except Exception as e:  # keep scoring the remaining clips
            print(f"[coskad] FAILED {path}: {e}", file=sys.stderr)
            failures += 1
            continue
    if args.out:
        print(f"[coskad] scores written to {args.out}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
