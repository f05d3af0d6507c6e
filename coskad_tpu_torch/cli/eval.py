"""Offline evaluation entry point.

    python -m coskad_tpu_torch.cli.eval --config <config> [--ckpt path]
    python -m coskad_tpu_torch.cli.eval --config <config> --device cpu
    python -m coskad_tpu_torch.cli.eval --config <autoencoder config> --rec-weight 50

Counterpart of `coskad_tpu/cli/eval.py`: restores the checkpoint (and the
robust scaler it carries, before the test split is built), scores the test
split at stride 1, aggregates window scores to frames (actor max, HR
masks, shift + Gaussian smoothing) and prints per-clip, per-transform and
final mean-over-transforms AUC, then the wall time of each phase. Runs on
CUDA unless `--device cpu`. The autoencoder scores by latent distance, by
reconstruction error or by both, as `--rec-weight` selects
(`score/window_losses.py`); the VAE by cosine distance to the anchor its
checkpoint carries, and a VAE checkpoint without one is refused
(`checkpoint.require_vae_anchor`). `--save-roc DIR` writes a ROC PNG a
transform (`t<N>_roc_hyp.png`) and `final_roc.png`, and prints each
transform's best threshold; it needs matplotlib, which the card's machine
does not have. With `--distributed` (see `cli.train`) every rank scores its
block of each chunk, the scores are gathered, and rank 0 alone prints the
per-clip lines and writes `--save-scores` and `--save-roc`.
"""

from __future__ import annotations

import argparse
import os
import time
from dataclasses import dataclass
from typing import Dict

import numpy as np

from ..score.aggregate import EvalResult, ScoringConfig, evaluate_windows
from ..score.auc import best_threshold
from ..score.masks import AVENUE_MASKED_CLIPS, hr_ubnormal
from ..score.window_losses import mode_from_rec_weight, mode_scores
from ..train import checkpoint
from ..train.loop import Trainer
from ..utils.profiling import span
from .common import (add_distributed_flag, distributed_barrier, init_distributed, is_primary,
                     load_config, load_ground_truths, load_split)


@dataclass
class EvalRun:
    """The frame-level result, the window scores it came from (transform-
    major over the test split) and the seconds of each phase."""

    result: EvalResult
    window_scores: np.ndarray
    wall_s: Dict[str, float]


def main(argv=None) -> EvalRun:
    parser = argparse.ArgumentParser(description="COSKAD evaluation (PyTorch)")
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("--ckpt", default=None,
                        help="checkpoint path (default: <exp_dir>/best.ckpt)")
    parser.add_argument("--save-scores", default=None, metavar="DIR",
                        help="dump per-clip per-person score npys in the analysis-notebook "
                             "layout (error_per_person_scene_S_scenario_C.npy + gt_masks/)")
    parser.add_argument("--save-roc", default=None, metavar="DIR",
                        help="write per-transform and final ROC PNGs and print the best "
                             "thresholds (needs matplotlib)")
    parser.add_argument("--rec-weight", type=float, default=0.0,
                        help="autoencoder scoring mode: 0 -> latent distance, >100 -> "
                             "reconstruction error, else reconstruction error / weight + "
                             "latent distance")
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    add_distributed_flag(parser)
    args = parser.parse_args(argv)
    init_distributed(args.distributed, args.device)

    t0 = time.perf_counter()
    with span("cli.ingest") as ingest:  # JSON parse, windowing, normalization
        cfg = load_config(args.config)
        # precedence: --ckpt > the config's load_ckpt > best.ckpt > last.ckpt
        ckpt_path = args.ckpt or os.path.join(cfg.ckpt_dir, cfg.eval.load_ckpt or "best.ckpt")
        if not os.path.exists(ckpt_path):
            alt = os.path.join(cfg.ckpt_dir, "last.ckpt")
            if not os.path.exists(alt):
                raise FileNotFoundError(f"no checkpoint at {ckpt_path}")
            ckpt_path = alt

        # The test split is normalized with the training scaler, which the
        # checkpoint carries: read the file once, before the Trainer exists.
        payload = checkpoint.read_payload(ckpt_path)
        test_ds = load_split(cfg, "test", stride=1, scaler=checkpoint.scaler_of(payload),
                             device=args.device)
        gts = load_ground_truths(cfg.data.gt_dir)
        print(f"[coskad] test windows: {test_ds.num_windows}, clips: {len(gts)}")

    with span("cli.upload") as upload:  # device upload + restore
        trainer = Trainer(cfg, test_ds, device=args.device)
        state, _, extra = checkpoint.restore(ckpt_path, trainer, payload=payload)
        print(f"[coskad] restored {ckpt_path} {extra}")
        checkpoint.require_vae_anchor(cfg, state, ckpt_path)

    with span("cli.scoring") as scoring:  # gather, eval forward, distance, fetch
        scores, rec = trainer.score_all(state, test_ds, trainer.train_data)
        if cfg.model.variant == "autoencoder" and args.rec_weight != 0:
            print(f"[coskad] autoencoder scoring mode: {mode_from_rec_weight(args.rec_weight)}")
            scores = mode_scores(scores, rec, args.rec_weight)

    with span("cli.aggregate") as aggregate:  # host aggregation, AUC, prints
        k = max(cfg.data.num_transform, 1)
        hr_masks = hr_ubnormal(cfg.eval.hr_masks_glob) if (
            cfg.eval.use_hr and cfg.eval.hr_masks_glob) else {}
        avenue = AVENUE_MASKED_CLIPS if cfg.data.dataset_choice == "HR-Avenue" else {}
        primary = is_primary()
        # Metadata is identical across transforms (scores are transform-major).
        result = evaluate_windows(
            scores, None, test_ds.meta, test_ds.frame_ids, gts,
            ScoringConfig(num_transform=k, pad_size=cfg.eval.pad_size),
            hr_clip_masks=hr_masks, avenue_clip_masks=avenue,
            save_scores_dir=args.save_scores if primary else None,
        )
        # Per-clip AUC inside every transform with a running average, then the
        # transform's AUC, as the reference prints them.
        clip_keys = sorted({(s, c) for (_, s, c) in result.per_clip_auc_all})
        for t in range(k) if primary else ():
            aucs = []
            for idx, (scene, clip) in enumerate(clip_keys):
                auc = result.per_clip_auc_all.get((t, scene, clip), float("nan"))
                aucs.append(auc)
                print(f"transf: {t + 1}/{k}, clip: ({scene}, {clip}) {idx + 1}/{len(clip_keys)}, "
                      f"score: {auc} average_score: {np.nanmean(np.asarray(aucs, float))}")
            print(f"\nTest set score for transformation {t + 1}\n")
            print(f"auc = {result.per_transform_auc[t]}")
        if args.save_roc and primary:
            save_roc(args.save_roc, result)
    wall = {key: phase.seconds for key, phase in (
        ("ingest", ingest), ("upload", upload), ("scoring", scoring), ("aggregate", aggregate))}
    print("[coskad] eval wall breakdown: "
          + " ".join(f"{key}={v:.2f}s" for key, v in wall.items())
          + f" total={time.perf_counter() - t0:.2f}s")
    print(f"final AUC score: {result.auc:.6f}")
    distributed_barrier()
    return EvalRun(result=result, window_scores=scores, wall_s=wall)


def save_roc(out_dir: str, result: EvalResult) -> None:
    """Each transform's ROC curve as t<N>_roc_hyp.png (N from 0) with its
    best threshold printed, and the final scores' as final_roc.png."""
    from ..visualize.plots import plot_roc

    os.makedirs(out_dir, exist_ok=True)
    for t, (s_t, gt_t) in enumerate(zip(result.per_transform_scores, result.per_transform_gt)):
        plot_roc(gt_t, s_t, os.path.join(out_dir, f"t{t}_roc_hyp.png"))
        thr, _ = best_threshold(gt_t, s_t)
        print(f"best threshold (transform {t + 1}): {thr}")
    plot_roc(result.gt, result.scores, os.path.join(out_dir, "final_roc.png"))


if __name__ == "__main__":
    main()
