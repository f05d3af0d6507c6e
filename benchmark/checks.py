"""The numbers that decide `correct`: the program's readings against the
plain reference's, each as one gap that its cell's file gives a limit.

Training (each from the same first three steps of fit's epoch-0 feed):
  loss_gap     the widest relative gap of a step's loss;
  grad_gap     the first step's gradient, by the worst leaf: the gap
               between the program's norm and the reference's, over the
               larger of the reference's norm of that leaf and of the
               median leaf;
  change_gap   the parameters' change over the three steps, by the worst
               leaf as grad_gap;
  both leave out the leaves whose reference gradient is under a thousandth
  of the median leaf's: a dense bias under BatchNorm has a gradient of
  nought but round-off, which Adam turns into a step;
  loss1_gap, grad_median_gap, change_median_gap  the first step's loss, and
               the median leaf's gaps: steadier from seed to seed;
  center_gap   the center the program starts from (its eval pass);
  center_update_gap  euclidean_dynamic's epoch-end center from the three
               steps' latents;
  epoch_center_gap   the center fit leaves at its first epoch's end, against
               the update of that epoch's own latent sums.
Scoring:
  score_gap    the widest gap of a served score, over the larger of the
               reference's score and the median score.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional

import numpy as np

MOVED_SHARE = 1e-3  # of the median leaf's gradient norm: below it a leaf is left out of change_gap


def _median(values: Iterable[float]) -> float:
    return float(np.median(np.asarray(list(values), np.float64)))


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float],
              keep: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """|norm_p - norm_r| / max(norm_r, median norm_r) of each kept leaf."""
    names = list(reference) if keep is None else list(keep)
    floor = _median(reference[k] for k in names)
    return {k: abs(program.get(k, math.nan) - reference[k]) / max(reference[k], floor)
            for k in names}


def worst(gaps: Dict[str, float]) -> float:
    vals = list(gaps.values())
    return math.nan if any(math.isnan(v) for v in vals) else max(vals)


def moved_leaves(grad_norms: Dict[str, float]) -> list:
    floor = MOVED_SHARE * _median(grad_norms.values())
    return [k for k, v in grad_norms.items() if v >= floor]


def rel_gap(program: np.ndarray, reference: np.ndarray) -> float:
    program, reference = np.asarray(program, np.float64), np.asarray(reference, np.float64)
    return float(np.linalg.norm(program - reference) / max(np.linalg.norm(reference), 1e-30))


def train_gaps(program: dict, reference: dict) -> Dict[str, float]:
    lp, lr = np.asarray(program["losses"], np.float64), np.asarray(reference["losses"], np.float64)
    moved = moved_leaves(reference["grad1"])
    grads = leaf_gaps(program["grad1"], reference["grad1"], moved)
    changes = leaf_gaps(program["change"], reference["change"], moved)
    out = {
        "loss_gap": float(np.max(np.abs(lp - lr) / np.abs(lr))) if len(lp) == len(lr) else math.nan,
        "loss1_gap": float(abs(lp[0] - lr[0]) / abs(lr[0])) if len(lp) else math.nan,
        "grad_gap": worst(grads),
        "grad_median_gap": _median(grads.values()),
        "change_gap": worst(changes),
        "change_median_gap": _median(changes.values()),
        "center_gap": rel_gap(program["center"], reference["center"]),
    }
    if reference.get("center_update") is not None:
        out["center_update_gap"] = rel_gap(program["center_update"], reference["center_update"])
    if reference.get("epoch_center") is not None:
        out["epoch_center_gap"] = rel_gap(program.get("epoch_center", math.nan),
                                          reference["epoch_center"])
    return out


def worst_leaves(program: dict, reference: dict, n: int = 3) -> dict:
    """The n leaves with the widest gaps of the first gradient and of the
    change, each as [name, gap, program's norm, reference's norm]."""
    moved = moved_leaves(reference["grad1"])
    out = {}
    for key in ("grad1", "change"):
        gaps = leaf_gaps(program[key], reference[key], moved)
        top = sorted(gaps, key=lambda k: -gaps[k])[:n]
        out[key] = [[k, gaps[k], program[key].get(k, math.nan), reference[key][k]] for k in top]
    return out


def score_gap(served: Iterable[np.ndarray], reference: Iterable[np.ndarray]) -> float:
    """Widest gap of any served score against its reference score, over the
    larger of that score and the median reference score. A missing or
    wrongly sized answer reads as NaN."""
    worst = 0.0
    pairs = list(zip(served, reference))
    floor = _median(np.median(np.abs(r)) for _, r in pairs) if pairs else math.nan
    for s, r in pairs:
        s, r = np.asarray(s, np.float64), np.asarray(r, np.float64)
        if s.shape != r.shape:
            return math.nan
        gap = float(np.max(np.abs(s - r) / np.maximum(np.abs(r), floor))) if r.size else 0.0
        worst = gap if not gap <= worst else worst
    return worst
