"""Structured metric logging: stdout JSONL + optional Weights & Biases.

The port's own copy of `coskad_tpu/utils/logging.py::MetricLogger`.

Mirrors the reference's scalar names (`loss`, `hypersphere_loss`,
`poincare_loss`, `reconstruction_loss`, `kl_loss`, `exp_dist_loss`,
`regularization`, `validation_auc`, ... — SURVEY.md section 5) so dashboards
transfer. W&B is optional and never a hard dependency (reference gates it on
`use_wandb`, train_COSKAD.py:65-68).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional


class MetricLogger:
    def __init__(
        self,
        log_dir: Optional[str] = None,
        use_wandb: bool = False,
        wandb_kwargs: Optional[dict] = None,
        every_n_steps: int = 20,
    ):
        self.every_n_steps = every_n_steps
        self._file = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._file = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(**(wandb_kwargs or {}))
            except Exception as e:  # pragma: no cover - optional dependency
                print(f"[coskad] wandb unavailable ({e}); logging to stdout only",
                      file=sys.stderr)

    def log(self, metrics: Dict[str, float], step: int, force: bool = False):
        if not force and step % self.every_n_steps != 0:
            return
        record = {"step": int(step), "time": time.time()}
        record.update({k: float(v) for k, v in metrics.items()})
        line = json.dumps(record)
        print(line)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()
        if self._wandb:
            self._wandb.log(metrics, step=step)

    def close(self):
        if self._file:
            self._file.close()
        if self._wandb:
            self._wandb.finish()
