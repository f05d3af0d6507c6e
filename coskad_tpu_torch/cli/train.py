"""Training entry point.

    python -m coskad_tpu_torch.cli.train --config config/UBnormal/euclidean_encoder.yaml
    python -m coskad_tpu_torch.cli.train --config <config> --device cpu

Counterpart of `coskad_tpu/cli/train.py`: reads a reference-format config,
loads the train split (and the validation split when `validation: True`),
initializes the latent center, fits one epoch at a time and writes
best.ckpt, best2.ckpt and last.ckpt (with config snapshots and
metrics.jsonl) under exp_dir/dataset/dir_name. `--resume` continues from
last.ckpt, schedule state included. Runs on CUDA unless `--device cpu`.

On several cards, one command a rank:

    torchrun --nproc-per-node 2 -m coskad_tpu_torch.cli.train --config <config> --distributed auto
    python -m coskad_tpu_torch.cli.train --config <config> --distributed host:port,2,0   # rank 0
    python -m coskad_tpu_torch.cli.train --config <config> --distributed host:port,2,1   # rank 1

Every rank trains its block of each global batch (`parallel/mesh.py`) and
rank 0 alone writes the checkpoints and metrics. With `run.model_parallel:
2` in the config, four ranks run as a 2 x 2 (data, model) mesh, the
projector split over each pair. `cli.supervise` restarts a
crashed or stalled run, or group. For its tests the run takes fault
injections from the environment, scoped to one rank by COSKAD_CRASH_RANK:
COSKAD_STARTUP_DELAY_S (a slow start), COSKAD_CRASH_BEFORE_CKPT_AT_EPOCH
(exit 23 after the epoch's metrics, before its checkpoint),
COSKAD_CRASH_AT_EPOCH (exit 17 after the epoch's checkpoint) and
COSKAD_HANG_AT_EPOCH (a hang after the checkpoint).
"""

from __future__ import annotations

import argparse
import os
import time
from dataclasses import dataclass, field
from typing import List

from ..train import checkpoint
from ..train.loop import Trainer
from ..train.state import TrainState
from ..utils.logging import MetricLogger
from .common import (add_distributed_flag, distributed_barrier, init_distributed, is_primary,
                     load_config, load_ground_truths, load_split)


@dataclass
class TrainRun:
    """What one invocation trained: the trainer (model and optimizer), the
    final state, and the epochs' mean losses and validation AUCs."""

    trainer: Trainer
    state: TrainState
    loss: List[float] = field(default_factory=list)
    validation_auc: List[float] = field(default_factory=list)


def main(argv=None) -> TrainRun:
    parser = argparse.ArgumentParser(description="COSKAD training (PyTorch)")
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("--epochs", type=int, default=None, help="override epoch count")
    parser.add_argument("--resume", action="store_true",
                        help="resume from <exp_dir>/last.ckpt if present")
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    add_distributed_flag(parser)
    args = parser.parse_args(argv)

    # the process group first, before any use of the device
    layout = init_distributed(args.distributed, args.device)
    # a slow start (data load, kernel builds) that writes nothing to ckpt_dir
    delay = float(os.environ.get("COSKAD_STARTUP_DELAY_S", "0") or 0)
    if delay > 0:
        print(f"[coskad] injected startup delay {delay:.0f}s", flush=True)
        time.sleep(delay)

    cfg = load_config(args.config)
    primary = is_primary()
    print(f"[coskad] variant={cfg.model.variant} dataset={cfg.data.dataset_choice} "
          f"device={args.device} process={layout.rank}/{layout.world}")

    train_ds = load_split(cfg, "train", device=args.device)
    print(f"[coskad] train windows: {train_ds.num_windows} "
          f"(x{cfg.data.num_transform} transforms)")
    val_ds, gts = None, {}
    if cfg.opt.validation:
        # UBnormal validates on its 'validating' split; the other datasets on
        # the test split (the config loader sets pose_dirs['validation']).
        val_split = "validation" if cfg.data.pose_dirs.get("validation") or (
            cfg.data.normalization_strategy == "robust"
            and cfg.data.dataset_choice == "UBnormal") else "test"
        val_ds = load_split(cfg, val_split, stride=1, scaler=train_ds.scaler, device=args.device)
        gts = load_ground_truths(cfg.data.val_gt_dir or cfg.data.gt_dir)
        print(f"[coskad] val windows: {val_ds.num_windows}, clips: {len(gts)}")

    ckpt_dir = cfg.ckpt_dir
    os.makedirs(ckpt_dir, exist_ok=True)
    logger = MetricLogger(log_dir=ckpt_dir if primary else None)
    trainer = Trainer(cfg, train_ds, val_ds, gts, device=args.device, logger=logger)
    state = trainer.init_state()
    # Two best checkpoints: best.ckpt is the top validation AUC, best2.ckpt
    # the runner-up; a new best rotates the old best into best2.
    start_epoch, best_auc, best2_auc = 0, -1.0, -1.0
    resume_path = os.path.join(ckpt_dir, "last.ckpt")
    if args.resume and os.path.exists(resume_path):
        state, _, extra = checkpoint.restore(resume_path, trainer)
        start_epoch = int(extra.get("epoch", -1)) + 1
        best_auc = float(extra.get("best_auc", -1.0))
        best2_auc = float(extra.get("best2_auc", -1.0))
        # Epoch-indexed schedules, the shuffle stream and the plateau
        # reducer continue from the run's global position.
        trainer.restore_schedule_state(extra)
        print(f"[coskad] resumed from {resume_path} at epoch {start_epoch}")
    else:
        state = trainer.initialize_center(state)
        print(f"[coskad] center initialized, |c| = {float(state.center.norm()):.4f}")

    # COSKAD_CRASH_RANK scopes the injections below to one rank of a group.
    injectable = os.environ.get("COSKAD_CRASH_RANK", "") in ("", str(layout.rank))

    # Read before any write: a best.ckpt of an earlier attempt is rotated
    # into best2 on the next improvement.
    have_best_ckpt = os.path.exists(os.path.join(ckpt_dir, "best.ckpt"))
    run = TrainRun(trainer=trainer, state=state)
    epochs = args.epochs if args.epochs is not None else cfg.opt.epochs
    for epoch in range(start_epoch, epochs):
        state, history = trainer.fit(state=state, epochs=1)
        if injectable and os.environ.get("COSKAD_CRASH_BEFORE_CKPT_AT_EPOCH", "") == str(epoch):
            # after the epoch's metrics, before its checkpoint: a failure every
            # attempt repeats, which must spend the supervisor's budget
            print(f"[coskad] injected pre-ckpt crash at epoch {epoch}", flush=True)
            os._exit(23)
        auc = history["validation_auc"][-1] if history["validation_auc"] else None
        best_path = os.path.join(ckpt_dir, "best.ckpt")
        if auc is not None and auc > best_auc:
            if best_auc > -1.0 and have_best_ckpt:
                if primary:
                    os.replace(best_path, os.path.join(ckpt_dir, "best2.ckpt"))
                best2_auc = best_auc
            best_auc = auc
            checkpoint.save(best_path, trainer, state, cfg, scaler=train_ds.scaler,
                            extra={"epoch": epoch, "auc": auc})
            have_best_ckpt = True
        elif auc is not None and auc > best2_auc:
            best2_auc = auc
            checkpoint.save(os.path.join(ckpt_dir, "best2.ckpt"), trainer, state, cfg,
                            scaler=train_ds.scaler, extra={"epoch": epoch, "auc": auc})
        checkpoint.save(os.path.join(ckpt_dir, "last.ckpt"), trainer, state, cfg,
                        scaler=train_ds.scaler,
                        extra={"epoch": epoch, "best_auc": best_auc,
                               "best2_auc": best2_auc, **trainer.schedule_state()})
        if injectable and os.environ.get("COSKAD_CRASH_AT_EPOCH", "") == str(epoch):
            # after the checkpoint: --resume restarts at the next epoch
            print(f"[coskad] injected crash at epoch {epoch}", flush=True)
            os._exit(17)
        if injectable and os.environ.get("COSKAD_HANG_AT_EPOCH", "") == str(epoch):
            # a wedge without an exit, which only the stall detector ends
            print(f"[coskad] injected hang at epoch {epoch}", flush=True)
            while True:
                time.sleep(60)
        run.loss += history["loss"]
        run.validation_auc += history["validation_auc"]
        msg = f"[coskad] epoch {epoch + 1}/{epochs} loss={history['loss'][-1]:.6f}"
        if auc is not None:
            msg += f" validation_auc={auc:.4f} (best {best_auc:.4f})"
        print(msg)
    logger.close()
    run.state = state
    # the ranks leave together: one rank's teardown must not land under
    # another's live collective
    distributed_barrier()
    print(f"[coskad] done; checkpoints in {ckpt_dir}")
    return run


if __name__ == "__main__":
    main()
