"""Faults planted in the program, to show that `correct` catches them.

Each is a context manager that patches the port while it is open. The
benchmark's runs never open one; its tests and `calibrate.py` do, to see
`correct` come out false and to read how far each fault moves the
compared numbers. A traffic kind lists the faults a cell of its kind can
have (`faults(config)`).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def state_unchanged():
    """Every optimizer step returns the parameters as they were."""
    original = torch.optim.Adam.step
    torch.optim.Adam.step = lambda self, closure=None: None
    try:
        yield
    finally:
        torch.optim.Adam.step = original


@contextlib.contextmanager
def half_batch_train():
    """Each training step runs on the first half of its batch: the loss is
    the mean over the rest."""
    from coskad_tpu_torch.train.loop import Trainer

    original = Trainer.train_step

    def step(self, state, data, indices, *args, **kwargs):
        return original(self, state, data, indices[:len(indices) // 2], *args, **kwargs)

    Trainer.train_step = step
    try:
        yield
    finally:
        Trainer.train_step = original


@contextlib.contextmanager
def epoch_update_skipped():
    """fit's epoch-end update leaves the center where it was."""
    from coskad_tpu_torch.train.loop import Trainer

    original = Trainer.apply_epoch_updates
    Trainer.apply_epoch_updates = lambda self, state: state.reset_accumulators()
    try:
        yield
    finally:
        Trainer.apply_epoch_updates = original


def _patch_scores(change):
    from coskad_tpu_torch.train import objectives

    original = objectives.window_scores

    def scores(*args, **kwargs):
        return change(original(*args, **kwargs).clone())

    objectives.window_scores = scores
    return original


@contextlib.contextmanager
def half_batch_scores():
    """Each scoring batch's second half is left out: its rows get the mean
    of the first half's scores."""
    from coskad_tpu_torch.train import objectives

    def change(s):
        h = len(s) // 2
        s[h:] = s[:h].mean() if h else s[h:]
        return s

    original = _patch_scores(change)
    try:
        yield
    finally:
        objectives.window_scores = original


@contextlib.contextmanager
def answer_altered():
    """One answer of each scoring batch is another window's: row 0 gets row
    1's score."""
    from coskad_tpu_torch.train import objectives

    def change(s):
        if len(s) > 1:
            s[0] = s[1]
        return s

    original = _patch_scores(change)
    try:
        yield
    finally:
        objectives.window_scores = original


FAULTS = {"state_unchanged": state_unchanged, "half_batch_train": half_batch_train,
          "epoch_update_skipped": epoch_update_skipped,
          "half_batch_scores": half_batch_scores, "answer_altered": answer_altered}
