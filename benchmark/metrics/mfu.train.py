"""The whole training step's share of the card's peak: the model's FLOPs
(`work/<config>.py`) over every item of the untraced window, over its time,
over the peak of the config's compute dtype (`peaks.json`)."""

from benchmark.metrics import common

LAYER = "train step"
UNIT = "%"
MOVES = "train_windows_per_s"


def read(ctx):
    return common.mfu_percent(ctx, "train")
