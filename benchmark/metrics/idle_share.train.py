"""The device's idle share of a traced training epoch: 1 minus the union of
its operations' intervals over the traced window, in percent."""

from benchmark.metrics import common

LAYER = "device"
UNIT = "%"
MOVES = "train_windows_per_s"


def read(ctx):
    return common.idle_percent(ctx)
