"""The device's idle share of traced scoring passes or requests: 1 minus the
union of its operations' intervals over the traced window, in percent."""

from benchmark.metrics import common

LAYER = "device"
UNIT = "%"
MOVES = "score_windows_per_s"


def read(ctx):
    return common.idle_percent(ctx)
