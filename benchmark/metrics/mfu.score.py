"""The whole scoring pass's share of the card's peak: the model's eval FLOPs
(`work/<config>.py`) over every item scored in the untraced window, over its
time, over the peak of the config's compute dtype (`peaks.json`)."""

from benchmark.metrics import common

LAYER = "eval pass"
UNIT = "%"
MOVES = "score_windows_per_s"


def read(ctx):
    return common.mfu_percent(ctx, "eval")
