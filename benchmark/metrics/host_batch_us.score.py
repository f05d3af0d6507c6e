"""The host's time to enqueue one batch of a scoring pass: the median of the
program's `eval.batch` span (the gather, the eval forward and the distance
of one batch; it holds no wait on the device)."""

from benchmark.metrics import program_spans

LAYER = "eval pass"
UNIT = "us"
MOVES = "score_windows_per_s"


def read(ctx):
    batch = program_spans.stats("eval.batch")
    return None if batch is None else batch["median_s"] * 1e6
