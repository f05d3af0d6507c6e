"""The share of a scoring pass the host spends waiting for its scores:
100 x the program's `eval.fetch` spans (the pass's one wait on the device)
over its `eval.pass` spans. Near 0 the host sets the pace; high, the
device does."""

from benchmark.metrics import program_spans

LAYER = "eval pass"
UNIT = "%"
MOVES = "score_windows_per_s"


def read(ctx):
    fetch, whole = program_spans.stats("eval.fetch"), program_spans.stats("eval.pass")
    if fetch is None or whole is None or whole["total_s"] <= 0:
        return None
    return 100.0 * fetch["total_s"] / whole["total_s"]
