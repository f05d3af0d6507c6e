"""The host's time to enqueue one batch's decode in a decoder variant's
scoring pass: the median of the program's `eval.decode` span (the reverse
projector, the decoder's route and the reconstruction error of one batch;
it holds no wait on the device). None for a program that opens no such
span."""

from benchmark.metrics import program_spans

LAYER = "decoder"
UNIT = "us"
MOVES = "score_windows_per_s"


def read(ctx):
    decode = program_spans.stats("eval.decode")
    return None if decode is None else decode["median_s"] * 1e6
