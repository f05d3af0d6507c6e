"""The program's own part of set-up: the self time of its set-up spans
(the kernels' build check or build, their loading, the Trainer's
construction with its uploads, K1's fold and pack), so each second counts
once however they nest. The rest of `setup_s` is torch's import, the CUDA
context and the benchmark's own data, which no program change shortens."""

from benchmark.metrics import program_spans

LAYER = "set-up"
UNIT = "s"
MOVES = "setup_s"
SPANS = ("kernels.build", "kernels.load", "trainer.init", "k1.fold")


def read(ctx):
    found = [s for s in map(program_spans.stats, SPANS) if s is not None]
    return sum(s["self_s"] for s in found) if found else None
