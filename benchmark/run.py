"""Run one benchmark cell once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for. The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics), `device`, with `--trace 1` also
`breakdown`, and last `checks`, each number that decided `correct` beside
its limit (also the last lines of standard error). A run that cannot give
a result (no card, too few cards, the JAX package or JAX loaded) exits
with another code than 0 and prints none.
"""

from __future__ import annotations

import time

STARTED = time.monotonic()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache the program or torch may write stays in the checkout, at a
# fixed path, so only a checkout's first run builds
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv_compute")):
    os.environ.setdefault(var, os.path.join(ROOT, "build", "bench_cache", sub))
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    from benchmark import harness

    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                  STARTED)
    except harness.BenchError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
