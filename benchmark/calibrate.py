"""Read the numbers a cell's limits are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,... \
        [--fault-seeds 11,12,13] [--seconds 2] [--out FILE] \
        [--patch JSON] [--control 0] [--control-precision bf16] [--leaves 3]

For each seed, in one process: the program's run as the benchmark makes it
(set-up and, for a scoring cell, a short window at the cell's own load),
the plain reference in float32, and the control: the reference in the
nearest precision below the config's (`control` in its file: TF32 for
float32, fp8 for bfloat16), read against the float32 reference by the
same numbers. For the fault seeds, each fault the cell can have
(`benchmark/faults.py`) planted in the program and read alike. Prints a
JSON line a reading and, last, the lower reading of each number (the most
the program gave), the control's least, and each fault's least.
`--patch` changes the cell's files as the benchmark's tests do (a witness
at another compute dtype: '{"config": {"reference": {"compute_dtype":
"float32"}}}'); `--leaves n` adds a training seed's n widest leaves of the
gradient and of the change, the control's too; `--control 0` skips the
control; `--control-precision` reads the reference at another precision
in the control's place (bf16: a witness of a bf16 config's rounding).
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def readings(cell, seed: int, device, seconds: float, fault=None, with_control=True,
             leaves=0, precision="") -> tuple:
    """(program numbers, control numbers or None, widest leaves or None) of
    one seed."""
    from benchmark import checks, faults

    run = cell.kind.Run(cell, seed, device)
    with faults.FAULTS[fault]() if fault else contextlib.nullcontext():
        run.setup()
        if seconds > 0 and cell.kind.ENTRY != "Trainer.fit":
            run.window(seconds)
        got = run.program_readings()
        run.free()
    reference = run.reference_readings("exact")
    numbers = run.compare(got, reference)
    control, top = None, None
    if leaves:
        top = {"program": checks.worst_leaves(got, reference, leaves)}
    if fault is None and with_control:
        low = run.control_readings(precision or cell.config["control"])
        control = run.compare(low, reference)
        if leaves:
            top["control"] = checks.worst_leaves(low, reference, leaves)
    return numbers, control, top


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--fault-seeds", default="")
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--out", default="")
    parser.add_argument("--patch", default="")
    parser.add_argument("--control", type=int, default=1)
    parser.add_argument("--leaves", type=int, default=0)
    parser.add_argument("--control-precision", default="")
    args = parser.parse_args(argv)
    import torch

    from benchmark import harness

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    cell = harness.Cell(args.workload, json.loads(args.patch) if args.patch else None)
    lines, lower, upper, fault_least = [], {}, {}, {}
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t = time.monotonic()
        numbers, control, top = readings(cell, seed, device, args.seconds,
                                         with_control=bool(args.control), leaves=args.leaves,
                                         precision=args.control_precision)
        line = dict(seed=seed, program=numbers, control=control, s=time.monotonic() - t)
        if top:
            line["leaves"] = top
        lines.append(line)
        print(json.dumps(line), flush=True)
        for k, v in numbers.items():
            lower[k] = max(lower.get(k, 0.0), v)
        for k, v in (control or {}).items():
            upper[k] = min(upper.get(k, float("inf")), v)
    for seed in [int(s) for s in args.fault_seeds.split(",") if s]:
        for fault in cell.faults():
            numbers, _, _ = readings(cell, seed, device, args.seconds, fault)
            line = dict(seed=seed, fault=fault, program=numbers)
            lines.append(line)
            print(json.dumps(line), flush=True)
            least = fault_least.setdefault(fault, {})
            for k, v in numbers.items():
                least[k] = min(least.get(k, float("inf")), v)
    summary = dict(workload=args.workload, patch=args.patch, device=torch.cuda.get_device_name(0)
                   if device.type == "cuda" else "cpu", power=harness.power_limit(),
                   lower=lower, control_least=upper, fault_least=fault_least)
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for line in lines + [summary]:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
