"""Failure detection and restart for training runs (counterpart of
`coskad_tpu/cli/supervise.py`).

    python -m coskad_tpu_torch.cli.supervise --config cfg.yaml --epochs 100 \
        [--num-processes N] [--max-restarts 3] [--stall-timeout 900] \
        [--backoff 2.0] [--device cuda]

The supervisor runs `python -m coskad_tpu_torch.cli.train --resume` as a
child process, or with `--num-processes N` a group of N ranks joined by
`--distributed host:port,N,rank` (`cli/common.py`), and

  * restarts a crash (any nonzero exit) with `--resume` after an
    exponential backoff, up to `--max-restarts` times. In a group any
    rank's death fails the attempt: the others would block in a collective
    on the dead rank, so the supervisor SIGTERMs the rest of the group, each
    by its own pid, and restarts every rank on a fresh coordinator port;
  * detects a stall: no file under the run's ckpt_dir touched for
    `--stall-timeout` seconds (`--startup-grace` before the attempt's first
    write: loading the data and building the kernels write nothing), which
    it ends with SIGTERM and treats as a crash;
  * resets the restart budget whenever a checkpoint is written, so a long
    run gets one recovery a failure, not `--max-restarts` in all;
  * retries a coordinator port that another process took between the
    supervisor's choice and rank 0's bind (rank 0 exits with
    `utils/net.py::PORT_IN_USE_EXIT`) on a fresh port, without spending the
    restart budget.

Every resume starts from last.ckpt (weights, optimizer, center and
covariance, scaler, schedule state), so a supervised run ends where an
uninterrupted one does (tests/test_torch_supervise.py). Exit status: 0
when the run completed, 1 when the restart budget ran out; each rank's
exit code is reported on stderr.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time

from ..utils.net import PORT_IN_USE_EXIT, free_port

TRAIN_MODULE = "coskad_tpu_torch.cli.train"
# port collisions in a row that are retried free before one counts as a failure
MAX_PORT_RETRIES = 5


def _terminate(procs) -> None:
    """SIGTERM each live child by pid; SIGKILL after 30 s."""
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    deadline = time.time() + 30
    for p in procs:
        if p.poll() is None:
            try:
                p.wait(timeout=max(deadline - time.time(), 0.1))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def _latest_mtime(path: str, suffix: str = "") -> float:
    """Newest mtime of the files directly under `path` whose names end with
    `suffix`; 0.0 while the directory does not exist."""
    try:
        entries = [os.path.join(path, f) for f in os.listdir(path) if f.endswith(suffix)]
    except FileNotFoundError:
        return 0.0
    newest = 0.0
    for f in entries:
        try:
            newest = max(newest, os.path.getmtime(f))
        except OSError:
            continue
    return newest


def train_command(config: str, epochs=None, device=None, extra=()) -> list:
    """The child's command line: the port's train CLI, resuming."""
    cmd = [sys.executable, "-u", "-m", TRAIN_MODULE, "--config", config, "--resume"]
    if epochs is not None:
        cmd += ["--epochs", str(epochs)]
    if device is not None:
        cmd += ["--device", device]
    return cmd + list(extra)


def supervise(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="COSKAD training supervisor, PyTorch (crash and stall recovery)")
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--device", default=None, help="passed to the train CLI")
    parser.add_argument("--max-restarts", type=int, default=3,
                        help="restarts allowed a failure (the budget resets on checkpoint "
                             "progress)")
    parser.add_argument("--stall-timeout", type=float, default=900.0,
                        help="seconds without any ckpt_dir write before the child is declared "
                             "wedged and SIGTERMed")
    parser.add_argument("--startup-grace", type=float, default=3600.0,
                        help="stall allowance before the attempt's first ckpt_dir write")
    parser.add_argument("--backoff", type=float, default=2.0,
                        help="first restart delay, doubled a consecutive failure")
    parser.add_argument("--poll", type=float, default=2.0, help="child poll interval (seconds)")
    parser.add_argument("--num-processes", type=int, default=1,
                        help="group size: N train ranks joined by --distributed over a local "
                             "coordinator; any rank's failure restarts the whole group")
    parser.add_argument("--coordinator-host", default="localhost",
                        help="the coordinator address the ranks dial (group mode)")
    parser.add_argument("--coordinator-port", type=int, default=None,
                        help="the first attempt's coordinator port (default: a free one); "
                             "later attempts take a fresh one")
    args, extra = parser.parse_known_args(argv)

    # the config alone, for ckpt_dir: the supervisor holds no device
    from ..config import from_reference_yaml

    ckpt_dir = from_reference_yaml(args.config).ckpt_dir
    cmd = train_command(args.config, args.epochs, args.device, extra)
    n = args.num_processes
    failures, attempt, port_retries = 0, 0, 0
    port = args.coordinator_port
    while True:
        attempt += 1
        if n > 1:
            # a fresh port an attempt: a killed group's listener may linger,
            # and a stale rank must not dial into the new group
            port = port or free_port()
            cmds = [cmd + ["--distributed", f"{args.coordinator_host}:{port},{n},{rank}"]
                    for rank in range(n)]
        else:
            cmds = [cmd]
        print(f"[supervise] attempt {attempt}: {' '.join(cmds[0])}"
              + (f" (+{n - 1} more ranks)" if n > 1 else ""), file=sys.stderr, flush=True)
        start = time.time()
        # stalls are judged by any ckpt_dir write (metrics.jsonl shows life
        # between checkpoints); the budget resets on checkpoint writes alone,
        # so a child that logs and then crashes every epoch still runs out
        stall_anchor = max(_latest_mtime(ckpt_dir), start)
        ckpt_anchor = _latest_mtime(ckpt_dir, suffix=".ckpt")
        children = [subprocess.Popen(c) for c in cmds]
        stalled, dead_rank, saw_write = False, None, False
        while any(c.poll() is None for c in children):
            time.sleep(args.poll)
            codes = [c.poll() for c in children]
            bad = [(r, c) for r, c in enumerate(codes) if c is not None and c != 0]
            if bad and any(c is None for c in codes):
                dead_rank = bad[0][0]
                print(f"[supervise] rank {dead_rank} exited {bad[0][1]}: SIGTERM the remaining "
                      "ranks", file=sys.stderr, flush=True)
                _terminate(children)
                break
            newest_ckpt = _latest_mtime(ckpt_dir, suffix=".ckpt")
            if newest_ckpt > ckpt_anchor:
                ckpt_anchor = newest_ckpt
                failures = 0  # checkpoint progress: a fresh budget
            newest = _latest_mtime(ckpt_dir)
            limit = args.stall_timeout if saw_write else max(args.stall_timeout,
                                                             args.startup_grace)
            if newest > stall_anchor:
                stall_anchor, saw_write = newest, True
            elif time.time() - stall_anchor > limit:
                pids = " ".join(str(c.pid) for c in children if c.poll() is None)
                print(f"[supervise] no ckpt_dir write for {limit:.0f}s: stall; SIGTERM child "
                      f"pid {pids}", file=sys.stderr, flush=True)
                _terminate(children)
                stalled = True
                break
        for c in children:  # reap every child before judging the attempt
            if c.poll() is None:
                c.wait()
        codes = [c.returncode for c in children]
        if all(c == 0 for c in codes) and not stalled:
            print(f"[supervise] run completed after {attempt} attempt(s)", file=sys.stderr,
                  flush=True)
            return 0
        port = None
        if (n > 1 and not stalled and codes[0] == PORT_IN_USE_EXIT
                and port_retries < MAX_PORT_RETRIES):
            port_retries += 1
            print(f"[supervise] coordinator port taken by another process: retry on a fresh "
                  f"port ({port_retries}/{MAX_PORT_RETRIES}), no restart spent",
                  file=sys.stderr, flush=True)
            continue
        port_retries = 0
        failures += 1
        if stalled:
            why = "stall"
        elif n > 1:
            first_bad = dead_rank if dead_rank is not None else next(
                r for r, c in enumerate(codes) if c != 0)
            why = f"rank {first_bad} exit code {codes[first_bad]}"
        else:
            why = f"exit code {codes[0]}"
        if failures > args.max_restarts:
            print(f"[supervise] {why}; restart budget exhausted ({args.max_restarts}): giving "
                  "up", file=sys.stderr, flush=True)
            return 1
        delay = args.backoff * (2 ** (failures - 1))
        print(f"[supervise] {why}; restart {failures}/{args.max_restarts} in {delay:.1f}s",
              file=sys.stderr, flush=True)
        time.sleep(delay)


def main(argv=None):
    raise SystemExit(supervise(argv))


if __name__ == "__main__":
    main()
