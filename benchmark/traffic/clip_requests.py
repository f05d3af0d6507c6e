"""Traffic kind `clip_requests`: an operator scoring whole clips.

Each request is one clip's windows, as `cli.serve`, the stream drains and
the server hand them to `AnomalyScorer.score_windows`: for each actor of
the clip, a track covering a share of its frames, windowed at stride 1, so
(track frames - seg_len + 1) windows an actor. Frames per clip, actors and
the share each track covers are drawn uniformly from the mix's ranges.

The set of requests is the same for every seed: `pool` requests whose
sizes are drawn from `sizes_seed`, enough that the tail of the sizes is
the mix's own. The run's seed draws their windows (on the device, in one
call) and the order the client walks them in. One closed-loop client sends
a request, waits for its scores on the host and sends the next. Set-up
sends the `warmup_requests` largest ones, which take the device's memory
to its peak; nothing is built or compiled for a size.

`request_ms_p95` is the 95th percentile over every request of the window,
each from its sending to its scores on the host; `score_windows_per_s`
every window scored over the window's time. Once the window has closed,
`checked_requests` of the requests served, drawn from the seed with the
longest among them, are held against the reference's scores of their
windows: every time each was served.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark import checks, program
from benchmark.reference import stse as ref

ENTRY = "AnomalyScorer.score_windows"
MIX_KEYS = ("frames", "actors", "track_share", "pool", "sizes_seed", "warmup_requests",
            "checked_requests", "trace_requests")


def faults(config: dict) -> tuple:
    """The faults of benchmark/faults.py a cell of this kind can have."""
    return ("half_batch_scores", "answer_altered")


def request_sizes(mix: dict, seg_len: int) -> list:
    """Windows of each request of the pool, from the mix alone."""
    rng = np.random.default_rng(int(mix["sizes_seed"]))
    lo_f, hi_f = mix["frames"]
    lo_a, hi_a = mix["actors"]
    lo_c, hi_c = mix["track_share"]
    sizes = []
    for _ in range(int(mix["pool"])):
        frames = int(rng.integers(lo_f, hi_f + 1))
        actors = int(rng.integers(lo_a, hi_a + 1))
        tracks = np.floor(rng.uniform(lo_c, hi_c, size=actors) * frames).astype(int)
        sizes.append(int(np.sum(np.maximum(tracks - seg_len + 1, 0))))
    return sizes


class Run:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        self.arch = ref.arch_of(cell.config)

    def setup(self) -> None:
        from coskad_tpu_torch.serve import AnomalyScorer

        config, mix = self.cell.config, self.cell.mix
        program.build_kernels(config, self.device)
        self.cfg = cfg = program.port_config(config, self.seed)
        self.sizes = request_sizes(mix, cfg.data.seg_len)
        data = program.windows(sum(self.sizes), config,
                               program.generator(self.seed, self.device, 0), self.device)
        self.payload_dev = list(torch.split(data, self.sizes))
        host = data.cpu().numpy()
        bounds = np.cumsum([0] + self.sizes)
        self.payloads = [host[bounds[i]:bounds[i + 1]] for i in range(len(self.sizes))]
        self.params = ref.make_params(self.arch, program.generator(self.seed, self.device, 1),
                                      self.device, trained=True)
        self.center = program.center(self.arch["latent"],
                                     program.generator(self.seed, self.device, 2), self.device)
        self.order = np.random.default_rng((self.seed, 3)).permutation(len(self.sizes))
        self.scorer = AnomalyScorer(cfg, None, device=self.device)
        program.load_weights(self.scorer.trainer.model, self.params)
        self.scorer.state = self.scorer.trainer.init_state().replace(center=self.center.clone())
        for i in np.argsort(self.sizes, kind="stable")[::-1][:int(mix["warmup_requests"])]:
            self.scorer.score_windows(self.payloads[i])
        self.next = 0
        self.served = []  # (pool index, scores)

    def _send(self):
        i = int(self.order[self.next % len(self.order)])
        self.next += 1
        t = time.perf_counter()
        scores = self.scorer.score_windows(self.payloads[i])
        return i, scores, time.perf_counter() - t

    def window(self, seconds: float) -> dict:
        latencies, windows, failed = [], 0, 0
        t0 = time.perf_counter()
        while True:
            i, scores, took = self._send()
            self.served.append((i, scores))
            latencies.append(took)
            windows += len(scores)
            ok = len(scores) == self.sizes[i] and math.isfinite(float(np.sum(scores)))
            failed += 0 if ok else 1
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        return {"attempted": len(latencies), "failed": failed, "seconds": elapsed,
                "items": windows,
                "end_to_end": {"score_windows_per_s": windows / elapsed,
                               "request_ms_p95": float(np.percentile(latencies, 95)) * 1e3}}

    def traced(self):
        """`trace_requests` more requests for the profiler; their batches."""
        k = int(self.cell.mix["trace_requests"])
        bs = self.scorer.trainer.batch_size
        start = self.next
        batches = sum(math.ceil(self.sizes[int(self.order[(start + j) % len(self.order)])] / bs)
                      for j in range(k))

        def fn():
            for _ in range(k):
                self._send()

        return fn, batches

    def route(self) -> dict:
        return program.route()

    def program_readings(self):
        return self.served

    def free(self) -> None:
        del self.scorer

    def checked(self) -> list:
        """The pool indices whose answers are compared: the longest request
        served and a sample of the others, drawn from the seed."""
        served = sorted({i for i, _ in self.served})
        if not served:
            return []
        longest = max(served, key=lambda i: (self.sizes[i], i))
        rest = [i for i in served if i != longest]
        k = min(int(self.cell.mix["checked_requests"]) - 1, len(rest))
        drawn = np.random.default_rng((self.seed, 4)).choice(len(rest), size=k, replace=False)
        return [longest] + [rest[j] for j in sorted(drawn)]

    def reference_readings(self, precision: str):
        table = torch.as_tensor(ref.transform_table(1), device=self.device)
        out = {}
        for i in self.checked():
            x = self.payload_dev[i]
            out[i] = ref.eval_scores(self.params, self.arch, x,
                                     torch.arange(len(x), device=self.device), table,
                                     self.center, precision=precision).cpu().numpy()
        return out

    def control_readings(self, precision: str):
        """The reference at `precision`, in the program's readings' form."""
        return sorted(self.reference_readings(precision).items())

    def compare(self, served, reference) -> dict:
        pairs = [(s, reference[i]) for i, s in served if i in reference]
        if not pairs:
            return {"score_gap": math.nan}
        return {"score_gap": checks.score_gap([s for s, _ in pairs], [r for _, r in pairs])}
