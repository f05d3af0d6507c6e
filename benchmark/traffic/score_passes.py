"""Traffic kind `score_passes`: offline evaluation and validation.

`Trainer.score_all` passes over the config's resident windows with all of
its transforms, as validation and `cli.eval` run them, again and again on
one trained model: weights, BatchNorm statistics and center made from the
seed, as a checkpoint would carry them. Set-up warms the pass with
`warmup_passes` of them.

`score_windows_per_s` is every item scored in the window's passes over the
window's time. Every pass's scores are kept and, once the window has
closed, each is held against the reference's scores of the same items.
"""

from __future__ import annotations

import math
import time

import torch

from benchmark import checks, program
from benchmark.reference import stse as ref

ENTRY = "Trainer.score_all"
MIX_KEYS = ("warmup_passes", "trace_passes")


def faults(config: dict) -> tuple:
    """The faults of benchmark/faults.py a cell of this kind can have."""
    return ("half_batch_scores", "answer_altered")


class Run:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        self.arch = ref.arch_of(cell.config)

    def setup(self) -> None:
        from coskad_tpu_torch.train.loop import Trainer

        config = self.cell.config
        program.build_kernels(config, self.device)
        cfg = program.port_config(config, self.seed)
        n = int(config["dataset"]["windows"])
        self.data = program.windows(n, config, program.generator(self.seed, self.device, 0),
                                    self.device)
        self.params = ref.make_params(self.arch, program.generator(self.seed, self.device, 1),
                                      self.device, trained=True)
        self.center = program.center(self.arch["latent"],
                                     program.generator(self.seed, self.device, 2), self.device)
        self.transforms = int(config["reference"]["dataset_num_transform"])
        self.ds = program.segment_dataset(self.data, self.transforms)
        self.trainer = tr = Trainer(cfg, self.ds, device=self.device)
        program.load_weights(tr.model, self.params)
        self.state = tr.init_state().replace(center=self.center.clone())
        for _ in range(int(self.cell.mix["warmup_passes"])):
            self._pass()
        self.served = []

    def _pass(self):
        scores, _ = self.trainer.score_all(self.state, self.ds, self.trainer.train_data)
        return scores

    def window(self, seconds: float) -> dict:
        passes, failed, ends = 0, 0, []
        t0 = time.perf_counter()
        while True:
            scores = self._pass()  # numpy: the pass has finished on the device
            self.served.append(scores)
            passes += 1
            failed += 0 if bool(math.isfinite(float(scores.sum()))) else 1
            elapsed = time.perf_counter() - t0
            ends.append(elapsed)
            if elapsed >= seconds:
                break
        items = passes * len(self.ds)
        return {"attempted": passes, "failed": failed, "seconds": elapsed, "items": items,
                "parts_s": ends,
                "end_to_end": {"score_windows_per_s": items / elapsed}}

    def traced(self):
        """`trace_passes` more passes for the profiler; their batches."""
        k = int(self.cell.mix["trace_passes"])

        def fn():
            for _ in range(k):
                self._pass()

        return fn, k * math.ceil(len(self.ds) / self.trainer.batch_size)

    def route(self) -> dict:
        return program.route()

    def program_readings(self):
        return self.served

    def free(self) -> None:
        del self.trainer, self.state

    def reference_readings(self, precision: str):
        table = torch.as_tensor(ref.transform_table(self.transforms), device=self.device)
        idx = torch.arange(len(self.ds), device=self.device)
        return ref.eval_scores(self.params, self.arch, self.data, idx, table, self.center,
                               precision=precision).cpu().numpy()

    def control_readings(self, precision: str):
        """The reference at `precision`, in the program's readings' form."""
        return [self.reference_readings(precision)]

    def compare(self, served, reference) -> dict:
        return {"score_gap": checks.score_gap(served, [reference] * len(served))}
