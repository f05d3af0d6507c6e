"""Traffic kind `recon_passes`: offline evaluation of a decoder variant.

`Trainer.score_all` passes over the config's resident windows with all of
its transforms, as validation and `cli.eval --rec-weight` run them on an
autoencoder, again and again on one model: weights, BatchNorm statistics
and center made from the seed, as a checkpoint would carry them. A pass
gives two numbers a window, its latent distance to the center and its
reconstruction error; both are kept. Set-up warms the pass with
`warmup_passes` of them.

`score_windows_per_s` is every item scored in the window's passes over the
window's time. Once the window has closed, every pass's scores and
reconstruction errors are held against the plain reference's
(`benchmark/reference/stsae.py`) of the same items, each by
`checks.score_gap`'s measure: `score_gap` and `rec_gap`. The reference
that decides `correct` computes the configuration as it states it: its
casts round to the compute dtype's format (bf16 for the shipped file,
none at float32); the control computes it one precision down (fp8).
"""

from __future__ import annotations

import math
import time

import torch

from benchmark import checks, program
from benchmark.reference import stse as ref
from benchmark.reference import stsae

ENTRY = "Trainer.score_all"
MIX_KEYS = ("warmup_passes", "trace_passes")
CASTS = {"float32": "exact", "bfloat16": "bf16"}  # the reference's precision a compute dtype


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
        self.params = stsae.make_params(self.arch, program.generator(self.seed, self.device, 1),
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
        """(scores, reconstruction errors), numpy: the pass has finished on
        the device."""
        return self.trainer.score_all(self.state, self.ds, self.trainer.train_data)

    def window(self, seconds: float) -> dict:
        passes, failed, ends = 0, 0, []
        t0 = time.perf_counter()
        while True:
            scores, rec = self._pass()
            self.served.append((scores, rec))
            passes += 1
            failed += 0 if math.isfinite(float(scores.sum()) + float(rec.sum())) else 1
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
        """The launch counters; `K1_decoder` the decoder's K1 launches (0
        for a program whose decoder has no such counter)."""
        from coskad_tpu_torch.kernels import stse_fused

        counter = getattr(stse_fused, "decoder_launches", None)
        return dict(program.route(), K1_decoder=0 if counter is None else counter.value)

    def program_readings(self):
        return self.served

    def free(self) -> None:
        del self.trainer, self.state

    def reference_readings(self, precision: str):
        """The reference's (scores, reconstruction errors) at `precision`;
        "exact", the one `correct` compares with, at the configuration's
        compute dtype."""
        if precision == "exact":
            precision = CASTS[self.cell.config["reference"].get("compute_dtype", "float32")]
        table = torch.as_tensor(ref.transform_table(self.transforms), device=self.device)
        idx = torch.arange(len(self.ds), device=self.device)
        scores, rec = stsae.eval_outputs(self.params, self.arch, self.data, idx, table,
                                         self.center, precision=precision)
        return scores.cpu().numpy(), rec.cpu().numpy()

    def control_readings(self, precision: str):
        """The reference at `precision`, in the program's readings' form."""
        return [self.reference_readings(precision)]

    def compare(self, served, reference) -> dict:
        return {"score_gap": checks.score_gap([s for s, _ in served], [reference[0]] * len(served)),
                "rec_gap": checks.score_gap([r for _, r in served], [reference[1]] * len(served))}
