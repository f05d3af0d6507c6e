"""Traffic kind `train_epochs`: a researcher's training job.

The config's resident windows (all of them, times its transforms) are
trained on by `Trainer.fit(state, epochs=1)`, called again and again; each
epoch is fit's own shuffle of every (window x transform) item in batches of
the config's size, the tail that does not fill a batch dropped.

Set-up builds the one Trainer the window then uses: the windows and the
initial weights from the seed, the center from the Trainer's own eval pass
(`initialize_center`), then fit's first epoch, `fit(state, epochs=1)`, the
window's own call, which also warms every shape the window uses. Its first
three steps are what `correct` compares with the reference: each step's
loss as fit logs it, the first gradient (from Adam's first moment after
one step), the parameters' change over the three, the starting center
and, for a dynamic center, the epoch-end update from the three steps'
latents and the center fit leaves at the epoch's end. The reference builds
fit's epoch-0 feed from the seed by the rule the reference repository
shuffles with, and takes the learning rate, the BatchNorm mode and the
center's tolerance from the config file, so a fit that feeds, freezes,
schedules or updates otherwise reads apart.

`train_windows_per_s` is every item of the epochs completed in the window
over the time from the window's start to the end of its last epoch.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark import checks, program
from benchmark.reference import stse as ref

ENTRY = "Trainer.fit"
MIX_KEYS = ()
CHECKED_STEPS = 3


def faults(config: dict) -> tuple:
    """The faults of benchmark/faults.py a cell of this kind can have."""
    dynamic = not config["reference"].get("static_center", True)
    return ("state_unchanged", "half_batch_train") + (("epoch_update_skipped",) if dynamic
                                                      else ())


def settings(config: dict) -> dict:
    """What the reference takes from the config file, never from the program."""
    r = config["reference"]
    if int(r.get("freeze_bn_after", -1)) == 0:
        raise ValueError("the reference trains with live or ghost BatchNorm only; "
                         "freeze_bn_after 0 freezes it from the first epoch")
    fused = r.get("fused_train", "off") != "off" and r["projector"] == "linear"
    return dict(lr=float(r["opt_lr"]), alpha=float(r["alpha"]),
                tol=float(r["center_tolerance"]), transforms=int(r["dataset_num_transform"]),
                bn="ghost" if fused else "live", ghost=int(r.get("ghost_size", 0)),
                dynamic=not r.get("static_center", True))


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(t.double())) for k, t in tensors.items()}


class _StepLog:
    """Stands in for the Trainer's logger during set-up's epoch: fit's own
    line of every step."""

    every_n_steps = 1

    def __init__(self):
        self.lines = {}

    def log(self, metrics: dict, step: int, force: bool = False) -> None:
        if not force:
            self.lines[int(step)] = dict(metrics)


class Run:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        self.arch = ref.arch_of(cell.config)
        self.settings = settings(cell.config)

    def setup(self) -> None:
        from coskad_tpu_torch.train.loop import Trainer

        config = self.cell.config
        program.build_kernels(config, self.device)
        program_cfg = program.port_config(config, self.seed)
        n = int(config["dataset"]["windows"])
        self.data = program.windows(n, config, program.generator(self.seed, self.device, 0),
                                    self.device)
        self.params = ref.make_params(self.arch, program.generator(self.seed, self.device, 1),
                                      self.device, trained=False)
        ds = program.segment_dataset(self.data, self.settings["transforms"])
        self.n_items = len(ds)
        self.trainer = tr = Trainer(program_cfg, ds, device=self.device)
        program.load_weights(tr.model, self.params)
        state = tr.initialize_center(tr.init_state())
        start_center = state.center.clone()
        self.batch = bs = int(config["reference"]["dataset_batch_size"])
        # fit's epoch-0 feed by the reference repository's rule, for the reference
        perm = np.random.default_rng((self.seed, 0)).permutation(self.n_items)
        self.checked = torch.as_tensor(perm[:CHECKED_STEPS * bs].reshape(CHECKED_STEPS, bs),
                                       device=self.device)
        named = dict(tr.model.named_parameters())
        start = {k: p.detach().clone() for k, p in named.items()}
        beta1 = tr.optimizer.param_groups[0]["betas"][0]
        seen = {}
        take_step = tr.train_step  # the bound method fit's epoch calls

        def step(state, *args, **kwargs):
            state, metrics = take_step(state, *args, **kwargs)
            k = seen["steps"] = seen.get("steps", 0) + 1
            if k == 1:  # what the optimizer got: its first moment (none: nothing)
                seen["grad1"] = _norms({
                    name: tr.optimizer.state[p].get("exp_avg", torch.zeros_like(p)) / (1 - beta1)
                    for name, p in named.items()})
            if k == CHECKED_STEPS:
                seen["change"] = _norms({name: p.detach() - start[name]
                                         for name, p in named.items()})
                if self.settings["dynamic"]:
                    seen["center_update"] = tr.apply_epoch_updates(state).center.cpu().numpy()
            seen["last"] = state
            return state, metrics

        logger, tr.logger, tr.train_step = tr.logger, _StepLog(), step
        try:
            state, _ = tr.fit(state, epochs=1)
        finally:
            log, tr.logger = tr.logger, logger
            del tr.train_step
        self.readings = {
            "losses": [log.lines.get(i, {}).get("loss", math.nan)
                       for i in range(1, CHECKED_STEPS + 1)],
            "grad1": seen.get("grad1", {}), "change": seen.get("change", {}),
            "center": start_center.cpu().numpy(),
            "center_update": seen.get("center_update"),
        }
        if self.settings["dynamic"]:
            # the center fit leaves, and the update of its epoch's own sums
            last = seen["last"]
            self.readings["epoch_center"] = state.center.cpu().numpy()
            self.readings["epoch_sums"] = (last.acc_vec.double().cpu(),
                                           float(last.acc_weight))
        self.state = state
        self.steps_per_epoch = self.n_items // bs

    def _epoch(self) -> float:
        self.state, history = self.trainer.fit(self.state, epochs=1)
        return history["loss"][-1]

    def window(self, seconds: float) -> dict:
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        epochs, failed, ends = 0, 0, []
        sync()
        t0 = time.perf_counter()
        while True:
            loss = self._epoch()
            epochs += 1
            failed += 0 if math.isfinite(loss) else self.steps_per_epoch
            sync()
            elapsed = time.perf_counter() - t0
            ends.append(elapsed)
            if elapsed >= seconds:
                break
        steps = epochs * self.steps_per_epoch
        return {"attempted": steps, "failed": failed, "seconds": elapsed, "steps": steps,
                "items": steps * self.batch, "parts_s": ends,
                "end_to_end": {"train_windows_per_s": steps * self.batch / elapsed}}

    def traced(self):
        """One more epoch, fit's own call, for the profiler; its steps."""
        return (lambda: self._epoch()), self.steps_per_epoch

    def route(self) -> dict:
        return program.route()

    def program_readings(self) -> dict:
        return self.readings

    def free(self) -> None:
        del self.trainer, self.state

    def reference_readings(self, precision: str) -> dict:
        """The reference's first three steps from the same windows, weights
        and feed, in float64: in float32 its own sums over a batch's 442,368
        rows left one leaf's gradient 1.5% from float64 where the program's
        was within 2e-4 of it. The epoch-end center is the reference's update
        of the program's own sums over the epoch's steps: the reference
        follows three of those steps, whose sums `center_update` compares."""
        s = self.settings
        params = {k: v.double() for k, v in self.params.items()}
        data = self.data.double()
        table = torch.as_tensor(ref.transform_table(s["transforms"]), device=self.device,
                                dtype=torch.float64)
        center = ref.center_of(params, self.arch, data, self.n_items, table, s["tol"],
                               precision=precision)
        out = ref.train_steps(params, self.arch, data, table, list(self.checked), center,
                              s["lr"], s["alpha"], bn=s["bn"], ghost=s["ghost"],
                              precision=precision)
        start = {k: v for k, v in params.items() if not ref.is_statistic(k)}
        readings = {
            "losses": out["losses"], "grad1": _norms(out["grad1"]),
            "change": _norms({k: out["params"][k] - start[k] for k in start}),
            "center": center.cpu().numpy(),
            "center_update": (ref.center_update(out["z_sum"], out["count"], s["tol"])
                              .cpu().numpy() if s["dynamic"] else None),
        }
        if s["dynamic"]:
            z_sum, count = self.readings["epoch_sums"]
            readings["epoch_center"] = ref.center_update(z_sum, count, s["tol"]).numpy()
        return readings

    def control_readings(self, precision: str) -> dict:
        """The reference at `precision`, in the program's readings' form."""
        return self.reference_readings(precision)

    def compare(self, program_readings: dict, reference_readings: dict) -> dict:
        return checks.train_gaps(program_readings, reference_readings)
