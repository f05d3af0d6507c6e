#!/usr/bin/env python3
"""K1's eval route on the card, at the benchmark configurations' widths: what
the host spends a call, the launch plan's counters, and the outputs, saved
for a bit-for-bit comparison with another checkout's.

    python3 k1_route_probe.py [--root DIR] [--out FILE.pt] [--against FILE.pt]

`--root` probes the port of another checkout (default: this one). For each
of benchmark/configs' flagship (float32 K1), hrstc (bf16 K1) and
ubnormal-ae (bf16 K1 on the encoder's and the decoder's stacks), a model
drawn from a fixed seed, with BatchNorm statistics drawn too, in eval mode
under `inference_mode`:

  * host microseconds a call at batch 8, where the card waits on the host:
    `_hidden` (the encoder's route), `folded()` (the plan on a hit), the
    whole eval forward, and for the autoencoder `decode`; the median of 5
    rounds of 400 calls;
  * the counters `plan_hits`, `plan_builds`, `launches` and
    `decoder_launches` over 10 eval forwards at 2048 windows, and over 3
    more after one SGD step (a checkout without a counter leaves it out);
  * the encoder's hidden state and the eval forward's outputs at 2048
    windows, written to `--out`; with `--against`, compared bit for bit
    with that file, and the exit code is 1 where any differs.

One JSON line, `k1_route_probe {...}`, holds the readings. Needs the card;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIGS = ("flagship", "hrstc", "ubnormal-ae")
COUNTERS = ("plan_hits", "plan_builds", "launches", "decoder_launches")


def _model(name: str, torch, device):
    from coskad_tpu_torch.config import from_reference_dict
    from coskad_tpu_torch.train.loop import model_kwargs_from_config
    from coskad_tpu_torch.models.stse import build_model

    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        cfg = from_reference_dict(dict(json.load(f)["reference"], seed=11))
    model = build_model(**model_kwargs_from_config(cfg))
    gen = torch.Generator().manual_seed(11)
    model.reset_parameters(gen)
    with torch.no_grad():
        for key, buf in model.named_buffers():
            if key.endswith((".mean", ".var")):
                lo, hi = (-0.5, 0.5) if key.endswith(".mean") else (0.5, 2.0)
                buf.copy_(torch.empty(buf.shape).uniform_(lo, hi, generator=gen))
    return cfg, model.to(device).eval()


def _counters(stse_fused) -> dict:
    return {k: getattr(stse_fused, k).value for k in COUNTERS if hasattr(stse_fused, k)}


def _counted(stse_fused, torch, fn, n: int) -> dict:
    before = _counters(stse_fused)
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return {k: v - before[k] for k, v in _counters(stse_fused).items()}


def _host_us(torch, fn, calls: int = 400, rounds: int = 5) -> float:
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def probe(torch, device) -> tuple:
    from coskad_tpu_torch.kernels import stse_fused

    readings, outputs = {}, {}
    gen = torch.Generator(device=device).manual_seed(7)
    for name in CONFIGS:
        cfg, model = _model(name, torch, device)
        shape = (cfg.model.num_coords, model.n_frames, model.n_joints)
        small = torch.rand(8, *shape, device=device, generator=gen) * 2 - 1
        big = torch.rand(2048, *shape, device=device, generator=gen) * 2 - 1
        row = {}
        with torch.inference_mode():
            assert model.kernel_takes(), f"{name}: K1 does not take the encoder"
            row["hidden_host_us"] = _host_us(torch, lambda: model._hidden(small, False, False))
            row["folded_host_us"] = _host_us(torch, model.folded)
            row["forward_host_us"] = _host_us(torch, lambda: model(small))
            outputs[f"{name}.hidden"] = model._hidden(big, False, False).cpu()
            out = model(big)
            for i, t in enumerate(out if isinstance(out, tuple) else (out,)):
                outputs[f"{name}.forward.{i}"] = t.cpu()
            if hasattr(model, "decode"):
                assert model.decoder_kernel_takes(), f"{name}: K1 does not take the decoder"
                z = out[0][:8].clone()
                row["decode_host_us"] = _host_us(torch, lambda: model.decode(z))
            row["steady_10_forwards"] = _counted(stse_fused, torch, lambda: model(big), 10)
        model.train()
        out = model(small, train=True)
        loss = sum(t.square().mean() for t in (out if isinstance(out, tuple) else (out,)))
        loss.backward()
        torch.optim.SGD(model.parameters(), lr=1e-3).step()
        model.eval()
        with torch.inference_mode():
            row["after_step_3_forwards"] = _counted(stse_fused, torch, lambda: model(big), 3)
        readings[name] = row
    return readings, outputs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT, help="the checkout whose port is probed")
    ap.add_argument("--out", help="where the outputs are saved (torch.save)")
    ap.add_argument("--against", help="outputs saved by another run, compared bit for bit")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    readings, outputs = probe(torch, torch.device("cuda"))
    result = {"root": os.path.abspath(args.root), "device": torch.cuda.get_device_name(),
              "configs": readings}
    differ = []
    if args.against:
        saved = torch.load(args.against)
        differ = [k for k in outputs if k not in saved or not torch.equal(outputs[k], saved[k])]
        result["bits"] = {"against": args.against, "compared": len(outputs), "differ": differ}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        torch.save(outputs, args.out)
    print("k1_route_probe", json.dumps(result))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
