"""Export a checkpoint's scoring program as a `torch.export` artifact.

    python -m coskad_tpu_torch.cli.export --ckpt best.ckpt --out model.zip
    python -m coskad_tpu_torch.cli.export --ckpt best.ckpt --out model.zip \
        --batch-size 512 --device cpu

Counterpart of `coskad_tpu/cli/export.py`. The artifact (`export_hlo.py`)
holds the program with its weights, BatchNorm statistics and geometry as
buffers, so serving loads it with `coskad_tpu_torch.export_hlo.
load_artifact` (no model code, no checkpoint parsing). The program is
traced on `--device` (default cuda, where the float32 sts_gcn encoder runs
K1 inside it); the loader moves it to the other device when asked. The
JAX export's `--platforms` has no counterpart and is refused.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Serialize a COSKAD scoring program (torch.export)")
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--out", required=True, help="artifact zip to write")
    parser.add_argument("--config", default=None,
                        help="config YAML (default: the <ckpt>.config.json snapshot written "
                             "at train time)")
    parser.add_argument("--batch-size", type=int, default=None,
                        help="fixed batch dimension; default exports a symbolic batch (any "
                             "request size)")
    parser.add_argument("--platforms", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--in-channels", type=int, default=None,
                        help="input channels (default: the training window layout, "
                             "num_coords + confidence)")
    parser.add_argument("--device", default="cuda",
                        help="device the program is traced on: 'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    if args.platforms is not None:
        parser.error("--platforms is the JAX export's (StableHLO lowering targets); this "
                     "artifact is traced on one device: pass --device cuda or --device cpu "
                     "(load_artifact moves it to the other)")

    from ..export_hlo import export_scorer
    from ..serve import AnomalyScorer

    cfg = None
    if args.config is not None:
        from .common import load_config

        cfg = load_config(args.config)
    scorer = AnomalyScorer.from_checkpoint(args.ckpt, cfg=cfg, device=args.device)
    meta = export_scorer(scorer, args.out, batch_size=args.batch_size,
                         in_channels=args.in_channels)
    print(json.dumps({
        "artifact": args.out,
        "variant": meta["variant"],
        "device": meta["device"],
        "encoder_route": meta["encoder_route"],
        "batch_size": meta["batch_size"],
        "in_channels": meta["in_channels"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
