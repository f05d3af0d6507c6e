"""Convert checkpoints between the reference (PyTorch-Lightning) format and
the checkpoint format both packages read, in either direction.

Import (default):

    python -m coskad_tpu_torch.cli.convert --config <yaml> --ckpt <lightning.ckpt> \
        [--scaler robust.pkl] [--out converted.ckpt]

Export (a trained checkpoint back to the reference's torch files):

    python -m coskad_tpu_torch.cli.convert --config <yaml> --to-torch \
        --ckpt <coskad.ckpt> --out <lightning_style.ckpt> [--scaler robust.pkl]

Counterpart of `coskad_tpu/cli/convert.py`, with the same flags. The
config (the reference-format YAML the other CLIs take) says which model to
build; --scaler reads the reference's fitted-RobustScaler pickle, without
sklearn. The imported checkpoint is evaluated with `cli.eval --ckpt <out>`
or fine-tuned with `cli.train --resume` once placed at
<ckpt_dir>/last.ckpt. Conversion is host work: there is no --device. The
layout rules are in `coskad_tpu_torch/interop.py`.
"""

from __future__ import annotations

import argparse
import os
import shutil


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Convert checkpoints between the reference Lightning format and "
                    "coskad_tpu_torch (default: import; --to-torch: export)")
    parser.add_argument("-c", "--config", required=True,
                        help="reference-format YAML describing the model")
    parser.add_argument("--ckpt", required=True, help="reference PyTorch-Lightning .ckpt path")
    parser.add_argument("--scaler", default=None,
                        help="reference robust.pkl (fitted sklearn RobustScaler pickle) to embed")
    parser.add_argument("--out", default=None,
                        help="output path (default <ckpt_dir>/converted.ckpt)")
    parser.add_argument("--allow-missing-scaler", action="store_true",
                        help="convert a robust-normalized config without its robust.pkl (eval "
                             "will fit a scaler on the test split: scores will NOT match the "
                             "reference run)")
    parser.add_argument("--to-torch", action="store_true",
                        help="reverse direction: --ckpt is a coskad checkpoint, --out a "
                             "reference-format torch file")
    args = parser.parse_args(argv)

    from ..interop import convert_checkpoint, export_checkpoint
    from .common import load_config

    cfg = load_config(args.config)
    if args.to_torch:
        if not args.out:
            parser.error("--to-torch requires --out")
        out = export_checkpoint(args.ckpt, cfg, args.out)
        print(f"[coskad] exported {args.ckpt} -> {out} (reference format)")
        if args.scaler:
            # the reference loads its fitted scaler from the experiment
            # directory, as robust.pkl beside the checkpoints
            dst = os.path.join(os.path.dirname(os.path.abspath(out)), "robust.pkl")
            shutil.copyfile(args.scaler, dst)
            print(f"[coskad] copied scaler pickle -> {dst} (the reference loads it from the "
                  "experiment directory)")
        return out
    out = convert_checkpoint(args.ckpt, cfg, out_path=args.out, scaler_path=args.scaler,
                             allow_missing_scaler=args.allow_missing_scaler)
    print(f"[coskad] converted {args.ckpt} -> {out}")
    print(f"[coskad] evaluate with: python -m coskad_tpu_torch.cli.eval "
          f"--config {args.config} --ckpt {out}")
    return out


if __name__ == "__main__":
    main()
