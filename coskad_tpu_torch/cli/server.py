"""Long-running scoring server.

    python -m coskad_tpu_torch.cli.server --ckpt exp/UBnormal/run/best.ckpt --port 8800
    python -m coskad_tpu_torch.cli.server --artifact model.zip --port 8800
    python -m coskad_tpu_torch.cli.server --ckpt best.ckpt --device cpu

Counterpart of `coskad_tpu/cli/server.py`. Backends: a training
checkpoint (windows, raw windows, clip JSON, streaming sessions) or a
`cli.export` artifact (model-ready windows only, with no model code on the
serving host); routes and request formats are in
`coskad_tpu_torch/http_server.py`. Runs on CUDA unless `--device cpu`; the
kernels cache their builds, so there is no compile cache to enable.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="coskad-server-torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--ckpt", help="training checkpoint (.ckpt)")
    src.add_argument("--artifact",
                     help="serialized scoring artifact (cli.export zip)")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address (default loopback; set 0.0.0.0 "
                        "explicitly to expose the server)")
    p.add_argument("--port", type=int, default=8800)
    p.add_argument("--min-batch", type=int, default=256,
                   help="default device-batch threshold for new streaming "
                        "sessions (windows scored a batch)")
    p.add_argument("--max-streams", type=int, default=64)
    p.add_argument("--verbose", action="store_true",
                   help="log one line per request to stderr")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    from ..http_server import ScoringService, build_server

    if args.ckpt:
        from ..serve import AnomalyScorer

        backend = {"scorer": AnomalyScorer.from_checkpoint(args.ckpt, device=args.device)}
        source = args.ckpt
    else:
        from ..export_hlo import load_artifact

        backend = {"artifact": load_artifact(args.artifact, device=args.device)}
        source = args.artifact
    service = ScoringService(source=source, min_batch=args.min_batch,
                             max_streams=args.max_streams, **backend)
    server = build_server(service, args.host, args.port,
                          verbose=args.verbose)
    host, port = server.server_address[:2]
    print(f"[server] {service.model_info()['backend']} backend from "
          f"{source} on {args.device}", flush=True)
    print(f"[server] listening on http://{host}:{port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
