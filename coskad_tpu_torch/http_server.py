"""HTTP serving daemon: one loaded model, scored over the network.

Counterpart of `coskad_tpu/http_server.py`, over the port's library scorers:

    python -m coskad_tpu_torch.cli.server --ckpt best.ckpt --port 8800
    python -m coskad_tpu_torch.cli.server --artifact model.zip --port 8800

Endpoints (all JSON unless noted):

    GET  /healthz                         liveness + request counter
    GET  /v1/model                        model/config metadata
    POST /v1/score/windows                {"windows": [...], "raw": bool}
                                          or a raw .npy body
                                          (Content-Type: application/x-npy,
                                          ?raw=1) -> {"scores": [...]}
    POST /v1/score/clip?n_frames=&smooth= AlphaPose tracked-clip JSON body
                                          -> {"scores": [...]} per frame
    POST /v1/streams                      {"min_batch": N, "horizon": H}?
                                          -> {"stream_id"}
    POST /v1/streams/<id>/frames          {"frames": [{"frame": k,
                                          "poses": {pid: [[x,y,c]..]}}..]}
    GET  /v1/streams/<id>/scores?smooth=  provisional per-frame scores
    POST /v1/streams/<id>/flush?n_frames=&smooth=
                                          final scores; closes the stream
    DELETE /v1/streams/<id>

Design constraints, deliberate:

  * stdlib only (`http.server`): the serving path adds no dependency.
  * ONE lock serializes every scoring call and every stream mutation: the
    model's state (BatchNorm buffers, K1's fold cache on the model) and the
    stream sessions are not re-entrant. The server still threads
    (ThreadingHTTPServer), so /healthz answers while a big batch scores.
  * two backends: a checkpoint (`AnomalyScorer`, every route) or a
    `torch.export` artifact (`export_hlo.load_artifact`, no model code):
    model-ready windows only, 501 on the routes that need preprocessing
    (raw keypoints, clips, streams).
  * window scores are identical to the library calls: the handlers do no
    numerics of their own, they only parse and route
    (tests/test_torch_http_server.py against the in-process scorer).
  * a request body is read only by its Content-Length. A request with a
    Transfer-Encoding header (chunked) is answered 501 and its connection
    closed: its unread body would otherwise be parsed as the next request
    on a keep-alive connection.
"""

from __future__ import annotations

import io
import json
import os
import tempfile
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from .streaming import StreamingScorer

MAX_BODY_BYTES = 512 * 1024 * 1024  # one 2048-window request of JSON floats is ~30 MB


class Unsupported(Exception):
    """A request the server or this backend does not implement (HTTP 501)."""


class StreamLimit(Exception):
    """Too many live streaming sessions (HTTP 429)."""


class UnknownStream(Exception):
    """Stream id does not exist (HTTP 404). A dedicated type so the 404
    mapping cannot swallow KeyErrors escaping library code (a malformed
    clip JSON missing 'keypoints') is a 400 or a 500, not 'not found'."""


class ScoringService:
    """Request logic over one backend: exactly one of `scorer`
    (`serve.AnomalyScorer`) and `artifact` (`export_hlo.ExportedScorer`).
    The HTTP handler only parses and routes. Every method that touches the
    device or mutates stream sessions holds `self.lock`."""

    def __init__(self, scorer=None, artifact=None, *, source: str = "",
                 min_batch: int = 256, max_streams: int = 64):
        if (scorer is None) == (artifact is None):
            raise ValueError("pass exactly one of scorer= / artifact=")
        self.scorer = scorer
        self.artifact = artifact
        self.source = source
        self.min_batch = int(min_batch)
        self.max_streams = int(max_streams)
        self.lock = threading.Lock()
        self.streams: Dict[str, object] = {}
        # The request counter is the stated liveness signal; its own lock so
        # /healthz increments never wait behind a scoring call holding
        # self.lock (read-modify-write from ThreadingHTTPServer handler
        # threads would otherwise drop increments).
        self.count_lock = threading.Lock()
        self.n_requests = 0

    # ------------------------------------------------------------- info

    def model_info(self) -> dict:
        if self.artifact is not None:
            meta = {k: v for k, v in self.artifact.meta.items()
                    if not isinstance(v, (list, dict))}
            # meta's "device" is the one the program was traced on
            return {"backend": "artifact", "source": self.source, **meta,
                    "serving_device": str(self.artifact.device), "n_streams": 0}
        cfg = self.scorer.cfg
        return {
            "backend": "checkpoint",
            "source": self.source,
            "variant": cfg.model.variant,
            "encoder": cfg.model.encoder_type,
            "seg_len": cfg.data.seg_len,
            "n_joints": cfg.data.n_joints,
            "num_coords": cfg.model.num_coords,
            "normalization_strategy": cfg.data.normalization_strategy,
            "batch_size": cfg.data.batch_size,
            "compute_dtype": cfg.run.compute_dtype,
            "device": str(self.scorer.trainer.device),
            "n_streams": len(self.streams),
        }

    # ---------------------------------------------------------- scoring

    def score_windows(self, windows: np.ndarray, raw: bool) -> np.ndarray:
        windows = np.asarray(windows, np.float32)
        if windows.ndim != 4:
            raise ValueError(
                f"windows must be 4-D (got shape {windows.shape}): "
                "[N, C, T, V] model-ready, or [N, T, V, F] keypoints with "
                "raw=true")
        with self.lock:
            if self.artifact is not None:
                if raw:
                    raise Unsupported(
                        "raw keypoint preprocessing needs a checkpoint "
                        "backend; the artifact expects model-ready "
                        "[N, C, T, V] windows")
                return self.artifact.score_windows(windows)
            if raw:
                windows = self.scorer.preprocess_windows(windows)
            return self.scorer.score_windows(windows)

    def score_clip(self, body: bytes, n_frames: Optional[int],
                   smooth: bool) -> np.ndarray:
        if self.artifact is not None:
            raise Unsupported("clip scoring needs a checkpoint backend")
        # score_clip_json's contract is a path (shared with the batch CLI);
        # spool the request body rather than forking a second parser.
        fd, path = tempfile.mkstemp(suffix=".json")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(body)
            with self.lock:
                return self.scorer.score_clip_json(
                    path, n_frames=n_frames, smooth=smooth)
        finally:
            os.unlink(path)

    # ---------------------------------------------------------- streams

    def create_stream(self, min_batch: Optional[int],
                      horizon: Optional[int] = None) -> str:
        if self.artifact is not None:
            raise Unsupported("streaming needs a checkpoint backend")
        with self.lock:
            if len(self.streams) >= self.max_streams:
                raise StreamLimit(
                    f"{len(self.streams)} live streams (max "
                    f"{self.max_streams}); flush or DELETE one first")
            sid = uuid.uuid4().hex[:12]
            self.streams[sid] = StreamingScorer(
                self.scorer,
                min_batch=min_batch if min_batch is not None
                else self.min_batch,
                horizon=horizon)
            return sid

    def _stream(self, sid: str):
        try:
            return self.streams[sid]
        except KeyError:
            raise UnknownStream(f"unknown stream {sid!r} (flushed or never "
                                "created)") from None

    def push_frames(self, sid: str, frames: list) -> dict:
        applied = 0
        with self.lock:
            stream = self._stream(sid)
            try:
                for item in frames:
                    poses = {
                        int(pid): np.asarray(kp, np.float64).reshape(-1, 3)
                        for pid, kp in item["poses"].items()
                    }
                    stream.push(int(item["frame"]), poses)
                    applied += 1
            except (KeyError, TypeError) as e:
                raise ValueError(
                    f"frame {applied}: each item needs 'frame' and 'poses' "
                    f"{{pid: [[x,y,conf]*V]}} ({e}); {applied} earlier "
                    "frames were applied") from e
            except ValueError as e:
                # push validates before mutating, so the failed frame left
                # no partial state; earlier frames in this request did land.
                raise ValueError(f"{e} ({applied} earlier frames in this "
                                 "request were applied)") from e
            return {"applied": applied,
                    "windows_scored": stream.n_windows_scored,
                    "windows_pending": stream.n_windows_pending}

    def stream_scores(self, sid: str, smooth: bool) -> np.ndarray:
        with self.lock:
            return self._stream(sid).scores_so_far(smooth=smooth)

    def flush_stream(self, sid: str, n_frames: Optional[int],
                     smooth: bool) -> np.ndarray:
        with self.lock:
            scores = self._stream(sid).flush(n_frames=n_frames, smooth=smooth)
            del self.streams[sid]
            return scores

    def delete_stream(self, sid: str) -> None:
        with self.lock:
            self._stream(sid)
            del self.streams[sid]


# --------------------------------------------------------------- handler


def _flag(qs: dict, name: str, default: bool) -> bool:
    if name not in qs:
        return default
    v = qs[name][-1].lower()
    if v in ("1", "true", "yes"):
        return True
    if v in ("0", "false", "no"):
        return False
    raise ValueError(f"query param {name}={v!r} is not a boolean")


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    # -- plumbing

    def log_message(self, fmt, *args):  # noqa: N802 (stdlib name)
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    def _send(self, code: int, payload: dict) -> None:
        try:
            # allow_nan=False: bare NaN/Infinity tokens are invalid JSON and
            # break strict clients (JSON.parse, Go, jq). Non-finite scores
            # mean a diverged model or garbage input -> a clean 500.
            body = json.dumps(payload, allow_nan=False).encode()
        except ValueError:
            code = 500
            body = json.dumps({"error": "non-finite values in response "
                               "(diverged model or invalid input)"}).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if not getattr(self, "_body_consumed", True):
            # Responding with the request body still unread (unknown-route
            # 404, oversized 400): announce + force connection close so the
            # leftover bytes cannot be parsed as the next request line.
            self.send_header("Connection", "close")
            self.close_connection = True
        self.end_headers()
        self.wfile.write(body)

    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        if n > MAX_BODY_BYTES:
            raise ValueError(f"request body {n} bytes exceeds the "
                             f"{MAX_BODY_BYTES}-byte limit")
        body = self.rfile.read(n)
        self._body_consumed = True
        return body

    def _dispatch(self, method: str) -> None:
        svc: ScoringService = self.server.service
        url = urlparse(self.path)
        parts = [p for p in url.path.split("/") if p]
        qs = parse_qs(url.query)
        # Keep-alive safety: if this request carries a body and we respond
        # without having read it (unknown-route 404, oversized-body 400),
        # the unread bytes would be parsed as the NEXT request line on the
        # persistent connection, corrupting every later request — so close
        # the connection instead of leaving the stream misaligned.
        cl = self.headers.get("Content-Length") or "0"
        try:
            pending = int(cl)
        except ValueError:
            pending = -1  # non-numeric header: 400 below, connection closed
        # A chunked (or otherwise transfer-encoded) body has no
        # Content-Length: it is never read, so its connection is closed.
        encoding = self.headers.get("Transfer-Encoding")
        self._body_consumed = pending == 0 and encoding is None
        try:
            with svc.count_lock:
                svc.n_requests += 1
            if encoding is not None:
                raise Unsupported(f"Transfer-Encoding {encoding!r} is not supported: send "
                                  "the body with a Content-Length")
            if pending < 0:
                raise ValueError(f"invalid Content-Length {cl!r}")
            self._route(method, parts, qs, svc)
        except Unsupported as e:
            self._send(501, {"error": str(e)})
        except StreamLimit as e:
            self._send(429, {"error": str(e)})
        except UnknownStream as e:
            self._send(404, {"error": str(e)})
        except KeyError as e:
            # A KeyError escaping the parse/route layer is malformed input
            # (e.g. clip JSON missing 'keypoints'), not 'not found'.
            self._send(400, {"error": f"missing key {e.args[0]!r}"
                             if e.args else str(e)})
        except (ValueError, json.JSONDecodeError) as e:
            self._send(400, {"error": str(e)})
        except Exception as e:  # pragma: no cover - last-resort mapping
            self._send(500, {"error": f"{type(e).__name__}: {e}"})
        finally:
            # Backstop for paths that never reached _send.
            if not self._body_consumed:
                self.close_connection = True

    # -- routing

    def _route(self, method, parts, qs, svc: ScoringService) -> None:
        if method == "GET" and parts == ["healthz"]:
            self._send(200, {"status": "ok", "n_requests": svc.n_requests,
                             "n_streams": len(svc.streams)})
            return
        if method == "GET" and parts == ["v1", "model"]:
            self._send(200, svc.model_info())
            return
        if method == "POST" and parts == ["v1", "score", "windows"]:
            body = self._body()
            ctype = (self.headers.get("Content-Type") or "").split(";")[0]
            if ctype in ("application/x-npy", "application/octet-stream"):
                arr = np.load(io.BytesIO(body), allow_pickle=False)
                raw = _flag(qs, "raw", False)
            else:
                req = json.loads(body or b"{}")
                if "windows" not in req:
                    raise ValueError("JSON body must contain 'windows'")
                arr = np.asarray(req["windows"], np.float32)
                raw = bool(req.get("raw", _flag(qs, "raw", False)))
            scores = svc.score_windows(arr, raw=raw)
            self._send(200, {"scores": [float(s) for s in scores]})
            return
        if method == "POST" and parts == ["v1", "score", "clip"]:
            n_frames = (int(qs["n_frames"][-1]) if "n_frames" in qs else None)
            scores = svc.score_clip(self._body(), n_frames,
                                    _flag(qs, "smooth", True))
            self._send(200, {"scores": [float(s) for s in scores]})
            return
        if method == "POST" and parts == ["v1", "streams"]:
            req = json.loads(self._body() or b"{}")
            # "horizon": rolling-GC lateness watermark in frames — one
            # stream instance then survives an unbounded 24/7 feed
            # (streaming.py class docstring).
            sid = svc.create_stream(req.get("min_batch"),
                                    req.get("horizon"))
            self._send(200, {"stream_id": sid})
            return
        if len(parts) == 3 and parts[:2] == ["v1", "streams"] \
                and method == "DELETE":
            svc.delete_stream(parts[2])
            self._send(200, {"deleted": parts[2]})
            return
        if len(parts) == 4 and parts[:2] == ["v1", "streams"]:
            sid, leaf = parts[2], parts[3]
            if method == "POST" and leaf == "frames":
                req = json.loads(self._body())
                if not isinstance(req.get("frames"), list):
                    raise ValueError("JSON body must contain 'frames': [...]")
                self._send(200, svc.push_frames(sid, req["frames"]))
                return
            if method == "GET" and leaf == "scores":
                scores = svc.stream_scores(sid, _flag(qs, "smooth", False))
                self._send(200, {"scores": [float(s) for s in scores],
                                 "n_frames": len(scores)})
                return
            if method == "POST" and leaf == "flush":
                n_frames = (int(qs["n_frames"][-1])
                            if "n_frames" in qs else None)
                scores = svc.flush_stream(sid, n_frames,
                                          _flag(qs, "smooth", True))
                self._send(200, {"scores": [float(s) for s in scores],
                                 "n_frames": len(scores)})
                return
        self._send(404, {"error": f"no route {method} {'/'.join(parts)!r}"})

    def do_GET(self):  # noqa: N802
        self._dispatch("GET")

    def do_POST(self):  # noqa: N802
        self._dispatch("POST")

    def do_DELETE(self):  # noqa: N802
        self._dispatch("DELETE")


def build_server(service: ScoringService, host: str = "127.0.0.1",
                 port: int = 0, verbose: bool = False) -> ThreadingHTTPServer:
    """Bind (port 0 = ephemeral, for tests) but do not serve yet; call
    .serve_forever() — server.server_address holds the bound (host, port)."""
    server = ThreadingHTTPServer((host, port), _Handler)
    server.service = service
    server.verbose = verbose
    return server
