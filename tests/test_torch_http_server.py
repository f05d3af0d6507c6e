"""The port's HTTP serving daemon (`coskad_tpu_torch/http_server.py`) and
its CLIs: every route reproduces the port's library calls.

The tests of `tests/test_http_server.py` on the port: each endpoint's
response against the in-process AnomalyScorer / StreamingScorer on the same
inputs (JSON carries the float32 scores exactly, so equal to the bit), the
error mapping (400 / 404 / 429 / 501), both request encodings (JSON and .npy
bodies), keep-alive safety, and the artifact backend (`export_hlo`'s
artifact of the served checkpoint: windows to the artifact's bits, the
routes that need preprocessing refused with JAX's messages, `cli.server
--artifact`); then a chunked body answered 501 with its connection closed
and `cli.serve` writing exactly what `score_clip_json` returns. One JAX
checkpoint serves the module (tests/test_torch_streaming.py's)."""

import http.client
import io
import json
import os
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from coskad_tpu_torch.cli import serve as serve_cli
from coskad_tpu_torch.cli import server as server_cli
from coskad_tpu_torch import http_server
from coskad_tpu_torch.export_hlo import export_scorer, load_artifact
from coskad_tpu_torch.http_server import ScoringService, Unsupported, build_server
from coskad_tpu_torch.serve import AnomalyScorer
from test_torch_streaming import frames_of, jax_checkpoint

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A JAX-trained checkpoint loaded by the port, served on an ephemeral
    loopback port."""
    ckpt, clip_json = jax_checkpoint(str(tmp_path_factory.mktemp("http")))
    scorer = AnomalyScorer.from_checkpoint(ckpt, device="cpu")
    service = ScoringService(scorer=scorer, source=ckpt, max_streams=2)
    server = build_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield {"url": f"http://127.0.0.1:{server.server_address[1]}", "scorer": scorer,
               "clip_json": clip_json, "ckpt": ckpt, "port": server.server_address[1]}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        assert not thread.is_alive()


def call(url, method="GET", body=None, ctype="application/json"):
    """-> (status, parsed JSON). Error statuses return, not raise."""
    data = None
    if body is not None:
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_health_and_model_info(served):
    status, health = call(served["url"] + "/healthz")
    assert status == 200 and health["status"] == "ok"
    status, info = call(served["url"] + "/v1/model")
    assert status == 200 and info["backend"] == "checkpoint"
    assert info["variant"] == "euclidean_static" and info["seg_len"] == 12
    assert info["encoder"] == "sts_gcn" and info["device"] == "cpu"


def test_score_windows_json_matches_library(served):
    windows = np.random.default_rng(0).normal(size=(9, 3, 12, 18)).astype(np.float32)
    status, resp = call(served["url"] + "/v1/score/windows", "POST",
                        {"windows": windows.tolist()})
    assert status == 200
    np.testing.assert_array_equal(np.float32(resp["scores"]),
                                  served["scorer"].score_windows(windows))


def test_score_windows_npy_body_and_raw_mode(served):
    raw = (np.random.default_rng(1).normal(size=(5, 12, 17, 3)) * 50 + 200).astype(np.float32)
    buf = io.BytesIO()
    np.save(buf, raw)
    status, resp = call(served["url"] + "/v1/score/windows?raw=1", "POST", buf.getvalue(),
                        ctype="application/x-npy")
    assert status == 200
    scorer = served["scorer"]
    np.testing.assert_array_equal(np.float32(resp["scores"]),
                                  scorer.score_windows(scorer.preprocess_windows(raw)))


def test_score_clip_matches_library(served):
    body = open(served["clip_json"], "rb").read()
    status, resp = call(served["url"] + "/v1/score/clip?n_frames=64", "POST", body)
    assert status == 200
    np.testing.assert_array_equal(
        resp["scores"], served["scorer"].score_clip_json(served["clip_json"], n_frames=64))


def test_stream_lifecycle_equals_offline(served):
    url = served["url"]
    status, resp = call(url + "/v1/streams", "POST", {"min_batch": 64, "horizon": 48})
    assert status == 200
    sid = resp["stream_id"]
    by_frame = frames_of(served["clip_json"])
    frames = [{"frame": fk, "poses": {str(pid): kp.tolist() for pid, kp in by_frame[fk].items()}}
              for fk in sorted(by_frame)]
    mid = len(frames) // 2
    for chunk in (frames[:mid], frames[mid:]):  # session state carries over
        status, resp = call(url + f"/v1/streams/{sid}/frames", "POST", {"frames": chunk})
        assert status == 200 and resp["applied"] == len(chunk)
    status, prov = call(url + f"/v1/streams/{sid}/scores?smooth=0")
    assert status == 200 and prov["n_frames"] > 0
    status, final = call(url + f"/v1/streams/{sid}/flush?n_frames=64", "POST")
    assert status == 200
    np.testing.assert_array_equal(
        final["scores"], served["scorer"].score_clip_json(served["clip_json"], n_frames=64))
    status, _ = call(url + f"/v1/streams/{sid}/scores")
    assert status == 404  # flush closed the session


def test_error_mapping(served):
    url = served["url"]
    assert call(url + "/v1/nope")[0] == 404
    status, resp = call(url + "/v1/score/windows", "POST", {"wrong": 1})
    assert status == 400 and "windows" in resp["error"]
    status, resp = call(url + "/v1/score/windows", "POST", {"windows": [[1.0, 2.0]]})
    assert status == 400 and "4-D" in resp["error"]
    _, resp = call(url + "/v1/streams", "POST")
    sid = resp["stream_id"]
    kp = np.zeros((17, 3)).tolist()
    status, resp = call(url + f"/v1/streams/{sid}/frames", "POST",
                        {"frames": [{"frame": 5, "poses": {"1": kp}},
                                    {"frame": 5, "poses": {"1": kp}}]})
    assert status == 400 and "strictly increasing" in resp["error"]
    assert "1 earlier frames" in resp["error"]
    _, resp = call(url + "/v1/streams", "POST")
    sid2 = resp["stream_id"]
    assert call(url + "/v1/streams", "POST")[0] == 429  # max_streams=2
    for s in (sid, sid2):
        assert call(url + f"/v1/streams/{s}", "DELETE")[0] == 200
    assert call(url + f"/v1/streams/{sid}", "DELETE")[0] == 404


def test_keepalive_survives_unread_body_responses(served):
    """A response sent with the request body unread (unknown-route 404,
    oversized 400) closes the connection, so the unread bytes are never
    parsed as the next request."""
    conn = http.client.HTTPConnection("127.0.0.1", served["port"])
    try:
        body = json.dumps({"windows": np.zeros((2, 3, 12, 18)).tolist()}).encode()
        for _ in range(2):
            conn.request("POST", "/v1/score/windows", body, {"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 200
            resp.read()
        conn.request("POST", "/v1/nope", b'{"x": 1}', {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 404 and resp.getheader("Connection", "").lower() == "close"
        resp.read()
    finally:
        conn.close()
    conn = http.client.HTTPConnection("127.0.0.1", served["port"])
    try:
        conn.putrequest("POST", "/v1/score/windows")
        conn.putheader("Content-Type", "application/json")
        conn.putheader("Content-Length", str(10**12))
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 400 and resp.getheader("Connection", "").lower() == "close"
    finally:
        conn.close()


def test_chunked_body_gets_501_and_a_closed_connection(served):
    """A chunked request carries no Content-Length: its body is never read,
    so the server answers 501 and closes the connection rather than parse
    the chunks as the next request (a raw socket reads to EOF, which a
    keep-alive connection would never give)."""
    before = call(served["url"] + "/healthz")[1]["n_requests"]
    body = json.dumps({"windows": np.zeros((1, 3, 12, 18)).tolist()}).encode()
    request = (b"POST /v1/score/windows HTTP/1.1\r\nHost: 127.0.0.1\r\n"
               b"Content-Type: application/json\r\nTransfer-Encoding: chunked\r\n\r\n"
               b"%x\r\n%s\r\n0\r\n\r\n" % (len(body), body))
    with socket.create_connection(("127.0.0.1", served["port"]), timeout=10) as sock:
        sock.sendall(request)
        reply = b""
        while chunk := sock.recv(65536):
            reply += chunk
    head, _, payload = reply.partition(b"\r\n\r\n")
    lines = head.decode().split("\r\n")
    assert lines[0].split()[1] == "501"
    assert "connection: close" in [line.lower() for line in lines[1:]]
    assert "Transfer-Encoding" in json.loads(payload)["error"]
    status, health = call(served["url"] + "/healthz")  # the server still serves
    assert status == 200 and health["n_requests"] == before + 2


def test_nonfinite_scores_yield_valid_json_500(served):
    buf = io.BytesIO()
    np.save(buf, np.full((3, 3, 12, 18), np.nan, np.float32))
    status, resp = call(served["url"] + "/v1/score/windows", "POST", buf.getvalue(),
                        ctype="application/x-npy")
    assert status == 500 and "non-finite" in resp["error"]


def test_malformed_clip_json_is_400_not_404(served, monkeypatch):
    kp = [1.0, 2.0, 0.9] * 17
    traj = {f"{f:04d}": {"keypoints": kp} for f in range(1, 15)}
    traj["0007"] = {"notkeypoints": kp}
    body = json.dumps({"1": traj}).encode()
    status, resp = call(served["url"] + "/v1/score/clip", "POST", body)
    assert status == 400 and "error" in resp

    def boom(self, *a, **k):
        raise KeyError("keypoints")

    monkeypatch.setattr(AnomalyScorer, "score_clip_json", boom)
    status, resp = call(served["url"] + "/v1/score/clip", "POST", body)
    assert status == 400 and "missing key" in resp["error"] and "keypoints" in resp["error"]


@pytest.fixture(scope="module")
def artifact(served, tmp_path_factory):
    """The served checkpoint's scoring artifact, exported on the CPU."""
    path = str(tmp_path_factory.mktemp("artifact") / "scorer.zip")
    export_scorer(served["scorer"], path)
    return path


def test_artifact_backend_is_refused(served, artifact):
    """One backend at a time; the artifact backend refuses, in JAX's words,
    what needs preprocessing or a model: raw keypoints, clips, streams."""
    with pytest.raises(ValueError, match="exactly one of scorer= / artifact="):
        ScoringService()
    art = load_artifact(artifact, device="cpu")
    with pytest.raises(ValueError, match="exactly one of scorer= / artifact="):
        ScoringService(scorer=served["scorer"], artifact=art)
    service = ScoringService(artifact=art)
    with pytest.raises(Unsupported, match="raw keypoint preprocessing needs a checkpoint "
                                          "backend; the artifact expects model-ready"):
        service.score_windows(np.zeros((2, 12, 17, 3), np.float32), raw=True)
    with pytest.raises(Unsupported, match="^clip scoring needs a checkpoint backend$"):
        service.score_clip(b"{}", None, True)
    with pytest.raises(Unsupported, match="^streaming needs a checkpoint backend$"):
        service.create_stream(None)


def test_artifact_backend_scores_without_model_code(served, artifact):
    service = ScoringService(artifact=load_artifact(artifact, device="cpu"), source=artifact)
    server = build_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        status, info = call(url + "/v1/model")
        assert status == 200 and info["backend"] == "artifact" and info["source"] == artifact
        assert info["variant"] == "euclidean_static" and info["encoder_route"] == "modules"
        assert info["serving_device"] == "cpu" and "draw_key" not in info

        windows = np.random.default_rng(2).normal(size=(7, 3, 12, 18)).astype(np.float32)
        status, resp = call(url + "/v1/score/windows", "POST", {"windows": windows.tolist()})
        assert status == 200
        want = service.artifact.score_windows(windows)
        np.testing.assert_array_equal(np.float32(resp["scores"]), want)
        np.testing.assert_allclose(want, served["scorer"].score_windows(windows),
                                   rtol=5e-6, atol=1e-6)
        buf = io.BytesIO()
        np.save(buf, windows)
        status, resp = call(url + "/v1/score/windows", "POST", buf.getvalue(),
                            ctype="application/x-npy")
        assert status == 200 and np.array_equal(np.float32(resp["scores"]), want)

        status, resp = call(url + "/v1/score/windows?raw=1", "POST",
                            {"windows": windows.tolist(), "raw": True})
        assert status == 501 and "checkpoint backend" in resp["error"]
        status, resp = call(url + "/v1/streams", "POST")
        assert status == 501
        status, resp = call(url + "/v1/score/clip", "POST", b"{}")
        assert status == 501
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def test_server_cli_serves_an_artifact(artifact, monkeypatch, capsys):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            server_cli.main(["--artifact", artifact, "--port", "0"])
    started = []

    class Server:  # records the service instead of serving forever
        server_address = ("127.0.0.1", 0)

        def __init__(self, service, *args, **kwargs):
            self.service = service

        def serve_forever(self):
            started.append(self.service)

        def server_close(self):
            pass

    monkeypatch.setattr(http_server, "build_server", Server)
    assert server_cli.main(["--artifact", artifact, "--port", "0", "--device", "cpu"]) == 0
    (service,) = started
    assert service.scorer is None and service.artifact.device.type == "cpu"
    assert f"artifact backend from {artifact} on cpu" in capsys.readouterr().out


def test_clis_default_to_cuda(served):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        server_cli.main(["--ckpt", served["ckpt"], "--port", "0"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_cli.main(["--ckpt", served["ckpt"], served["clip_json"]])


def test_serve_cli_writes_score_clip_json(served, tmp_path, capsys):
    scorer, clip = served["scorer"], served["clip_json"]
    stem = os.path.basename(clip)[:-len(".json")]
    out = tmp_path / "npy"
    assert serve_cli.main(["--ckpt", served["ckpt"], clip, "--out", str(out),
                           "--device", "cpu"]) == 0
    np.testing.assert_array_equal(np.load(out / f"{stem}_scores.npy"),
                                  scorer.score_clip_json(clip))
    gt = tmp_path / "gt"
    gt.mkdir()
    np.save(gt / "01_0001.npy", np.zeros(450))
    missing = str(tmp_path / "missing.json")
    code = serve_cli.main(["--ckpt", served["ckpt"], clip, missing, "--out", str(tmp_path / "js"),
                           "--json", "--no-smooth", "--n-frames-from-gt", str(gt),
                           "--device", "cpu"])
    assert code == 1 and "FAILED" in capsys.readouterr().err  # one clip failed, one scored
    with open(tmp_path / "js" / f"{stem}_scores.json") as f:
        got = json.load(f)
    assert got == [float(s) for s in scorer.score_clip_json(clip, n_frames=450, smooth=False)]
