"""The port's streaming scorer (`coskad_tpu_torch/streaming.py`): online
pushes reproduce offline clip scoring.

The tests of `tests/test_streaming.py`, on the port: feeding a clip frame
by frame through StreamingScorer.push and calling flush() returns the
port's AnomalyScorer.score_clip_json on that clip's JSON exactly (the
windowing quirks, preprocessing and aggregation included), however the
batches split; the rolling GC and its guards. Then the port's stream
against the JAX package's StreamingScorer on the same weights and clip,
within tests/test_torch_serve.py's SCORE_TOL (rtol 1e-3, atol 1e-6: scores
square latent differences that agree to fp32 reassociation). One JAX
checkpoint serves the module: JAX's cli.train on the synthetic tree, at
narrow widths, loaded by both packages."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import yaml

from coskad_tpu.serve import AnomalyScorer as JaxScorer
from coskad_tpu.streaming import StreamingScorer as JaxStreamingScorer
from coskad_tpu_torch import config as tconfig
from coskad_tpu_torch.serve import AnomalyScorer
from coskad_tpu_torch.streaming import StreamingScorer
from fixtures import make_synthetic_dataset

torch.set_num_threads(1)

SCORE_TOL = dict(rtol=1e-3, atol=1e-6)
NARROW = dict(channels=[8, 4, 8], h_dim=16, latent_dim=4, dataset_batch_size=64)


def jax_checkpoint(root):
    """JAX cli.train for one epoch on the synthetic tree (one train and one
    test clip of 420 frames), the model at narrow widths: (ckpt, clip JSON)."""
    from coskad_tpu.cli import train as train_cli

    cfg_path = make_synthetic_dataset(root, n_train_clips=1, n_test_clips=1)
    with open(cfg_path) as f:
        raw = yaml.safe_load(f)
    raw.update(NARROW)
    with open(cfg_path, "w") as f:
        yaml.safe_dump(raw, f)
    train_cli.main(["--config", cfg_path, "--epochs", "1"])
    ckpt = os.path.join(root, "checkpoints", "Synthetic", "smoke", "best.ckpt")
    test_dir = os.path.join(root, "pose", "testing")
    return ckpt, os.path.join(test_dir, sorted(os.listdir(test_dir))[0])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    ckpt, clip_json = jax_checkpoint(str(tmp_path_factory.mktemp("stream")))
    return AnomalyScorer.from_checkpoint(ckpt, device="cpu"), clip_json, ckpt


def frames_of(clip_json):
    """{frame key: {person: [V, 3]}}: the union of all persons present at
    each frame, the live-camera access pattern."""
    clip = json.load(open(clip_json))
    by_frame = {}
    for pid, traj in clip.items():
        for fk, entry in traj.items():
            kp = np.asarray(entry["keypoints"], np.float64).reshape(-1, 3)
            by_frame.setdefault(int(fk), {})[int(pid)] = kp
    return by_frame


def stream_clip(stream, clip_json):
    by_frame = frames_of(clip_json)
    for fk in sorted(by_frame):
        stream.push(fk, by_frame[fk])
    return stream


def test_streaming_flush_matches_offline(trained):
    scorer, clip_json, _ = trained
    n_frames = 64
    offline = scorer.score_clip_json(clip_json, n_frames=n_frames)
    stream = stream_clip(StreamingScorer(scorer, min_batch=256), clip_json)
    online = stream.flush(n_frames=n_frames, smooth=True)
    np.testing.assert_array_equal(online, offline)
    assert stream.n_windows_pending == 0 and stream.n_windows_scored > 0
    # the whole clip, at its default length
    again = stream_clip(StreamingScorer(scorer, min_batch=256), clip_json)
    np.testing.assert_array_equal(again.flush(), scorer.score_clip_json(clip_json))


def test_streaming_batch_split_is_score_invariant(trained):
    """A small min_batch (frequent small device calls) gives one big
    batch's scores: eval-mode BN uses running statistics and every
    preprocessing step is window-local."""
    scorer, clip_json, _ = trained
    big = stream_clip(StreamingScorer(scorer, min_batch=10_000), clip_json)
    tiny = stream_clip(StreamingScorer(scorer, min_batch=7), clip_json)
    np.testing.assert_array_equal(tiny.flush(n_frames=64, smooth=False),
                                  big.flush(n_frames=64, smooth=False))


def test_scores_so_far_prefix_is_final(trained):
    """Provisional scores for frames well behind the stream head already
    equal the end-of-stream (unsmoothed) scores while every person keeps
    streaming."""
    scorer, clip_json, _ = trained
    stream = StreamingScorer(scorer, min_batch=16)
    by_frame = frames_of(clip_json)
    keys = sorted(by_frame)
    cut = len(keys) * 2 // 3
    for fk in keys[:cut]:
        stream.push(fk, by_frame[fk])
    seen = keys[cut - 1]
    provisional = stream.scores_so_far(smooth=False)
    for fk in keys[cut:]:
        stream.push(fk, by_frame[fk])
    final = stream.flush(smooth=False)
    horizon = min(seen - scorer.cfg.data.seg_len - 2, len(provisional), len(final))
    assert horizon > 8
    np.testing.assert_array_equal(provisional[:horizon], final[:horizon])


def test_streaming_guards(trained):
    """Robust normalization without a fitted scaler is refused (offline
    fits one on the whole clip, which a stream cannot), and so are
    0-based and non-increasing frame keys; a refused push changes nothing."""
    scorer, _, _ = trained
    cfg_rb = dataclasses.replace(scorer.cfg, data=dataclasses.replace(
        scorer.cfg.data, normalization_strategy="robust"))
    bare = AnomalyScorer(cfg_rb, scorer.state, trainer=scorer.trainer)
    with pytest.raises(ValueError, match="fitted scaler"):
        StreamingScorer(bare)

    stream = StreamingScorer(scorer)
    kp = np.zeros((17, 3))
    with pytest.raises(ValueError, match="1-based"):
        stream.push(0, {1: kp})
    stream.push(5, {1: kp})
    with pytest.raises(ValueError, match="strictly increasing"):
        stream.push(5, {1: kp})
    stream.push(6, {2: kp})
    with pytest.raises(ValueError, match="strictly increasing"):
        stream.push(6, {1: kp, 2: kp, 3: kp})
    stream.push(7, {1: kp, 2: kp, 3: kp})
    assert stream._persons[1].last_key() == 7
    assert stream._persons[3].count == 1


def test_person_history_is_trimmed(trained):
    scorer, clip_json, _ = trained
    stream = stream_clip(StreamingScorer(scorer, min_batch=64), clip_json)
    seg = scorer.cfg.data.seg_len
    for pid, person in stream._persons.items():
        assert person.base > 0, f"person {pid} history never trimmed"
        assert len(person.rows) <= 64 + seg + 2
    np.testing.assert_array_equal(stream.flush(n_frames=64, smooth=True),
                                  scorer.score_clip_json(clip_json, n_frames=64))


def test_rolling_gc_equals_unbounded_and_offline(trained):
    scorer, clip_json, _ = trained
    n_frames = 420
    offline = scorer.score_clip_json(clip_json, n_frames=n_frames)
    stream = stream_clip(StreamingScorer(scorer, min_batch=32, horizon=48), clip_json)
    assert stream._frozen_upto > 200
    np.testing.assert_array_equal(stream.flush(n_frames=n_frames, smooth=True), offline)


def test_rolling_gc_bounds_live_state(trained):
    """A long feed with person turnover: live state stays O(actors x
    horizon) while the windows scored grow with the stream."""
    scorer, _, _ = trained
    rng = np.random.default_rng(0)
    stream = StreamingScorer(scorer, min_batch=64, horizon=60)
    n_frames, n_live = 2000, 3
    bases = {}
    max_scores = max_persons = 0
    for f in range(1, n_frames + 1):
        gen = f // 400
        poses = {}
        for k in range(n_live):
            pid = gen * 10 + k
            if pid not in bases:
                bases[pid] = rng.uniform(150, 500, size=(17, 2))
            bases[pid] = bases[pid] + rng.normal(scale=1.5, size=(17, 2))
            poses[pid] = np.concatenate([bases[pid], rng.uniform(0.5, 1.0, size=(17, 1))],
                                        axis=-1)
        stream.push(f, poses)
        max_scores = max(max_scores, stream.n_windows_scored + stream.n_windows_pending)
        max_persons = max(max_persons, len(stream._persons))
    assert max_scores < 600, max_scores
    assert max_persons <= 2 * n_live, max_persons
    assert stream._frozen_upto > 1500
    out = stream.flush(n_frames=n_frames, smooth=True)
    assert out.shape == (n_frames,) and np.isfinite(out).all()
    assert (out[:500] > 0).any() and (out[-200:] > 0).any()


def test_rolling_gc_guards(trained):
    scorer, _, _ = trained
    with pytest.raises(ValueError, match="seg_len"):
        StreamingScorer(scorer, horizon=10)
    old_eval = scorer.cfg.eval
    scorer.cfg.eval = dataclasses.replace(old_eval, pad_size=5)
    try:
        with pytest.raises(ValueError, match="pad_size"):
            StreamingScorer(scorer, horizon=100)
    finally:
        scorer.cfg.eval = old_eval


def test_flush_empty_stream_returns_empty(trained):
    scorer, _, _ = trained
    for kwargs in ({}, {"horizon": 64}):
        stream = StreamingScorer(scorer, **kwargs)
        assert stream.flush(smooth=True).shape == (0,)
        assert stream.scores_so_far(smooth=True).shape == (0,)
        out = StreamingScorer(scorer, **kwargs).flush(n_frames=7, smooth=True)
        assert out.shape == (7,) and (out == 0).all()


def test_rolling_gc_delayed_person_windows_apply_in_full():
    """A person absent for a stretch emits their pre-gap tail windows only
    once a later row arrives; those windows reach back a window span behind
    the late-drop watermark, and the freeze boundary lags the watermark by
    that span so they apply in full. A stub scorer (a window's score encodes
    its person and start; the delayed person dominates the actor max):
    rolling-GC flush == unbounded flush, exactly."""
    cfg = tconfig.Config(data=tconfig.DataConfig(seg_len=12, normalize_pose=False,
                                                 kp18_format=False))

    class StubScorer:
        def __init__(self):
            self.cfg = cfg
            self.scaler = None

        def preprocess_windows(self, raw):
            return raw

        def score_windows(self, windows):
            person = windows[:, 0, 0, 2]
            start_key = windows[:, 0, 0, 0]
            return np.where(person > 1.5, 100.0 + start_key, 1.0 + 0.001 * start_key)

    def push_all(stream):
        for f in range(1, 301):
            kp_a = np.full((17, 3), 1.0)
            kp_a[:, 0] = f
            poses = {1: kp_a}
            if not (151 <= f <= 160):
                kp_b = np.full((17, 3), 2.0)
                kp_b[:, 0] = f
                poses[2] = kp_b
            stream.push(f, poses)
        return stream

    unbounded = push_all(StreamingScorer(StubScorer(), min_batch=1))
    rolled = push_all(StreamingScorer(StubScorer(), min_batch=1, horizon=15))
    assert rolled._frozen_upto > 200
    np.testing.assert_array_equal(rolled.flush(n_frames=300, smooth=True),
                                  unbounded.flush(n_frames=300, smooth=True))
    assert unbounded.flush(n_frames=300, smooth=False)[145] > 100.0


@pytest.mark.parametrize("horizon", [None, 48])
def test_flush_matches_jax_streaming_scorer(trained, horizon):
    """The same checkpoint and clip through JAX's StreamingScorer and the
    port's: the per-frame scores within SCORE_TOL."""
    scorer, clip_json, ckpt = trained
    jscorer = JaxScorer.from_checkpoint(ckpt)
    want = stream_clip(JaxStreamingScorer(jscorer, min_batch=64, horizon=horizon),
                       clip_json).flush(n_frames=420)
    got = stream_clip(StreamingScorer(scorer, min_batch=64, horizon=horizon),
                      clip_json).flush(n_frames=420)
    assert got.shape == want.shape == (420,) and (got > 0).any()
    np.testing.assert_allclose(got, want, **SCORE_TOL)
