"""Online (streaming) anomaly scoring over live pose streams.

Counterpart of `coskad_tpu/streaming.py`. Frames arrive one at a time and
scores come out with bounded delay, while the offline semantics hold (to
the bit on the CPU, within the scores' band on the card; see below):

  * Windowing replicates `data/windows.py::segment_clip` exactly (stride 1,
    start_offset, the <=2-missing-frames continuity rule, and the
    reference's quirk that a person's final possible window is only
    emitted once a LATER row exists for them).
  * Preprocessing is `AnomalyScorer.preprocess_windows`, the code
    `score_clip_json` runs. Every shipped normalization strategy is
    window-local (`data/normalize.py`), so batch composition cannot change
    a window's values. 'robust' normalization REQUIRES the checkpoint's
    fitted scaler here: offline falls back to fitting on the whole clip,
    which a stream cannot do.
  * Aggregation (mean of non-zero window scores per (actor, frame), max
    over actors, pad_scores, shift + Gaussian smoothing) reuses the offline
    functions. So for the deterministic variants (the VAE's sampled eval is
    draw-dependent offline too) ``flush()`` equals
    ``AnomalyScorer.score_clip_json`` on the same data exactly on the CPU,
    and within the scores' band on the card (rtol 1e-3, atol 1e-6; 1.66e-9
    apart on an H100): there the stream's drains and the clip's batches
    give the projector's cuBLAS product other batch shapes, and it sums a
    window's row in another order for each. Scoring is not made
    batch-invariant (ROADMAP.md, Queue 3 item 5).

Batching: windows are not scored one by one. ``push`` buffers complete
windows and scores them through `AnomalyScorer.score_windows` (on the card
at float32, the eval encoder kernel K1) in batches of >= ``min_batch``;
``scores_so_far`` / ``flush`` force the remainder. Window scores are cached
per (person, window start), so flush never re-scores. What a batch costs on
the card is `chip_smoke.py`'s `streaming` phase.

Scope and cost model:

  * Default (``horizon=None``): one StreamingScorer covers ONE clip or
    session, like one score_clip_json call per clip offline. Keypoint rows
    that can no longer appear in any future window are freed as the stream
    advances; what grows with the stream is the score cache and the
    per-person key lists.
  * Unbounded feeds: pass ``horizon=H`` (frames). Rolling GC freezes
    frames older than H behind the stream head and frees their windows and
    stale person streams, bounding live state to O(actors x H) and
    re-aggregation to O(windows within H) per drain (see the class
    docstring for the lateness-watermark contract).
  * ``scores_so_far`` aggregates every LIVE scored window; results are
    memoized, so polling between drains is free.

Usage:
    scorer = AnomalyScorer.from_checkpoint("best.ckpt")
    stream = StreamingScorer(scorer)
    for frame_key, poses in camera:          # poses: {person_id: [V, 3]}
        stream.push(frame_key, poses)
        live = stream.scores_so_far()        # provisional, memoized
    final = stream.flush(smooth=True)        # == score_clip_json offline
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .score.frames import actor_frame_scores, pad_scores
from .score.smoothing import score_process
from .serve import AnomalyScorer

# Dead history is list-surgery; only trim once this many rows are dead.
_TRIM_SLACK = 64


class _PersonStream:
    """One tracked person's trajectory window emitter with history trim.

    ``keys``/``rows`` hold the suffix of the trajectory from absolute row
    index ``base`` onward; rows before ``next_start`` (the next candidate
    window start) can never appear in a future window (stride 1, starts
    are monotone) and their data/keys are already copied into pending
    windows at emit time, so they are freed.
    """

    __slots__ = ("keys", "rows", "next_start", "base")

    def __init__(self, start_offset: int):
        self.keys: List[int] = []
        self.rows: List[np.ndarray] = []
        self.base = 0  # absolute row index of keys[0]/rows[0]
        self.next_start = start_offset

    @property
    def count(self) -> int:
        return self.base + len(self.keys)

    def last_key(self) -> Optional[int]:
        return self.keys[-1] if self.keys else None

    def append(self, key: int, row: np.ndarray) -> None:
        self.keys.append(int(key))
        self.rows.append(row)

    def emit_new_windows(self, seg_len: int, start_offset: int):
        """(start, rows[T,V,F], frame_keys[T]) for every window that became
        valid with the rows appended so far.

        Offline validity for start s (`data/windows.py::
        split_trajectory_to_windows`): s is one of the attempted starts
        (s >= start_offset and s <= start_offset + c - seg_len - 1 for
        stride 1), the window is full (s + seg_len <= c),
        and the expected consecutive keys pass the <=2-missing continuity
        rule. Both upper bounds grow one row at a time, so scanning from
        next_start visits each start exactly once over the stream's life.
        """
        c = self.count
        out = []
        if c <= seg_len:
            return out
        limit = min(start_offset + c - seg_len - 1, c - seg_len)
        while self.next_start <= limit:
            s = self.next_start
            self.next_start += 1
            i = s - self.base
            ks = self.keys[i : i + seg_len]
            # is_seg_continuous without the O(history) .index() scan: keys
            # are strictly increasing, so |expected ∩ actual| is the count
            # of covered keys below start_key + seg_len.
            covered = sum(1 for k in ks if k < ks[0] + seg_len)
            if covered >= seg_len - 2:
                out.append((s, np.stack(self.rows[i : i + seg_len], axis=0),
                            list(ks)))
        dead = self.next_start - self.base
        if dead > _TRIM_SLACK:
            del self.keys[:dead]
            del self.rows[:dead]
            self.base = self.next_start
        return out


class StreamingScorer:
    """Incremental scorer wrapping a checkpoint-backed AnomalyScorer.

    ``horizon=None`` (default) is session-scoped: state grows with the
    stream (score cache + person key lists), sized for one clip like one
    offline score_clip_json call. ``horizon=H`` turns on ROLLING GC for
    unbounded 24/7 feeds: frames older than ``H`` behind the stream head
    are FROZEN (their aggregated score fixed) and the window scores and
    person streams behind them freed, so live state is O(actors x H)
    regardless of stream length. The contract is a standard lateness
    watermark: a window whose frames are all older than the horizon when
    it would score is dropped — with ``H >= seg_len + 3 + (min_batch
    buffering lag)`` no window of a continuously-tracked person is ever
    late, and the output equals the unbounded mode / offline exactly
    (tests/test_torch_streaming.py). Only the frozen per-frame score vector
    still grows (8 bytes/frame ≈ 1.7 MB/hour at 60 fps); requires
    ``pad_size == -1`` (absence padding needs whole-stream per-actor
    rows).
    """

    def __init__(self, scorer: AnomalyScorer, min_batch: int = 256,
                 horizon: Optional[int] = None):
        self.scorer = scorer
        d = scorer.cfg.data
        self.seg_len = d.seg_len
        self.start_offset = d.start_offset
        self.min_batch = max(int(min_batch), 1)
        if (d.normalize_pose and d.normalization_strategy == "robust"
                and getattr(scorer, "scaler", None) is None):
            raise ValueError(
                "streaming with normalization_strategy 'robust' requires "
                "the checkpoint's fitted scaler (offline mode falls back to "
                "fitting on the whole clip, which a stream cannot reproduce)"
            )
        self.horizon = None if horizon is None else int(horizon)
        if self.horizon is not None:
            if self.horizon < self.seg_len + 3:
                raise ValueError(
                    f"horizon must be >= seg_len + 3 (= {self.seg_len + 3}): "
                    "a window is only emitted once a later row exists, so a "
                    "smaller horizon would drop every window as late")
            if scorer.cfg.eval.pad_size != -1:
                raise ValueError(
                    "rolling GC (horizon) requires pad_size == -1: absence "
                    "padding needs per-actor rows over the whole stream, "
                    "which the GC frees")
        self._persons: Dict[int, _PersonStream] = {}
        # Complete-but-unscored windows: parallel lists.
        self._pending_raw: List[np.ndarray] = []  # [T, V, F] raw keypoints
        self._pending_key: List[Tuple[int, int, List[int]]] = []
        # (person_id, start) -> (score, frame_keys[T])
        self._scores: Dict[Tuple[int, int], Tuple[float, List[int]]] = {}
        self._max_key = 0
        # Rolling-GC state: frames [0, _frozen_upto) have final (unsmoothed,
        # actor-maxed) scores in _frozen; their windows are freed.
        self._frozen = np.zeros(0)
        self._frozen_upto = 0
        self._version = 0  # bumped on every drain/GC; keys the memo cache
        self._agg_cache: Optional[Tuple[Tuple[int, int, bool], np.ndarray]] = None

    # ------------------------------------------------------------ ingest

    def push(self, frame_key: int, poses: Dict[int, np.ndarray]) -> None:
        """Add one frame's tracked poses: {person_id: [V, 3] (x, y, conf)}.

        Frame keys are 1-based (the AlphaPose convention the offline
        pipeline scatters by, score/frames.py) and must be strictly
        increasing per person; both are validated BEFORE any state
        mutates, so a rejected push leaves the stream retryable.
        Low-confidence keypoints are zeroed by the config's kp_threshold
        exactly like parse-time ingestion (data/alphapose.py::parse_person), so
        feeding raw detector output here matches feeding the same clip's
        JSON to score_clip_json.

        Scores are computed lazily in >= min_batch device batches; this
        call touches the device only when the buffer fills.
        """
        frame_key = int(frame_key)
        if frame_key < 1:
            raise ValueError(
                f"frame keys are 1-based (got {frame_key}); a 0-based "
                "stream would silently shift every score by one frame"
            )
        # Validate every person before mutating anything (atomic push).
        for pid in poses:
            person = self._persons.get(int(pid))
            last = person.last_key() if person is not None else None
            if last is not None and frame_key <= last:
                raise ValueError(
                    f"frame keys must be strictly increasing per person "
                    f"(person {int(pid)}: got {frame_key} after {last}); "
                    "no state was modified — fix the key and re-push"
                )
        self._max_key = max(self._max_key, frame_key)
        thr = self.scorer.cfg.data.kp_threshold
        for pid, kp in poses.items():
            pid = int(pid)
            person = self._persons.get(pid)
            if person is None:
                person = self._persons[pid] = _PersonStream(self.start_offset)
            row = np.asarray(kp, np.float64).copy()
            if thr > 0 and row.shape[-1] >= 3:
                row[row[:, 2] < thr, :2] = 0.0
            person.append(frame_key, row)
            for s, rows, fk in person.emit_new_windows(
                    self.seg_len, self.start_offset):
                self._pending_raw.append(rows)
                self._pending_key.append((pid, s, fk))
        if len(self._pending_raw) >= self.min_batch:
            self._drain()

    # ----------------------------------------------------------- scoring

    def _drain(self) -> None:
        """Score every buffered window in one batched device call."""
        if not self._pending_raw:
            return
        raw = np.stack(self._pending_raw, axis=0)  # [N, T, V, F]
        keys = self._pending_key
        self._pending_raw, self._pending_key = [], []
        windows = self.scorer.preprocess_windows(raw)
        scores = self.scorer.score_windows(windows)
        watermark = (self._max_key - self.horizon
                     if self.horizon is not None else None)
        for (pid, s, fk), score in zip(keys, scores):
            if watermark is not None and fk[-1] <= watermark:
                continue  # late window behind the watermark: dropped
            self._scores[(pid, s)] = (float(score), fk)
        self._version += 1
        self._agg_cache = None
        if self.horizon is not None:
            self._gc()

    def _gc(self) -> None:
        """Advance the watermark: freeze the aggregated scores of frames
        older than the horizon, then free the window scores and person
        streams that can no longer contribute to a live frame. Runs only
        right after a full drain, so no pending window is skipped.

        The FREEZE boundary deliberately lags the LATE-DROP watermark by a
        full window span (seg_len + 2, the max key span of a continuous
        window): every window that survives the lateness check
        (fk[-1] > watermark) then lies entirely in the live region, so a
        delayed window (a person pausing while the stream head advances)
        is either applied IN FULL or dropped IN FULL — never half-applied
        against an already-frozen prefix, which would silently break the
        exact-parity contract."""
        watermark = self._max_key - self.horizon
        freeze_to = watermark - (self.seg_len + 2)
        if freeze_to <= self._frozen_upto:
            return
        full = self._clip_scores(self._max_key)
        self._frozen = np.concatenate(
            [self._frozen, full[self._frozen_upto:freeze_to]])
        self._frozen_upto = freeze_to
        # A window whose last frame key is <= freeze_to covers only frozen
        # indices (< freeze_to); frame key k scatters to index k-1. Any
        # FUTURE window touching a frozen frame would have
        # fk[-1] < watermark and be dropped as late, so frozen values are
        # final.
        self._scores = {k: v for k, v in self._scores.items()
                        if v[1][-1] > freeze_to}
        # A person last seen >2 frames behind the freeze boundary cannot
        # bridge a continuous window into the live region (the <=2-missing
        # rule); their unemitted tail windows would be late-dropped anyway.
        self._persons = {pid: p for pid, p in self._persons.items()
                         if (p.last_key() or 0) >= freeze_to - 2}
        self._version += 1
        self._agg_cache = None

    # -------------------------------------------------------- aggregation

    def _clip_scores(self, n_frames: int) -> np.ndarray:
        """Unsmoothed actor-maxed per-frame scores over the CURRENT window
        set (per-actor pad_scores applied in session mode; forbidden with
        rolling GC — see __init__)."""
        if not self._scores:
            return np.zeros(n_frames)
        actors = np.array(sorted({pid for pid, _ in self._scores}))
        w_scores, w_actor, w_frames = [], [], []
        for (pid, _s), (score, fk) in self._scores.items():
            w_scores.append(score)
            w_actor.append(np.searchsorted(actors, pid))
            w_frames.append(fk)
        per_actor = actor_frame_scores(
            np.asarray(w_scores), np.asarray(w_actor),
            np.asarray(w_frames, np.int64), n_frames, len(actors),
        )
        if self.scorer.cfg.eval.pad_size != -1:
            per_actor = np.stack([
                pad_scores(row, n_frames, self.scorer.cfg.eval.pad_size)
                for row in per_actor
            ])
        return per_actor.max(axis=0)

    def _aggregate(self, n_frames: int, smooth: bool) -> np.ndarray:
        """Offline aggregation (score/frames.py + smoothing) over every
        scored window (frozen frames splice in their fixed scores) —
        identical math to score_clip_json. Memoized until new scores land
        (push-poll loops pay once per drain)."""
        cache_key = (self._version, n_frames, smooth)
        if self._agg_cache is not None and self._agg_cache[0] == cache_key:
            return self._agg_cache[1]
        clip = self._clip_scores(n_frames)
        k = min(self._frozen_upto, n_frames)
        if k:
            clip = np.concatenate([self._frozen[:k], clip[k:]])
        out = score_process(clip) if smooth else clip
        self._agg_cache = (cache_key, out)
        return out

    def scores_so_far(self, smooth: bool = False) -> np.ndarray:
        """Provisional per-frame scores over frames seen so far (1-based
        keys -> index key-1), forcing any buffered windows to score first.

        Frames older than ``max_key - seg_len - 2`` are final UNLESS a
        tracked person reappears after a long absence (their earlier
        windows' emission waits on their next row — the offline
        final-window quirk). Smoothing is whole-clip (non-causal) offline;
        it defaults off here.
        """
        self._drain()
        return self._aggregate(self._max_key, smooth)

    def flush(self, n_frames: Optional[int] = None,
              smooth: bool = True) -> np.ndarray:
        """End of stream: score the remainder and return the full clip's
        per-frame scores — equal to AnomalyScorer.score_clip_json on the
        same data (deterministic variants; tests/test_torch_streaming.py).

        Like offline, the default length is the last WINDOW-COVERED frame
        key (score_clip_json's ids.max(): the final observed row is never
        inside a window, `data/windows.py::split_trajectory_to_windows`);
        pass n_frames to cover the full clip."""
        self._drain()
        if n_frames is None:
            last = (max(fk[-1] for _, fk in self._scores.values())
                    if self._scores else self._max_key)
            # Rolling GC may have frozen (window-covered) frames beyond the
            # last LIVE window; they count toward the offline default too.
            n_frames = max(last, self._frozen_upto)
        return self._aggregate(int(n_frames), smooth)

    # -------------------------------------------------------------- stats

    @property
    def n_windows_scored(self) -> int:
        return len(self._scores)

    @property
    def n_windows_pending(self) -> int:
        return len(self._pending_raw)
