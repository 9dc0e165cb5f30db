"""(Copy of the reference's ``service/counters.py``.)

Quality counters: the reference's perf overlay surface, made structured.

The contract (BASELINE.json: "quality counters in performance.ts"): FPS,
per-frame inference latency ms, total frame ms, thread-load %.  Reference
implementations: the live overlay (client/src/core/main.ts:96-105, 500 ms
window) and the dead performance.ts monitor (:9-29, thread-load proxy
``delta / (1000/60)``).

Here: a ring-buffer `LatencyWindow` giving p50/p95/mean over a sliding
window, plus per-engine `Counters` aggregating fps / inference-vs-total
split / thread load, exported as a plain dict (`snapshot()`) for logging or
an HTTP stats endpoint.
"""

from __future__ import annotations

import collections
import dataclasses
import time


class LatencyWindow:
    """Sliding window of duration samples (ms) with percentile queries."""

    def __init__(self, maxlen: int = 256):
        self._buf = collections.deque(maxlen=maxlen)

    def add(self, ms: float) -> None:
        self._buf.append(float(ms))

    def __len__(self):
        return len(self._buf)

    def percentile(self, q: float) -> float:
        if not self._buf:
            return 0.0
        xs = sorted(self._buf)
        idx = min(len(xs) - 1, max(0, round(q / 100 * (len(xs) - 1))))
        return xs[idx]

    @property
    def p50(self) -> float:
        return self.percentile(50)

    @property
    def p95(self) -> float:
        return self.percentile(95)

    @property
    def mean(self) -> float:
        return sum(self._buf) / len(self._buf) if self._buf else 0.0


@dataclasses.dataclass
class Counters:
    """Engine-level counters; `update_interval_s` mirrors the reference's
    500 ms overlay refresh (main.ts:98)."""

    target_fps: float = 30.0
    update_interval_s: float = 0.5

    def __post_init__(self):
        self.inference = LatencyWindow()
        self.total = LatencyWindow()
        self._frames = 0
        self._streams = 0
        self._window_start = time.monotonic()
        self._fps = 0.0
        self._frames_in_window = 0

    def record_step(self, n_streams: int, inference_ms: float, total_ms: float):
        """One batch step processed n_streams frames."""
        self.inference.add(inference_ms)
        self.total.add(total_ms)
        self._frames += n_streams
        self._frames_in_window += n_streams
        self._streams = n_streams
        now = time.monotonic()
        dt = now - self._window_start
        if dt >= self.update_interval_s:
            self._fps = self._frames_in_window / dt
            self._frames_in_window = 0
            self._window_start = now

    @property
    def fps(self) -> float:
        """Aggregate frames/s over the last window (all streams)."""
        return self._fps

    @property
    def per_stream_fps(self) -> float:
        return self._fps / self._streams if self._streams else 0.0

    @property
    def thread_load(self) -> float:
        """Device-load proxy: step time / frame budget, in percent (the
        performance.ts ``delta/(1000/fps)`` idea, :24-26)."""
        budget_ms = 1000.0 / self.target_fps
        return 100.0 * self.total.mean / budget_ms if budget_ms else 0.0

    def snapshot(self) -> dict:
        return {
            "fps": round(self.fps, 1),
            "per_stream_fps": round(self.per_stream_fps, 1),
            "frames_total": self._frames,
            "streams": self._streams,
            "inference_ms_p50": round(self.inference.p50, 3),
            "inference_ms_p95": round(self.inference.p95, 3),
            "total_ms_p50": round(self.total.p50, 3),
            "total_ms_p95": round(self.total.p95, 3),
            "thread_load_pct": round(self.thread_load, 1),
        }
