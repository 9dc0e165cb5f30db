"""The host side of the serving loop (port of ``runtime/scheduler.py``).

* Frames arrive per stream, into the native FramePool's rings
  (runtime/native.py) or, where the pool could not be built, a host array
  (then ``sched.pool is None``, ``sched.pool_error`` holds the reason and
  it is logged), and are batched at a fixed tick.
* The face models' cadence is staggered: stream s starts at frame phase
  ``s % lmk_interval``, so a step fires the face path on about
  S / interval streams instead of all of them at once.
* ``groups`` / ``group_sizes`` serve the streams as a rotation of groups;
  ``fused_rounds`` dispatches each whole round at once
  (Engine.dispatch_round) and collects it a round later; the per-group
  ``step_pipelined`` keeps one group step in flight.
* With host guide lanes (the engine's step takes ``(packed, lanes)``) the
  pool emits the guide's tap lanes while it packs.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable

import numpy as np

from video_stream_segmenetation_tpu_torch.ops.layout import guide_s2d_sel
from video_stream_segmenetation_tpu_torch.runtime.native import FramePool

log = logging.getLogger("vst.scheduler")


class StreamScheduler:
    def __init__(self, engine, use_native_pool: bool = True, tick_hz: float = 30.0,
                 groups: int = 1, group_sizes=None,
                 frame_source: Callable[[int, int], object] | None = None,
                 fused_rounds: bool = False):
        """``groups > 1``: each tick serves one group of S/groups streams,
        round-robin.  ``group_sizes``: explicit per-group stream counts
        (summing to the engine's streams; overrides ``groups``), e.g.
        [96, 96, 96, 96, 16] for 400 streams.  ``frame_source``: an
        ``(i0, i1) -> frames`` callback in place of the pool (frames already
        on the device), fed to the engine as it is.  ``fused_rounds``: one
        dispatch a whole round (:meth:`step_round`); the pool's ring is
        then ``2 * groups`` deep, so every group's view of a round survives
        until the round is collected, a round later."""
        self.engine = engine
        self.frame_source = frame_source
        n = engine.num_streams
        if group_sizes is not None:
            if any(g <= 0 for g in group_sizes):
                raise ValueError("group_sizes must be positive")
            if sum(group_sizes) != n:
                raise ValueError(f"group_sizes sum {sum(group_sizes)} != num_streams {n}")
            groups = len(group_sizes)
            offs = [0]
            for g in group_sizes:
                offs.append(offs[-1] + int(g))
        else:
            if n % groups:
                raise ValueError("groups must divide num_streams")
            offs = [i * (n // groups) for i in range(groups + 1)]
        self.groups = groups
        self.group_offsets = offs
        self.fused_rounds = fused_rounds
        self.tick_s = 1.0 / (tick_hz * groups)
        st = engine.statics
        fh, fw = st.frame_hw
        self.pool = None
        self.pool_error: Exception | None = None
        if use_native_pool:
            try:
                blk = st.s2d_block if st.frame_layout == "s2d" else 0
                sel = (guide_s2d_sel((fh, fw), st.mask_hw, blk)
                       if blk and engine.host_lanes else None)
                self.pool = FramePool(n, fh, fw, s2d_block=blk, guide_lanes=sel,
                                      depth=2 * groups if fused_rounds else 2)
            except Exception as e:  # the host-array fallback; sched.pool says so
                self.pool_error = e
                log.warning("native FramePool unavailable, frames staged in a host "
                            "array: %s", e)
        self._frames = np.zeros((n, fh, fw, 3), np.uint8)
        self._running = False
        self._thread: threading.Thread | None = None
        self.on_batch: Callable[[dict, object], None] | None = None
        self.ticks = 0
        self._inflight: dict | None = None

    # ---- stream lifecycle with staggered cadence -----------------------
    def admit(self) -> int:
        """Admit one stream; its cadence phase is ``slot % lmk_interval``."""
        slot = self.engine.admit()
        self.engine.set_cadence_phases([slot], [slot % self.engine.statics.lmk_interval])
        return slot

    def admit_all(self) -> list[int]:
        """Admit every free slot, each at phase ``slot % lmk_interval``."""
        slots = self.engine.admit_all()
        if slots:
            self.engine.set_cadence_phases(
                slots, np.asarray(slots) % self.engine.statics.lmk_interval)
        return slots

    def evict(self, slot: int) -> None:
        self.engine.evict(slot)

    # ---- frame ingestion -------------------------------------------------
    def push_frame(self, slot: int, frame: np.ndarray) -> None:
        if self.pool is not None:
            self.pool.push_rgb(slot, frame)
        else:
            self._frames[slot] = frame

    def push_i420(self, slot: int, y, u, v) -> None:
        if self.pool is None:
            raise RuntimeError("native pool unavailable")
        self.pool.push_i420(slot, y, u, v)

    # ---- the tick ----------------------------------------------------------
    def _group_frames(self, i0: int, i1: int, copy: bool = False):
        """One group's frames and their capture ids: the ``frame_source``,
        else a ranged pool assemble (with its lanes), else the host array
        (copied with ``copy``, so that the next pushes cannot change a step
        in flight)."""
        if self.frame_source is not None:
            return self.frame_source(i0, i1), None
        if self.pool is not None:
            batch, ids = self.pool.assemble_range(i0, i1)
            if self.pool.num_lanes:
                batch = (batch, self.pool.lanes())
            return batch, ids
        gb = self._frames[i0:i1]
        return (gb.copy() if copy else gb), None

    def _full_frames(self):
        if self.frame_source is not None:
            return self._group_frames(0, self.engine.num_streams)
        if self.pool is not None:
            batch, ids = self.pool.assemble()
            if self.pool.num_lanes:
                batch = (batch, self.pool.lanes())
            return batch, ids
        return self._frames.copy(), None

    def step(self) -> dict:
        """Assemble the freshest frames and run one synchronous step (with
        ``groups > 1`` only this tick's group; the result carries
        ``slots``)."""
        if self.groups > 1:
            g = self.ticks % self.groups
            i0, i1 = self.group_offsets[g], self.group_offsets[g + 1]
            batch, ids = self._group_frames(i0, i1)
            out = self.engine.process_range(i0, i1, batch)
        else:
            batch, ids = self._full_frames()
            out = self.engine.process(batch)
        self.ticks += 1
        if self.on_batch is not None:
            self.on_batch(out, ids)
        return out

    def step_pipelined(self) -> dict | None:
        """Dispatch this tick's batch (one group with ``groups > 1``), then
        collect the previous tick's; returns the previous results (None on
        the first tick)."""
        if self.groups > 1:
            g = self.ticks % self.groups
            i0, i1 = self.group_offsets[g], self.group_offsets[g + 1]
            batch, ids = self._group_frames(i0, i1, copy=True)
            token = self.engine.dispatch_range(i0, i1, batch)
        else:
            batch, ids = self._full_frames()
            token = self.engine.dispatch(batch)
        token["ids"] = ids
        prev, self._inflight = self._inflight, token
        self.ticks += 1
        if prev is None:
            return None
        out = self.engine.collect(prev)
        if self.on_batch is not None:
            self.on_batch(out, prev.get("ids"))
        return out

    def step_round(self) -> list[dict] | None:
        """Assemble every group's frames, dispatch the whole round at once
        (Engine.dispatch_round), then collect the previous round's per-group
        results (None on the first round)."""
        frames_list, ids_list, sizes = [], [], []
        for g in range(self.groups):
            i0, i1 = self.group_offsets[g], self.group_offsets[g + 1]
            fb, ids = self._group_frames(i0, i1, copy=True)
            frames_list.append(fb)
            ids_list.append(ids)
            sizes.append(i1 - i0)
        token = self.engine.dispatch_round(sizes, frames_list)
        token["ids"] = ids_list
        prev, self._inflight = self._inflight, token
        self.ticks += self.groups
        if prev is None:
            return None
        return self._collect_round(prev)

    def _collect_round(self, token: dict) -> list[dict]:
        outs = self.engine.collect_round(token)
        if self.on_batch is not None:
            for r, ids in zip(outs, token.get("ids") or [None] * len(outs)):
                self.on_batch(r, ids)
        return outs

    def drain(self):
        """Collect the step or round in flight, if any: its result dict,
        or a round's list of per-group dicts."""
        token, self._inflight = self._inflight, None
        if token is None:
            return None
        if token.get("round"):
            return self._collect_round(token)
        out = self.engine.collect(token)
        if self.on_batch is not None:
            self.on_batch(out, token.get("ids"))
        return out

    def run_forever(self) -> None:
        """Pipelined ticks, paced a round at a time: the groups run back to
        back and the loop sleeps only to start rounds ``1/tick_hz`` apart."""
        self._running = True
        round_s = self.tick_s * self.groups
        next_round = time.monotonic()
        while self._running:
            if self.fused_rounds:
                self.step_round()
            else:
                for _ in range(self.groups):
                    if not self._running:
                        break
                    self.step_pipelined()
            next_round += round_s
            delay = next_round - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            else:
                next_round = time.monotonic()  # behind: do not spiral
        self.drain()

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self.pool is not None:
            self.pool.close()
