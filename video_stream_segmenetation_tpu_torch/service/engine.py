"""Engine: the stateful multi-stream serving loop (port of
``service/engine.py::Engine``): the synchronous ``process``,
``process_range`` and ``process_group``, and the asynchronous
``dispatch``/``collect``, ``dispatch_range``/``collect_range`` and
``dispatch_round``/``collect_round`` that runtime/scheduler.py drives.

The engine owns S stream slots, batches their latest frames into one
``[S, H, W, 3]`` step on its device, and keeps all per-stream state (EMA
accumulator, affine, knobs, backgrounds) there.  With no statics it
serves the reference's default, ``PipelineStatics()`` (the ``active``
preset: the float MatteNet over resized natural-layout frames); the
s2d presets get their frames and backgrounds packed here.  Knob updates are
staged host-side and applied at the next step boundary, so a step sees one
consistent config.

The face path runs on a wall-clock gate as the reference's does: a
stream's face round may fire again only ``face_min_interval_s`` (0.180 s)
after its last applied one (set it to 0.0 to make steps depend on the
frames alone).  The synchronous paths keep that clock on the host; the
asynchronous ones keep a mirror of it on the device (seconds since the
engine's epoch, ``now`` in 25 ms buckets) and update it there from each
step's ``face_applied``, so a dispatch reads nothing back.

Frames come natural ``[S, H, W, 3]`` u8, packed ``[S, H/b, W/b, b*b*3]``
(s2d presets) or as a ``(packed, lanes)`` tuple (runtime/native.py::
FramePool with guide lanes); where the step takes host lanes
(``guide_source='host'``) and the caller passes plain frames, the lanes
are gathered on the device; where it does not, a tuple is refused.

Unlike the reference, a failed step raises (after recording the failure
in ``health``): there is no catch-all that serves passthrough frames, no
rollback and no snapshot recovery (ROADMAP Queue 1 item 4).

Each step (and each background resize) runs under
runtime/precision.py::pinned: TF32 and cuBLAS's bf16 split-K reductions
off, the caller's flags restored after, so what the engine serves does
not depend on the host process's global precision flags.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from video_stream_segmenetation_tpu_torch.models.backbones import freeze
from video_stream_segmenetation_tpu_torch.models.blazeface import (
    FaceFinder,
    init_face_finder_params,
)
from video_stream_segmenetation_tpu_torch.models.facemesh import (
    LandmarkNet,
    init_landmark_net_params,
)
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import init_params
from video_stream_segmenetation_tpu_torch.models.modnet import MatteNet, init_mattenet_params
from video_stream_segmenetation_tpu_torch.models.quantized import (
    QuantizedMatteNetHD,
    quantize_mattenet_hd,
)
from video_stream_segmenetation_tpu_torch.ops.composite import denormalize_to_u8
from video_stream_segmenetation_tpu_torch.ops.layout import (
    depth_to_space,
    guide_lanes_s2d,
    space_to_depth,
)
from video_stream_segmenetation_tpu_torch.ops.resize import interp_matrix
from video_stream_segmenetation_tpu_torch.runtime.config import (
    PipelineStatics,
    default_knobs,
)
from video_stream_segmenetation_tpu_torch.runtime.pipeline import (
    FaceModels,
    check_statics,
    fast_routing,
    make_range_step,
    make_round_step,
    make_step,
    rows_of,
    write_rows,
)
from video_stream_segmenetation_tpu_torch.runtime.precision import pinned
from video_stream_segmenetation_tpu_torch.runtime.state import (
    init_state,
    reset_stream,
    reset_streams,
)
from video_stream_segmenetation_tpu_torch.service.counters import Counters
from video_stream_segmenetation_tpu_torch.service.health import HealthMonitor


def resolve_device(device) -> torch.device:
    """``cuda`` (the default) must have a card; the CPU only on request."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch.cuda.is_available() is False; "
                           "pass device='cpu' to run the plain versions")
    return dev


class Engine:
    def __init__(self, num_streams: int, statics: PipelineStatics | None = None,
                 params: dict | None = None, seed: int = 0, device="cuda",
                 face_params: dict | None = None):
        """``statics``: None serves ``PipelineStatics()``, the reference's
        default (``active``).  ``params``: for the natural layout the float
        MatteNet tree (flax-shaped ``{"params", "batch_stats"}``, e.g.
        bridge.py::trained_weights), for the s2d layout the int8 serving
        dict of ``statics.matting_decoder``'s plan with
        ``statics.num_classes`` head classes (models/quantized.py
        ``quantize_mattenet_hd`` or bridge.py); None makes a float tree
        from ``seed`` (models/modnet.py, models/mattenet_hd.py; s2d: then
        quantized).  ``face_params``: ``{"face": FaceFinder tree, "lmk":
        LandmarkNet tree}`` (flax-shaped float trees, e.g.
        bridge.py::trained_weights); None makes both from ``seed``."""
        self.device = resolve_device(device)
        self.num_streams = num_streams
        self.statics = statics or PipelineStatics()
        check_statics(self.statics)
        st = self.statics
        fh, fw = st.frame_hw
        mh, mw = st.mask_hw
        self.packed = st.frame_layout == "s2d"
        if self.packed:
            self.model = self._int8_model(params, seed)
            blk = st.s2d_block
            bg_shape = (num_streams, fh // blk, fw // blk, blk * blk * 3)
        else:
            if mh % 16 or mw % 16:
                raise ValueError(f"mask_hw {st.mask_hw}: MatteNet needs multiples of 16")
            self.model = MatteNet(init_mattenet_params(seed) if params is None else params,
                                  device=self.device)
            bg_shape = (num_streams, fh, fw, 3)
        self.face_models = None
        if st.face_path:
            if face_params is None:
                face_params = {"face": init_face_finder_params(seed + 1),
                               "lmk": init_landmark_net_params(seed + 2)}
            self.face_models = FaceModels(
                face=FaceFinder(face_params["face"], st.fd_size, device=self.device),
                lmk=LandmarkNet(face_params["lmk"], device=self.device))
        # served models are frozen (not inference_mode, whose tensors refuse
        # the rounds' in-place row writes)
        for m in (self.model, *((self.face_models.face, self.face_models.lmk)
                                if self.face_models else ())):
            freeze(m)
        self._step = make_step(self.model, st, self.face_models)
        self._range_step = make_range_step(self.model, st, self.face_models)
        self._round_steps: dict = {}
        # the fast refine's routing; host_lanes: the step takes (packed, lanes)
        self.routing = fast_routing(self.model, st)
        self.host_lanes = self.routing["host_lanes"]
        self.state = init_state(num_streams, (mh, mw), device=self.device,
                                num_classes=st.num_classes)
        self.knobs = default_knobs(num_streams, ema_adapt=st.ema_adapt_default,
                                   device=self.device)
        # backgrounds are kept u8 in the frames' layout (s2d: packed, ready
        # for the packed composite)
        self.backgrounds = torch.zeros(bg_shape, dtype=torch.uint8, device=self.device)
        self.active = np.zeros((num_streams,), bool)
        # host clock of each stream's last applied face round (L_MIN_MS)
        self._last_face_at = np.zeros((num_streams,), np.float64)
        self.face_min_interval_s = 0.180
        # the asynchronous paths' device mirror of _last_face_at (seconds
        # since _face_epoch, -1e9 = never), built at their first dispatch
        self._face_epoch = time.monotonic()
        self._face_last_dev = None
        self._now_bucket = None
        self._now_dev = None
        self._mi_cache = None
        self.counters = Counters()
        self.health = HealthMonitor()
        self._lock = threading.Lock()
        self._staged_knobs: dict[int, dict] = {}

    def _int8_model(self, params, seed) -> QuantizedMatteNetHD:
        st = self.statics
        fh, fw = st.frame_hw
        mh, mw = st.mask_hw
        blk = st.s2d_block
        if fh % blk or fw % blk:
            raise ValueError(f"frame_hw {st.frame_hw} not divisible by s2d_block {blk}")
        hp, wp = fh // blk, fw // blk
        if mh % hp or mw % wp or mh // hp != mw // wp:
            raise ValueError(f"mask_hw {st.mask_hw} must be one integer multiple "
                             f"of the stem grid {(hp, wp)}")
        if params is None:
            params = quantize_mattenet_hd(
                init_params(st.matting_decoder, seed, blk, st.num_classes), blk,
                st.matting_decoder)
        # the head grid is the stem grid; mask_hw = uf x that (uf = 1: the
        # class maps are served at the head grid, as multiclass_fast_pico)
        model = QuantizedMatteNetHD(params, blk, mh // hp, device=self.device,
                                    conv_impl=st.int8_conv_impl,
                                    head_impl=st.int8_head_impl)
        if model.decoder != st.matting_decoder:
            raise ValueError(f"params are the {model.decoder} plan's; statics ask "
                             f"for matting_decoder={st.matting_decoder!r}")
        if model.num_classes != st.num_classes:
            raise ValueError(f"params have {model.num_classes} classes; statics ask "
                             f"for num_classes={st.num_classes}")
        return model

    # ---- stream admission ---------------------------------------------
    def admit(self) -> int:
        """Take a free slot; cold-start its state.  Returns the slot id."""
        with self._lock:
            free = np.flatnonzero(~self.active)
            if free.size == 0:
                raise RuntimeError("engine full: no free stream slots")
            s = int(free[0])
            self.active[s] = True
        reset_stream(self.state, s)
        self._last_face_at[s] = 0.0
        if self._face_last_dev is not None:
            self._face_last_dev[s] = -1e9
        return s

    def admit_all(self) -> list[int]:
        """Activate every free slot at once, with one state reset."""
        with self._lock:
            free = np.flatnonzero(~self.active)
            self.active[:] = True
        if free.size:
            mask = np.zeros((self.num_streams,), bool)
            mask[free] = True
            mask_t = torch.as_tensor(mask, device=self.device)
            reset_streams(self.state, mask_t)
            self._last_face_at[free] = 0.0
            if self._face_last_dev is not None:
                self._face_last_dev.copy_(torch.where(mask_t, -1e9, self._face_last_dev))
        return [int(s) for s in free]

    def evict(self, slot: int) -> None:
        with self._lock:
            self.active[slot] = False
        reset_stream(self.state, slot)
        if self._face_last_dev is not None:
            self._face_last_dev[slot] = -1e9

    # ---- live config --------------------------------------------------
    def set_knobs(self, slot: int, **kw) -> None:
        """Stage per-stream knob updates; applied at the next step."""
        with self._lock:
            self._staged_knobs.setdefault(slot, {}).update(kw)

    def set_background(self, slot: int, image) -> None:
        """Set a stream's background (u8 or float 0..1 RGB ``[h, w, 3]``;
        resized half-pixel bilinear to the frame), packed once here for the
        s2d layout."""
        img = torch.as_tensor(np.asarray(image), device=self.device)
        if img.dtype == torch.uint8:
            img = img.to(torch.float32) / 255.0
        img = img.to(torch.float32)
        fh, fw = self.statics.frame_hw
        if tuple(img.shape[:2]) != (fh, fw):
            a_h = interp_matrix(fh, img.shape[0], "half_pixel", device=self.device)
            a_w = interp_matrix(fw, img.shape[1], "half_pixel", device=self.device)
            with pinned():
                img = torch.einsum("oh,hwc->owc", a_h, img)
                img = torch.einsum("pw,hwc->hpc", a_w, img)
        img_u8 = denormalize_to_u8(img)
        if self.packed:
            img_u8 = space_to_depth(img_u8, self.statics.s2d_block)
        self.backgrounds[slot] = img_u8

    def _apply_staged(self):
        with self._lock:
            staged, self._staged_knobs = self._staged_knobs, {}
        for slot, kw in staged.items():
            self.knobs.replace_stream(slot, **kw)

    # ---- ingest --------------------------------------------------------
    def _to_device(self, x) -> torch.Tensor:
        """u8 frames (numpy, possibly a view into a FramePool ring, or a
        tensor) on the engine's device.  A host array goes over with a
        non-blocking copy: from pageable memory the copy has taken the
        bytes when it returns, so the ring buffer may be refilled."""
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x, dtype=np.uint8))
        if x.dtype != torch.uint8:
            raise ValueError(f"frames must be u8, got {x.dtype}")
        return x.to(self.device, non_blocking=True)

    def _ingest(self, frames, rows: int | None = None):
        """Normalise step input for ``rows`` streams (all by default), on
        the device: what the step takes -- packed frames for the s2d layout
        and, where the step takes host lanes, a ``(packed, lanes)`` tuple
        (the caller's lanes, or gathered here from the packed frames).  A
        tuple is refused where the step takes no host lanes."""
        rows = self.num_streams if rows is None else rows
        st = self.statics
        fh, fw = st.frame_hw
        blk = st.s2d_block
        natural = (rows, fh, fw, 3)
        packed = (rows, fh // blk, fw // blk, blk * blk * 3) if self.packed else None
        if isinstance(frames, tuple):
            if not self.host_lanes:
                raise ValueError("(packed, lanes) input needs guide_source='host' on a route "
                                 "that takes the lanes (engine.host_lanes)")
            fp, lanes = (self._to_device(x) for x in frames)
            if tuple(fp.shape) != packed:
                raise ValueError(f"(packed, lanes) input: packed frames must be u8 {packed}, "
                                 f"got {tuple(fp.shape)}")
            return fp, lanes.contiguous()
        fin = self._to_device(frames)
        if tuple(fin.shape) not in (natural, packed):
            raise ValueError(f"frames must be u8 {natural}" + (f" or packed {packed}" if packed
                                                               else "")
                             + f", got {tuple(fin.shape)}")
        fj = fin
        if self.packed and tuple(fin.shape) == natural:
            fj = space_to_depth(fin, blk).contiguous()
        if self.host_lanes:
            return fj, guide_lanes_s2d(fj, (fh, fw), st.mask_hw, blk)[0]
        return fj

    def _unpack(self, frame: torch.Tensor) -> torch.Tensor:
        return depth_to_space(frame, self.statics.s2d_block) if self.packed else frame

    def _run(self, fn, *args):
        """``fn(*args)`` under the pinned precision; a failure is recorded
        in ``health`` and raised."""
        try:
            with pinned():
                return fn(*args)
        except BaseException as e:
            self.health.record_failure(e)
            raise

    def _done_event(self):
        """An event after what has been enqueued so far (None on the CPU,
        where the step has already run)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _wait(self, token: dict) -> None:
        """Wait for a dispatched step; a failure on the device is recorded
        and raised."""
        try:
            if token.get("done") is not None:
                token["done"].synchronize()
        except BaseException as e:
            self.health.record_failure(e)
            raise
        self.health.record_success()

    @staticmethod
    def _extras(out: dict) -> dict:
        return {k: v for k, v in out.items() if k not in ("frame", "alpha")}

    # ---- the asynchronous paths' face clock (no host sync) ---------------
    def _face_mirror(self) -> torch.Tensor:
        """The device mirror of the host face clock, built at first use
        (seconds since the engine's epoch; never -> -1e9)."""
        if self._face_last_dev is None:
            host = self._last_face_at
            base = np.where(host > 0, host - self._face_epoch, -1e9).astype(np.float32)
            self._face_last_dev = torch.as_tensor(base, device=self.device)
        return self._face_last_dev

    def _now_device(self, now: float) -> torch.Tensor:
        """``now - epoch`` as a device scalar, in 25 ms buckets (made by a
        fill on the device, not copied from the host)."""
        q = int((now - self._face_epoch) * 40.0)
        if self._now_bucket != q:
            self._now_bucket = q
            self._now_dev = torch.full((), q / 40.0, dtype=torch.float32, device=self.device)
        return self._now_dev

    def _min_interval_device(self) -> torch.Tensor:
        mi = float(self.face_min_interval_s)
        if self._mi_cache is None or self._mi_cache[0] != mi:
            self._mi_cache = (mi, torch.full((), mi, dtype=torch.float32, device=self.device))
        return self._mi_cache[1]

    def _face_gate_async(self, i0: int, gs: int, now: float) -> torch.Tensor:
        """The min-interval gate of rows ``[i0, i0+gs)``, on the device."""
        return (self._now_device(now) - self._face_mirror()[i0:i0 + gs]) \
            >= self._min_interval_device()

    def _face_applied_async(self, i0: int, applied: torch.Tensor, now: float) -> None:
        """Fold a step's ``face_applied`` into the device mirror in place."""
        cur = self._face_mirror()[i0:i0 + applied.shape[0]]
        cur.copy_(torch.where(applied, self._now_device(now), cur))

    # ---- the serving step ---------------------------------------------
    def process(self, frames) -> dict:
        """One batch step: frames u8 ``[S, H, W, 3]``, packed, or a
        ``(packed, lanes)`` tuple (rows of inactive slots are processed too
        and ignored).  Returns ``frame`` (composited u8 ``[S, H, W, 3]``),
        ``alpha`` (``[S, mh, mw]``, bf16 or f32 by ``refined_dtype``),
        ``metrics`` and the step's face outputs (``face_applied``,
        ``det_score``, ``face_has_prior``; and ``face_prior_params`` where
        the prior rides as scalars), as tensors on the engine's device.
        With K > 1 classes: ``alpha`` is class 1's map (f32),
        ``class_alpha`` the smoothed class maps ``[S, mh, mw, K]``, and
        ``det_score`` and ``face_applied`` are zeros."""
        t0 = time.perf_counter()
        self._apply_staged()
        now = time.monotonic()
        gate = torch.as_tensor((now - self._last_face_at) >= self.face_min_interval_s,
                               device=self.device)
        fj = self._ingest(frames)
        t1 = time.perf_counter()
        new_state, out = self._run(self._step, self.state, fj, self.backgrounds, self.knobs,
                                   gate)
        self._wait({"done": self._done_event()})
        self.state = new_state
        self._last_face_at[out["face_applied"].cpu().numpy()] = now
        t2 = time.perf_counter()
        n_active = int(self.active.sum()) or self.num_streams
        self.counters.record_step(n_active, (t2 - t1) * 1e3, (t2 - t0) * 1e3)
        return {"frame": self._unpack(out["frame"]), "alpha": out["alpha"],
                "metrics": self.stats(), **self._extras(out)}

    def process_group(self, group: int, num_groups: int, frames) -> dict:
        """Step only stream group ``group`` (rows ``[g*S/G, (g+1)*S/G)``) of
        ``num_groups``, leaving the other groups' state untouched;
        ``frames``: the group's frames only."""
        if self.num_streams % num_groups:
            raise ValueError("num_groups must divide num_streams")
        gs = self.num_streams // num_groups
        return self.process_range(group * gs, (group + 1) * gs, frames)

    def process_range(self, i0: int, i1: int, frames) -> dict:
        """Step stream rows ``[i0, i1)`` synchronously (their frames only),
        leaving the other rows' state untouched; the group's new rows are
        written back in place.  Returns :meth:`process`'s keys and
        ``slots``."""
        gs = i1 - i0
        t0 = time.perf_counter()
        self._apply_staged()
        now = time.monotonic()
        gate = torch.as_tensor(
            (now - self._last_face_at[i0:i1]) >= self.face_min_interval_s, device=self.device)
        fj = self._ingest(frames, rows=gs)
        rows = slice(i0, i1)
        gstate = rows_of(self.state, rows)
        bgs = self.backgrounds if self.backgrounds.shape[0] == 1 else self.backgrounds[rows]
        t1 = time.perf_counter()
        new_g, out = self._run(self._step, gstate, fj, bgs, rows_of(self.knobs, rows), gate)
        write_rows(gstate, new_g)
        self._wait({"done": self._done_event()})
        applied = np.zeros((self.num_streams,), bool)
        applied[i0:i1] = out["face_applied"].cpu().numpy()
        self._last_face_at[applied] = now
        t2 = time.perf_counter()
        self.counters.record_step(gs, (t2 - t1) * 1e3, (t2 - t0) * 1e3)
        return {"frame": self._unpack(out["frame"]), "alpha": out["alpha"], "slots": (i0, i1),
                "metrics": self.stats(), **self._extras(out)}

    # ---- pipelined serving: dispatch now, collect later -------------------
    def dispatch(self, frames) -> dict:
        """Launch one full-batch step without waiting for the card; the
        state advances to the step's (still computing) new state, the face
        gate and its update stay on the device.  Pair with :meth:`collect`;
        returns its token."""
        t0 = time.perf_counter()
        self._apply_staged()
        now = time.monotonic()
        gate = self._face_gate_async(0, self.num_streams, now)
        fj = self._ingest(frames)
        t1 = time.perf_counter()
        new_state, out = self._run(self._step, self.state, fj, self.backgrounds, self.knobs,
                                   gate)
        self.state = new_state
        self._face_applied_async(0, out["face_applied"], now)
        return {"t0": t0, "t1": t1, "now": now, "out": out, "done": self._done_event()}

    def collect(self, token: dict) -> dict:
        """Wait for a :meth:`dispatch` and return :meth:`process`'s dict
        (tokens of :meth:`dispatch_range` go to :meth:`collect_range`)."""
        if "slots" in token:
            return self.collect_range(token)
        self._wait(token)
        out = token["out"]
        t2 = time.perf_counter()
        n_active = int(self.active.sum()) or self.num_streams
        self.counters.record_step(n_active, (t2 - token["t1"]) * 1e3,
                                  (t2 - token["t0"]) * 1e3)
        return {"frame": self._unpack(out["frame"]), "alpha": out["alpha"],
                "metrics": self.stats(), **self._extras(out)}

    def dispatch_range(self, i0: int, i1: int, frames) -> dict:
        """Launch the group step of rows ``[i0, i1)`` without waiting
        (runtime/pipeline.py::make_range_step: slice, step, write back in
        place, the face gate on the device).  Pair with
        :meth:`collect_range`."""
        t0 = time.perf_counter()
        self._apply_staged()
        now = time.monotonic()
        fj = self._ingest(frames, rows=i1 - i0)
        t1 = time.perf_counter()
        _, _, out = self._run(self._range_step, self.state, i0, fj, self.backgrounds,
                              self.knobs, self._face_mirror(), self._now_device(now),
                              self._min_interval_device(), i1 - i0)
        return {"t0": t0, "t1": t1, "now": now, "slots": (i0, i1), "out": out,
                "done": self._done_event()}

    def collect_range(self, token: dict) -> dict:
        """Wait for a :meth:`dispatch_range`; returns its group's results
        (:meth:`process_range`'s keys)."""
        self._wait(token)
        i0, i1 = token["slots"]
        out = token["out"]
        t2 = time.perf_counter()
        self.counters.record_step(i1 - i0, (t2 - token["t1"]) * 1e3, (t2 - token["t0"]) * 1e3)
        return {"frame": self._unpack(out["frame"]), "alpha": out["alpha"], "slots": (i0, i1),
                "metrics": self.stats(), **self._extras(out)}

    def _round_step_for(self, group_sizes):
        key = tuple(int(g) for g in group_sizes)
        rs = self._round_steps.get(key)
        if rs is None:
            if sum(key) != self.num_streams:
                raise ValueError(f"group_sizes {key} do not sum to {self.num_streams}")
            rs = make_round_step(self.model, self.statics, list(key), self.face_models)
            self._round_steps[key] = rs
        return rs

    def round_step(self, group_sizes, step_frames, now: float) -> list[dict]:
        """The round itself, after ingest: every group's range step over
        the full state in order, the face clock on the device.  It makes
        no host synchronisation once the face clock's mirror exists (the
        first dispatch builds it).  Returns each group's step outputs."""
        rs = self._round_step_for(group_sizes)
        _, _, outs = self._run(rs, self.state, step_frames, self.backgrounds, self.knobs,
                               self._face_mirror(), self._now_device(now),
                               self._min_interval_device())
        return outs

    def dispatch_round(self, group_sizes, frames_list) -> dict:
        """Launch one whole rotation round (every group stepped once) without
        waiting: the groups' frames are ingested, then :meth:`round_step`.
        Knobs and the face clock advance once a round.  Pair with
        :meth:`collect_round`."""
        t0 = time.perf_counter()
        self._apply_staged()
        now = time.monotonic()
        sizes = [int(g) for g in group_sizes]
        step_frames = [self._ingest(f, rows=g) for f, g in zip(frames_list, sizes)]
        t1 = time.perf_counter()
        outs = self.round_step(sizes, step_frames, now)
        return {"t0": t0, "t1": t1, "now": now, "round": True, "group_sizes": sizes,
                "outs": outs, "done": self._done_event()}

    def collect_round(self, token: dict) -> list[dict]:
        """Wait for a :meth:`dispatch_round`; returns one result dict a group
        (:meth:`collect_range`'s keys)."""
        self._wait(token)
        sizes = token["group_sizes"]
        t2 = time.perf_counter()
        self.counters.record_step(sum(sizes), (t2 - token["t1"]) * 1e3,
                                  (t2 - token["t0"]) * 1e3)
        stats = self.stats()
        results, i0 = [], 0
        for gs, out in zip(sizes, token["outs"]):
            results.append({"frame": self._unpack(out["frame"]), "alpha": out["alpha"],
                            "slots": (i0, i0 + gs), "metrics": stats, **self._extras(out)})
            i0 += gs
        return results

    def stats(self) -> dict:
        """FPS / latency / thread-load counters + health."""
        return {**self.counters.snapshot(), "health": self.health.snapshot()}
