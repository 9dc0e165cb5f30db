"""Engine: the stateful multi-stream serving loop (port of
``service/engine.py::Engine``): the synchronous ``process``,
``process_range``, ``process_group`` and ``process_chunked``, and the
asynchronous ``dispatch``/``collect``, ``dispatch_range``/``collect_range``
and ``dispatch_round``/``collect_round`` that runtime/scheduler.py drives.

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

Failures degrade, as the reference's do (service/health.py): a failed step
is recorded in ``health`` and served as passthrough -- the caller's input
frames in the layout it passed, alpha f32 ones ``[rows, mh, mw]``, no face
applied -- and after three failures in a row the engine is DEGRADED and
serves passthrough without running the step, probing the real step every
``health.recovery_probe_s`` seconds.  Every result carries
``passthrough``; ``stats()['passthrough_steps']`` counts them.  State after
a failure:

* ``process``, ``process_chunked``, ``process_range`` and ``dispatch``
  build the new state (or rows) beside the old and keep it only once the
  step succeeded, so a failure leaves the state as it was (``dispatch``
  rolls back to the token's ``prev_state`` when ``collect`` finds the
  failure);
* the range and round steps write the groups' rows back in place as they
  go, so a failure can leave the state partly written: the state is then
  restored from the last recovery snapshot (:meth:`_recover_state`): the
  cheap per-stream fields (``affine``, ``has_affine``, ``frame_idx``,
  ``face_center``, ``has_center``) over a cold EMA and a zeroed model
  state, or the full state with ``state_snapshot_every``.  A snapshot is
  taken at dispatch time every ``snapshot_every`` dispatches as a
  device copy with a non-blocking copy into pinned host memory, so the
  rotation makes no host synchronisation for it; the copy is read only
  when a recovery needs it.

What recovers is a failure that leaves the CUDA context sound: an
exception raised on the host side of a step, an out-of-memory, a launch
that a kernel's C entry point refuses (kernels/_build.py::check).  A fault
inside a kernel (an illegal address, a device-side assert) leaves the
context unusable for the rest of the process, and no in-process recovery
exists for it: the steps after it fail as well, and the process must be
restarted.

Each step (and each background resize) runs under
runtime/precision.py::pinned: TF32 and cuBLAS's bf16 split-K reductions
off, the caller's flags restored after, so what the engine serves does
not depend on the host process's global precision flags.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from video_stream_segmenetation_tpu_torch.bridge import load_export
from video_stream_segmenetation_tpu_torch.models.backbones import freeze
from video_stream_segmenetation_tpu_torch.models.blazeface import (
    FaceFinder,
    init_face_finder_params,
)
from video_stream_segmenetation_tpu_torch.models.facemesh import (
    LandmarkNet,
    init_landmark_net_params,
)
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import MatteNetHD, init_params
from video_stream_segmenetation_tpu_torch.models.modnet import MatteNet, init_mattenet_params
from video_stream_segmenetation_tpu_torch.models.quantized import (
    QuantizedMatteNetHD,
    quantize_mattenet_hd,
)
from video_stream_segmenetation_tpu_torch.models.rvm import (
    RecurrentMatteNet,
    init_rvm_params,
)
from video_stream_segmenetation_tpu_torch.models.rvm import init_state as rvm_init_state
from video_stream_segmenetation_tpu_torch.models.u2net import SaliencyNet, init_u2net_params
from video_stream_segmenetation_tpu_torch.ops.color import denormalize_to_u8
from video_stream_segmenetation_tpu_torch.ops.layout import (
    depth_to_space,
    guide_lanes_s2d,
    space_to_depth,
)
from video_stream_segmenetation_tpu_torch.ops.resize import interp_matrix
from video_stream_segmenetation_tpu_torch.runtime import config as cfg
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
    StreamState,
    init_state,
    map_state,
    reset_stream,
    reset_streams,
    state_tensors,
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


def _cat_rows(parts: list):
    """Concatenate on the stream axis a list of StreamStates, or of output
    dicts, of consecutive row chunks."""
    if isinstance(parts[0], StreamState):
        return map_state(lambda *ts: torch.cat(ts), *parts)
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


class Engine:
    # the recovery snapshot's cheap per-stream fields
    _CHEAP_FIELDS = ("affine", "has_affine", "frame_idx", "face_center", "has_center")

    def __init__(self, num_streams: int, statics: PipelineStatics | None = None,
                 params: dict | None = None, seed: int = 0, device="cuda",
                 face_params: dict | None = None, output_layout: str = "natural",
                 collect_sync: bool = True):
        """``statics``: None serves ``PipelineStatics()``, the reference's
        default (``active``).  ``params``: for the natural layout the float
        tree of ``statics.matting_arch``'s model (flax-shaped ``{"params",
        "batch_stats"}``, e.g. bridge.py::trained_weights: MatteNet (K
        class heads with ``num_classes``), RecurrentMatteNet, SaliencyNet,
        or the plan-A MatteNetHD with ``matting_input='native'``), for the
        s2d layout the int8 serving
        dict of ``statics.matting_decoder``'s plan with
        ``statics.num_classes`` head classes (models/quantized.py
        ``quantize_mattenet_hd`` or bridge.py); None makes a float tree
        from ``seed`` (models/modnet.py, rvm.py, u2net.py,
        models/mattenet_hd.py; s2d: then quantized).  ``face_params``:
        ``{"face": FaceFinder tree, "lmk": LandmarkNet tree}`` (flax-shaped
        float trees, e.g.
        bridge.py::trained_weights); None makes both from ``seed``.
        :meth:`load_matting_params` and :meth:`load_face_params` replace
        them from ``.npz`` exports.

        ``output_layout``: ``'natural'`` serves the s2d presets' composited
        frames as ``[S, H, W, 3]``; ``'packed'`` serves them as the step
        makes them, ``[S, H/b, W/b, b*b*3]`` (no depth_to_space on the
        card; the consumer unpacks).  ``collect_sync``: True makes
        ``collect*`` wait for the step; False returns its outputs as
        tensors still being computed (a failure on the card then surfaces
        at the next wait: a later collect, or the consumer's read)."""
        if output_layout not in ("natural", "packed"):
            raise ValueError(f"unknown output_layout {output_layout!r}")
        self.device = resolve_device(device)
        self.num_streams = num_streams
        self.statics = statics or PipelineStatics()
        check_statics(self.statics)
        st = self.statics
        fh, fw = st.frame_hw
        mh, mw = st.mask_hw
        self.seed = seed
        self.packed = st.frame_layout == "s2d"
        self.output_layout = output_layout
        self.collect_sync = collect_sync
        if self.packed:
            blk = st.s2d_block
            bg_shape = (num_streams, fh // blk, fw // blk, blk * blk * 3)
        else:
            if (st.matting_arch == "feedforward" and st.matting_input == "resized"
                    and (mh % 16 or mw % 16)):
                raise ValueError(f"mask_hw {st.mask_hw}: MatteNet needs multiples of 16")
            bg_shape = (num_streams, fh, fw, 3)
        self.model = self._matting_model(params)
        self._face_params = face_params
        self.face_models = self._build_face_models()
        self._build_steps()
        self.state = init_state(num_streams, (mh, mw), device=self.device,
                                rec=self._zero_rec())
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
        # recovery snapshots (module docstring): taken at every
        # snapshot_every-th dispatch; the full state too at every
        # state_snapshot_every-th (0: never)
        self.snapshot_every = 8
        self.state_snapshot_every = 0
        self._dispatches = 0
        self._snap: dict | None = None
        self._snap_pending: dict | None = None
        self._cheap_spec = None
        self.counters = Counters()
        self.health = HealthMonitor()
        self.passthrough_steps = 0
        self._lock = threading.Lock()
        self._staged_knobs: dict[int, dict] = {}

    # ---- models ---------------------------------------------------------
    def _zero_rec(self) -> tuple:
        """The model's cold per-stream state (the reference's
        service/engine.py:145-156): the RecurrentMatteNet's r1..r4, the
        multi-class smoothed class maps, or nothing."""
        st = self.statics
        if st.matting_arch == "recurrent":
            return rvm_init_state(self.num_streams, st.mask_hw, device=self.device)
        if st.num_classes > 1:
            return (torch.zeros((self.num_streams, *st.mask_hw, st.num_classes),
                                dtype=torch.float32, device=self.device),)
        return ()

    def _matting_model(self, params) -> torch.nn.Module:
        """The matting model by ``statics.matting_arch`` (the reference's
        service/engine.py:347-391): the int8 MatteNetHD for the s2d
        layout, else the K-class MatteNet (natural, ``num_classes > 1``),
        the RecurrentMatteNet, the SaliencyNet, the float plan-A MatteNetHD
        (``matting_input='native'``) or the float MatteNet, each from
        ``params`` or a tree drawn from the seed."""
        st = self.statics
        arch = st.matting_arch
        if self.packed:
            model = self._int8_model(params)
        elif st.num_classes > 1:
            model = MatteNet(init_mattenet_params(self.seed, st.num_classes) if params is None
                             else params, device=self.device)
            if model.num_classes != st.num_classes:
                raise ValueError(f"params have {model.num_classes} classes; statics ask "
                                 f"for num_classes={st.num_classes}")
        elif arch == "feedforward" and st.matting_input == "native":
            model = self._plan_a_model(params)
        elif arch == "recurrent":
            model = RecurrentMatteNet(init_rvm_params(self.seed) if params is None else params,
                                      device=self.device)
        elif arch == "saliency":
            model = SaliencyNet(init_u2net_params(self.seed) if params is None else params,
                                device=self.device)
        else:
            model = MatteNet(init_mattenet_params(self.seed) if params is None else params,
                             device=self.device)
        # served models are frozen (not inference_mode, whose tensors refuse
        # the rounds' in-place row writes)
        return freeze(model)

    def _plan_a_model(self, params) -> MatteNetHD:
        """The float MatteNetHD of plan A over the natural frames (the
        reference's service/engine.py:374-388): the mask is uf x the stem
        grid ``ceil(frame / s2d_block)``; plan A's head upsample is x2."""
        st = self.statics
        fh, fw = st.frame_hw
        mh, mw = st.mask_hw
        ss = st.s2d_block
        stem_hw = (-(-fh // ss), -(-fw // ss))
        uf = max(1, mh // stem_hw[0])
        if (uf * stem_hw[0], uf * stem_hw[1]) != (mh, mw):
            raise ValueError(f"native matting: mask_hw must be an integer multiple of the "
                             f"stem grid ceil(frame/{ss}) = {stem_hw}, got {(mh, mw)}")
        tree = init_params("full", self.seed, ss) if params is None else params
        return MatteNetHD(ss, uf, "full", params=tree, device=self.device)

    def _int8_model(self, params) -> QuantizedMatteNetHD:
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
                init_params(st.matting_decoder, self.seed, blk, st.num_classes), blk,
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

    def _build_face_models(self) -> FaceModels | None:
        if not self.statics.face_path:
            return None
        if self._face_params is None:
            self._face_params = {"face": init_face_finder_params(self.seed + 1),
                                 "lmk": init_landmark_net_params(self.seed + 2)}
        fm = FaceModels(
            face=FaceFinder(self._face_params["face"], self.statics.fd_size, device=self.device),
            lmk=LandmarkNet(self._face_params["lmk"], device=self.device))
        freeze(fm.face)
        freeze(fm.lmk)
        return fm

    def _build_steps(self) -> None:
        """(Re)build the serving steps over the current models."""
        st = self.statics
        self._step = make_step(self.model, st, self.face_models)
        self._range_step = make_range_step(self.model, st, self.face_models)
        self._round_steps: dict = {}
        # the fast refine's routing; host_lanes: the step takes (packed, lanes)
        self.routing = fast_routing(self.model, st)
        self.host_lanes = self.routing["host_lanes"]

    def load_matting_params(self, path) -> None:
        """Serve the matting weights of an ``.npz`` export
        (bridge.py::save_export; the committed ones are under ``weights/``):
        the int8 serving dict for the s2d presets, the float tree of the
        natural layout's model (``mattenet.npz``, ``rvm.npz``,
        ``u2net.npz``, ``mattenet_hd.npz``, ``mattenet_multiclass.npz``),
        as the constructor's ``params``."""
        self.model = self._matting_model(load_export(path))
        self._build_steps()

    def load_face_params(self, face_path, lmk_path=None) -> None:
        """Serve the FaceFinder tree of the ``.npz`` export ``face_path``
        and, with ``lmk_path``, the LandmarkNet tree of that one (else the
        current one stays), as the constructor's ``face_params``."""
        if lmk_path is not None:
            lmk = load_export(lmk_path)
        else:  # the current tree (drawn from the seed if there is none yet)
            lmk = (self._face_params or {"lmk": init_landmark_net_params(self.seed + 2)})["lmk"]
        self._face_params = {"face": load_export(face_path), "lmk": lmk}
        self.face_models = self._build_face_models()
        self._build_steps()

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

    def reset_knobs(self, slot: int) -> None:
        """Stage every knob of ``slot`` back to its default."""
        self.set_knobs(
            slot,
            ema=cfg.DEFAULT_EMA,
            ema_adapt=self.statics.ema_adapt_default,
            noise_cutoff=cfg.DEFAULT_NOISE_CUTOFF,
            high_threshold=cfg.DEFAULT_HIGH_THRESHOLD,
            gamma=cfg.DEFAULT_GAMMA,
            use_bilateral=cfg.DEFAULT_USE_BILATERAL,
            sigma_spatial=cfg.DEFAULT_BILATERAL_SIGMA_SPATIAL,
            sigma_range=cfg.DEFAULT_BILATERAL_SIGMA_RANGE,
        )

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
        the device.  Returns ``(frames_in, step_input)``: the caller's
        frames as passed (a tuple's packed frames), for passthrough, and
        what the step takes -- packed frames for the s2d layout and, where
        the step takes host lanes, a ``(packed, lanes)`` tuple (the
        caller's lanes, or gathered here from the packed frames).  A tuple
        is refused where the step takes no host lanes."""
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
            return fp, (fp, lanes.contiguous())
        fin = self._to_device(frames)
        if tuple(fin.shape) not in (natural, packed):
            raise ValueError(f"frames must be u8 {natural}" + (f" or packed {packed}" if packed
                                                               else "")
                             + f", got {tuple(fin.shape)}")
        fj = fin
        if self.packed and tuple(fin.shape) == natural:
            fj = space_to_depth(fin, blk).contiguous()
        if self.host_lanes:
            return fin, (fj, guide_lanes_s2d(fj, (fh, fw), st.mask_hw, blk)[0])
        return fin, fj

    def _unpack(self, frame: torch.Tensor) -> torch.Tensor:
        """Served frames in the output layout: packed ones unpacked unless
        ``output_layout='packed'`` (s2d with 'blur' composites natural)."""
        if self.output_layout == "natural" and self.packed and frame.shape[-1] != 3:
            return depth_to_space(frame, self.statics.s2d_block)
        return frame

    def _done_event(self):
        """An event after what has been enqueued so far (None on the CPU,
        where the step has already run)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _sync(self) -> None:
        """Wait for what has been enqueued: a failure on the card raises."""
        ev = self._done_event()
        if ev is not None:
            ev.synchronize()

    # ---- results ---------------------------------------------------------
    def _served(self, out: dict) -> dict:
        return {"frame": self._unpack(out["frame"]), "alpha": out["alpha"],
                "passthrough": False,
                **{k: v for k, v in out.items() if k not in ("frame", "alpha")}}

    def _passthrough(self, frames_in: torch.Tensor) -> dict:
        """The input frames as they came, alpha f32 ones, no face applied."""
        rows = frames_in.shape[0]
        self.passthrough_steps += 1
        return {"frame": frames_in,
                "alpha": torch.ones((rows, *self.statics.mask_hw), dtype=torch.float32,
                                    device=self.device),
                "passthrough": True,
                "face_applied": torch.zeros((rows,), dtype=torch.bool, device=self.device)}

    def _finish(self, res: dict, rows: int, t0: float, t1: float, slots=None) -> dict:
        """Count the step (a passthrough has t1 = t0) and add the metrics."""
        t2 = time.perf_counter()
        self.counters.record_step(rows, (t2 - t1) * 1e3, (t2 - t0) * 1e3)
        if slots is not None:
            res["slots"] = slots
        res["metrics"] = self.stats()
        return res

    def _n_active(self) -> int:
        return int(self.active.sum()) or self.num_streams

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

    # ---- the synchronous steps --------------------------------------------
    def process(self, frames) -> dict:
        """One batch step: frames u8 ``[S, H, W, 3]``, packed, or a
        ``(packed, lanes)`` tuple (rows of inactive slots are processed too
        and ignored).  Returns ``frame`` (composited u8 ``[S, H, W, 3]``, or
        packed with ``output_layout='packed'``), ``alpha`` (``[S, mh,
        mw]``, bf16 or f32 by ``refined_dtype``), ``passthrough``,
        ``metrics`` and the step's face outputs (``face_applied``,
        ``det_score``, ``face_has_prior``; and ``face_prior_params`` where
        the prior rides as scalars), as tensors on the engine's device.
        With K > 1 classes: ``alpha`` is class 1's map (f32),
        ``class_alpha`` the smoothed class maps ``[S, mh, mw, K]``, and
        ``det_score`` and ``face_applied`` are zeros.  A passthrough
        result has ``frame``, ``alpha``, ``passthrough`` and
        ``face_applied`` only."""
        t0 = time.perf_counter()
        self._apply_staged()
        now = time.monotonic()
        frames_in, fj = self._ingest(frames)
        if self.health.serve_passthrough:
            return self._finish(self._passthrough(frames_in), self._n_active(), t0, t0)
        gate = torch.as_tensor((now - self._last_face_at) >= self.face_min_interval_s,
                               device=self.device)
        t1 = time.perf_counter()
        try:
            with pinned():
                new_state, out = self._step(self.state, fj, self.backgrounds, self.knobs, gate)
            self._sync()
            applied = out["face_applied"].cpu().numpy()
        except Exception as e:  # a failed step degrades to passthrough
            self.health.record_failure(e)
            return self._finish(self._passthrough(frames_in), self._n_active(), t0, t0)
        self.health.record_success()
        self.state = new_state
        self._last_face_at[applied] = now
        return self._finish(self._served(out), self._n_active(), t0, t1)

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
        written back once the step succeeded.  Returns :meth:`process`'s
        keys and ``slots``."""
        gs = i1 - i0
        t0 = time.perf_counter()
        self._apply_staged()
        now = time.monotonic()
        frames_in, fj = self._ingest(frames, rows=gs)
        if self.health.serve_passthrough:
            return self._finish(self._passthrough(frames_in), gs, t0, t0, (i0, i1))
        gate = torch.as_tensor(
            (now - self._last_face_at[i0:i1]) >= self.face_min_interval_s, device=self.device)
        rows = slice(i0, i1)
        gstate = rows_of(self.state, rows)
        bgs = self.backgrounds if self.backgrounds.shape[0] == 1 else self.backgrounds[rows]
        t1 = time.perf_counter()
        try:
            with pinned():
                new_g, out = self._step(gstate, fj, bgs, rows_of(self.knobs, rows), gate)
            self._sync()
            applied = out["face_applied"].cpu().numpy()
        except Exception as e:
            self.health.record_failure(e)
            return self._finish(self._passthrough(frames_in), gs, t0, t0, (i0, i1))
        write_rows(gstate, new_g)
        self.health.record_success()
        self._last_face_at[i0:i1][applied] = now
        return self._finish(self._served(out), gs, t0, t1, (i0, i1))

    def process_chunked(self, frames, chunk_size: int) -> dict:
        """:meth:`process` as consecutive steps of ``chunk_size`` streams
        (the first chunk's frames are ready after a chunk-sized step).
        Streams are independent, so the results are :meth:`process`'s
        where the face path's compaction (at most ceil(rows /
        lmk_interval) streams a step, face_batch=0) picks the same
        streams."""
        if self.num_streams % chunk_size:
            raise ValueError("chunk_size must divide num_streams")
        t0 = time.perf_counter()
        self._apply_staged()
        now = time.monotonic()
        frames_in, fj = self._ingest(frames)
        if self.health.serve_passthrough:
            return self._finish(self._passthrough(frames_in), self._n_active(), t0, t0)
        gate = torch.as_tensor((now - self._last_face_at) >= self.face_min_interval_s,
                               device=self.device)

        def frame_rows(rows):  # (packed, lanes): lanes carry streams on axis 1
            if isinstance(fj, tuple):
                return fj[0][rows], fj[1][:, rows].contiguous()
            return fj[rows]

        t1 = time.perf_counter()
        try:
            states, outs = [], []
            with pinned():
                for i0 in range(0, self.num_streams, chunk_size):
                    rows = slice(i0, i0 + chunk_size)
                    bgs = (self.backgrounds if self.backgrounds.shape[0] == 1
                           else self.backgrounds[rows])
                    new_c, out_c = self._step(rows_of(self.state, rows), frame_rows(rows), bgs,
                                              rows_of(self.knobs, rows), gate[rows])
                    states.append(new_c)
                    outs.append(out_c)
                new_state, out = _cat_rows(states), _cat_rows(outs)
            self._sync()
            applied = out["face_applied"].cpu().numpy()
        except Exception as e:
            self.health.record_failure(e)
            return self._finish(self._passthrough(frames_in), self._n_active(), t0, t0)
        self.health.record_success()
        self.state = new_state
        self._last_face_at[applied] = now
        return self._finish(self._served(out), self._n_active(), t0, t1)

    # ---- pipelined serving: dispatch now, collect later -------------------
    def dispatch(self, frames) -> dict:
        """Launch one full-batch step without waiting for the card; the
        state advances to the step's (still computing) new state, the face
        gate and its update stay on the device.  Pair with :meth:`collect`;
        returns its token."""
        t0 = time.perf_counter()
        self._apply_staged()
        now = time.monotonic()
        frames_in, fj = self._ingest(frames)
        token = {"t0": t0, "now": now, "frames_in": frames_in}
        if self.health.serve_passthrough:
            token["degraded"] = True
            return token
        self._maybe_snapshot()
        t1 = time.perf_counter()
        try:
            with pinned():
                gate = self._face_gate_async(0, self.num_streams, now)
                new_state, out = self._step(self.state, fj, self.backgrounds, self.knobs, gate)
                self._face_applied_async(0, out["face_applied"], now)
        except Exception as e:  # a failure while enqueueing: nothing was written
            self.health.record_failure(e)
            token["failed"] = True
            return token
        token.update(out=out, t1=t1, prev_state=self.state, done=self._done_event())
        self.state = new_state
        return token

    def collect(self, token: dict) -> dict:
        """Wait for a :meth:`dispatch` and return :meth:`process`'s dict
        (tokens of :meth:`dispatch_range` go to :meth:`collect_range`).  A
        failure on the card rolls the state back to the token's
        ``prev_state`` and serves passthrough."""
        if "slots" in token:
            return self.collect_range(token)
        t0 = token["t0"]
        if "out" in token:
            try:
                if self.collect_sync and token["done"] is not None:
                    token["done"].synchronize()
                self.health.record_success()
                return self._finish(self._served(token["out"]), self._n_active(), t0,
                                    token["t1"])
            except Exception as e:
                self.health.record_failure(e)
                self.state = token["prev_state"]
                # the dispatch's mirror update chained on the failed step:
                # rebuilt from the host clock at the next dispatch
                self._face_last_dev = None
        return self._finish(self._passthrough(token["frames_in"]), self._n_active(), t0, t0)

    def _fail_in_place(self, e: Exception) -> None:
        """A range or round step failed after it may have written rows:
        record it, restore the snapshot, rebuild the face clock's mirror."""
        self.health.record_failure(e)
        self._recover_state()
        self._face_last_dev = None

    def dispatch_range(self, i0: int, i1: int, frames) -> dict:
        """Launch the group step of rows ``[i0, i1)`` without waiting
        (runtime/pipeline.py::make_range_step: slice, step, write back in
        place, the face gate on the device).  Pair with
        :meth:`collect_range`."""
        t0 = time.perf_counter()
        self._apply_staged()
        now = time.monotonic()
        frames_in, fj = self._ingest(frames, rows=i1 - i0)
        token = {"t0": t0, "now": now, "frames_in": frames_in, "slots": (i0, i1)}
        if self.health.serve_passthrough:
            token["degraded"] = True
            return token
        self._maybe_snapshot()
        t1 = time.perf_counter()
        try:
            with pinned():
                _, _, out = self._range_step(self.state, i0, fj, self.backgrounds, self.knobs,
                                             self._face_mirror(), self._now_device(now),
                                             self._min_interval_device(), i1 - i0)
        except Exception as e:
            self._fail_in_place(e)
            token["failed"] = True
            return token
        token.update(out=out, t1=t1, done=self._done_event())
        return token

    def collect_range(self, token: dict) -> dict:
        """Wait for a :meth:`dispatch_range`; returns its group's results
        (:meth:`process_range`'s keys).  A failure on the card restores the
        snapshot (:meth:`_recover_state`) and serves passthrough."""
        i0, i1 = token["slots"]
        t0 = token["t0"]
        if "out" in token:
            try:
                if self.collect_sync and token["done"] is not None:
                    token["done"].synchronize()
                self.health.record_success()
                return self._finish(self._served(token["out"]), i1 - i0, t0, token["t1"],
                                    (i0, i1))
            except Exception as e:
                self._fail_in_place(e)
        return self._finish(self._passthrough(token["frames_in"]), i1 - i0, t0, t0, (i0, i1))

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
        """The round itself, after ingest: the recovery snapshot on its
        cadence, then every group's range step over the full state in
        order, the face clock on the device.  It makes no host
        synchronisation once the face clock's mirror exists (the first
        dispatch builds it).  Returns each group's step outputs."""
        rs = self._round_step_for(group_sizes)
        self._maybe_snapshot()
        with pinned():
            _, _, outs = rs(self.state, step_frames, self.backgrounds, self.knobs,
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
        ins = [self._ingest(f, rows=g) for f, g in zip(frames_list, sizes)]
        token = {"t0": t0, "now": now, "round": True, "group_sizes": sizes,
                 "frames_in": [i[0] for i in ins]}
        if self.health.serve_passthrough:
            token["degraded"] = True
            return token
        t1 = time.perf_counter()
        try:
            outs = self.round_step(sizes, [i[1] for i in ins], now)
        except Exception as e:
            self._fail_in_place(e)
            token["failed"] = True
            return token
        token.update(outs=outs, t1=t1, done=self._done_event())
        return token

    def collect_round(self, token: dict) -> list[dict]:
        """Wait for a :meth:`dispatch_round`; returns one result dict a group
        (:meth:`collect_range`'s keys).  A failure serves every group's
        input frames as passthrough, the state restored from the snapshot."""
        sizes = token["group_sizes"]
        offs = np.concatenate([[0], np.cumsum(sizes)]).astype(int).tolist()
        t0, t1 = token["t0"], token["t0"]
        results = None
        if "outs" in token:
            try:
                if self.collect_sync and token["done"] is not None:
                    token["done"].synchronize()
                self.health.record_success()
                results = [self._served(out) for out in token["outs"]]
                t1 = token["t1"]
            except Exception as e:
                self._fail_in_place(e)
        if results is None:
            results = [self._passthrough(f) for f in token["frames_in"]]
        t2 = time.perf_counter()
        self.counters.record_step(sum(sizes), (t2 - t1) * 1e3, (t2 - t0) * 1e3)
        stats = self.stats()
        for g, res in enumerate(results):
            res["slots"] = (offs[g], offs[g + 1])
            res["metrics"] = stats
        return results

    # ---- recovery snapshots -----------------------------------------------
    def _maybe_snapshot(self) -> None:
        """On the cadence, take the recovery snapshot of the state as it is
        before the step being dispatched: a device copy (the cheap fields
        packed into one ``[S, K]`` f32 tensor, or every field) and a
        non-blocking copy of it into pinned host memory, with an event
        after it.  Nothing here waits for the card."""
        n = self._dispatches
        self._dispatches += 1
        every = self.snapshot_every
        if not every or n % every:
            return
        if self._snap_pending is not None:
            # the previous cadence point becomes the fallback snapshot
            self._snap = self._snap_pending
        if self.state_snapshot_every and n % self.state_snapshot_every == 0:
            kind = "full"
            tree = {str(i): t.clone() for i, t in enumerate(state_tensors(self.state))}
        else:
            kind = "cheap_packed"
            tree = {"packed": self._cheap_pack()}
        self._snap_pending = {"kind": kind, **self._to_host_async(tree)}

    def _to_host_async(self, tree: dict) -> dict:
        """``{"host": copies of tree's tensors on the host, "done": event
        after the copies or None}``; on the CPU the device copies are the
        host copies."""
        if self.device.type != "cuda":
            return {"host": tree, "done": None}
        host = {}
        for k, t in tree.items():
            host[k] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host[k].copy_(t, non_blocking=True)
        return {"host": host, "done": self._done_event()}

    def _cheap_pack(self) -> torch.Tensor:
        """The cheap per-stream fields as one fresh ``[S, K]`` f32 tensor
        (f32 carries ``frame_idx`` exactly up to 2**24 frames)."""
        st = self.state
        if self._cheap_spec is None:
            self._cheap_spec = [(k, tuple(getattr(st, k).shape[1:]), getattr(st, k).dtype)
                                for k in self._CHEAP_FIELDS if getattr(st, k) is not None]
        return torch.cat([getattr(st, k).reshape(self.num_streams, -1).to(torch.float32)
                          for k, _, _ in self._cheap_spec], dim=1)

    def _cheap_unpack(self, packed: torch.Tensor) -> dict:
        """Inverse of :meth:`_cheap_pack`."""
        out, o = {}, 0
        for k, shp, dt in self._cheap_spec:
            n = int(np.prod(shp)) if shp else 1
            out[k] = packed[:, o:o + n].reshape(self.num_streams, *shp).to(dt)
            o += n
        return out

    def _recover_state(self) -> None:
        """Rebuild ``self.state`` after a range or round step failed: the
        newest snapshot that can be read (its host copy; this is where the
        copy is waited for), else the older one, else a cold start.  A
        full snapshot is restored as it was; a cheap one gives its fields
        over a cold EMA (every stream's ``prev_alpha`` and class maps
        zero, ``initialized`` False), so face tracking and cadence phase
        survive and only the EMA re-warms (the model's state ``rec``
        zeroed, as the reference's)."""
        snap = None
        for cand in (self._snap_pending, self._snap):
            if cand is None:
                continue
            try:
                if cand["done"] is not None:
                    cand["done"].synchronize()
                snap = {"kind": cand["kind"], "tree": {k: t.clone() for k, t in
                                                       cand["host"].items()}}
                break
            except RuntimeError:
                continue  # an unreadable copy: try the older snapshot
        self._snap_pending = None
        if snap is not None and snap["kind"] == "full":
            tensors = iter(snap["tree"][str(i)] for i in range(len(snap["tree"])))
            self.state = map_state(lambda _: next(tensors).to(self.device), self.state)
            return
        fresh = init_state(self.num_streams, self.statics.mask_hw, device=self.device,
                           rec=self._zero_rec())
        if snap is not None:
            fields = self._cheap_unpack(snap["tree"]["packed"])
            fresh = dataclasses.replace(fresh, **{k: v.to(self.device)
                                                  for k, v in fields.items()})
        self.state = fresh

    # ---- observability -------------------------------------------------
    def stats(self) -> dict:
        """FPS / latency / thread-load counters, the passthrough steps
        served, health."""
        return {**self.counters.snapshot(), "passthrough_steps": self.passthrough_steps,
                "health": self.health.snapshot()}

    def stream_stats(self) -> list[dict]:
        """Per-stream counters: frames served, activity, face-tracking
        freshness."""
        idx = self.state.frame_idx.cpu().numpy()
        has_aff = self.state.has_affine.cpu().numpy()
        now = time.monotonic()
        return [
            {
                "slot": s,
                "active": bool(self.active[s]),
                "frames": int(idx[s]),
                "face_affine": bool(has_aff[s]),
                "last_face_s_ago": (round(now - self._last_face_at[s], 2)
                                    if self._last_face_at[s] > 0 else None),
            }
            for s in range(self.num_streams)
        ]
