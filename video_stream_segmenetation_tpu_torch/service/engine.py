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

``Engine(..., mesh=parallel.make_mesh(...))`` serves over several devices
(or virtual shards of one), as the reference's ``mesh=`` does: the streams
split into the mesh's data shards, each shard's state, knobs, backgrounds
and device face clock live on its device, and the models are replicated
to each distinct device (again after every load).  Every call launches
each shard's step on its own device, one after the other from this thread,
with no host synchronisation between them; a group that straddles shards
becomes one piece a shard.  The face path's cadence selection spans the
whole batch or group as one device's does (runtime/pipeline.py::
face_selections: one scalar a shard crosses devices), and the outputs are
concatenated in slot order on the mesh's first device, which is the
step's one bulk cross-device copy.  Frames from the host go to each
shard's device directly, and each shard's recovery snapshot goes to the
host from its own device.  Without a mesh the engine is a mesh of one
shard on ``device``: the same code serves both.  ``state``, ``knobs`` and
``backgrounds`` read as the whole ``[S, ...]`` trees in slot order (on a
mesh a copy on the first device, whose tensors refuse in-place writes);
assigning one splits it over the shards; a slot's write goes to the shard
that owns the slot.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import warnings

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
from video_stream_segmenetation_tpu_torch.models.quantized_face import (
    QuantizedFaceFinder,
    QuantizedLandmarkNet,
    quantize_face_finder,
    quantize_landmark_net,
)
from video_stream_segmenetation_tpu_torch.models.reference_face import (
    ReferenceFaceFinder,
    ReferenceLandmarkNet,
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
from video_stream_segmenetation_tpu_torch.parallel.mesh import (
    Mesh,
    gather_rows,
    gather_stream_tree,
    replicated,
    resolve_device,
    shard_stream_tree,
    sharded_step,
    stream_sharding,
    tree_map,
)
from video_stream_segmenetation_tpu_torch.runtime import config as cfg
from video_stream_segmenetation_tpu_torch.runtime.config import (
    PipelineStatics,
    default_knobs,
)
from video_stream_segmenetation_tpu_torch.runtime.pipeline import (
    FaceModels,
    check_statics,
    face_selections,
    fast_routing,
    make_range_step,
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


def _cat_rows(parts: list, device):
    """Concatenate on the stream axis, on ``device``, a list of
    StreamStates, or of output dicts, of consecutive row chunks."""
    def cat(ts):
        return torch.cat([t.to(device, non_blocking=True) for t in ts])

    if isinstance(parts[0], StreamState):
        return map_state(lambda *ts: cat(ts), *parts)
    return {k: cat([p[k] for p in parts]) for k in parts[0]}


class _Events:
    """Events after what has been enqueued on each of a mesh's devices."""

    def __init__(self, events: list):
        self.events = events

    def synchronize(self) -> None:
        for ev in self.events:
            ev.synchronize()


class Engine:
    # the recovery snapshot's cheap per-stream fields
    _CHEAP_FIELDS = ("affine", "has_affine", "frame_idx", "face_center", "has_center")

    def __init__(self, num_streams: int, statics: PipelineStatics | None = None,
                 params: dict | None = None, seed: int = 0, device="cuda",
                 face_params: dict | None = None, output_layout: str = "natural",
                 collect_sync: bool = True, mesh=None):
        """``statics``: None serves ``PipelineStatics()``, the reference's
        default (``active``).  ``params``: for the natural layout the float
        tree of ``statics.matting_arch``'s model (flax-shaped ``{"params",
        "batch_stats"}``, e.g. bridge.py::trained_weights: MatteNet (K
        class heads with ``num_classes``), RecurrentMatteNet, SaliencyNet),
        with ``matting_input='native'`` the MatteNetHD's: its float tree
        (``matting_precision='bf16'``, either layout) or the int8 serving
        dict (``'int8'``, s2d) of ``statics.matting_decoder``'s plan with
        ``statics.num_classes`` head classes (models/quantized.py
        ``quantize_mattenet_hd`` or bridge.py); None makes a float tree
        from ``seed`` (models/modnet.py, rvm.py, u2net.py,
        models/mattenet_hd.py; int8: then quantized).  ``face_params``:
        ``{"face": FaceFinder tree, "lmk": LandmarkNet tree}`` (flax-shaped
        float trees, e.g.
        bridge.py::trained_weights); None makes both from ``seed``.
        :meth:`load_matting_params` and :meth:`load_face_params` replace
        them from ``.npz`` exports.  With ``face_precision='int8'`` the
        face models serve those trees quantized (models/quantized_face.py);
        with ``face_models='reference'`` the MediaPipe graphs
        (:meth:`use_reference_face_models`) serve instead.

        ``output_layout``: ``'natural'`` serves the s2d presets' composited
        frames as ``[S, H, W, 3]``; ``'packed'`` serves them as the step
        makes them, ``[S, H/b, W/b, b*b*3]`` (no depth_to_space on the
        card; the consumer unpacks).  ``collect_sync``: True makes
        ``collect*`` wait for the step; False returns its outputs as
        tensors still being computed (a failure on the card then surfaces
        at the next wait: a later collect, or the consumer's read).

        ``mesh``: a parallel/mesh.py::Mesh serves the streams over its data
        shards (the module docstring; ``device`` is then the mesh's first
        device); ``num_streams`` must divide over them."""
        if output_layout not in ("natural", "packed"):
            raise ValueError(f"unknown output_layout {output_layout!r}")
        self.mesh = mesh
        # without a mesh the engine is a mesh of one shard
        self._mesh = mesh if mesh is not None else Mesh(((resolve_device(device),),))
        self.device = self._mesh.first
        # (device, first slot, end slot) of each shard
        self._shards = [(d, a, b) for d, (a, b) in zip(
            self._mesh.data_devices, stream_sharding(self._mesh, num_streams))]
        # each call's steps, a piece (a batch's or group's part of a shard)
        # on its shard's device
        self._run_steps = sharded_step(self._mesh, self._step_on)
        self._run_range_steps = sharded_step(self._mesh, self._range_step_on)
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
            bg_shape = (fh // blk, fw // blk, blk * blk * 3)
        else:
            if (st.matting_arch == "feedforward" and st.matting_input == "resized"
                    and (mh % 16 or mw % 16)):
                raise ValueError(f"mask_hw {st.mask_hw}: MatteNet needs multiples of 16")
            bg_shape = (fh, fw, 3)
        # the trees the models are built from (utils/checkpoint.py saves them)
        self.matte_params = self._seeded_matting_tree() if params is None else params
        self.model = self._matting_model(self.matte_params)
        self._face_params = face_params
        # which of the two face models are the MediaPipe graphs
        self._ref_face = {"face": False, "lmk": False}
        if st.face_models == "reference":
            self._reference_face_swap()
        self.face_models = self._build_face_models()
        self._build_steps()
        # each shard's state, knobs and backgrounds (one shard without a
        # mesh); read and assigned whole through the properties below
        self._states = [init_state(b - a, (mh, mw), device=d, rec=self._zero_rec(b - a, d))
                        for d, a, b in self._shards]
        self._knobs = [default_knobs(b - a, ema_adapt=st.ema_adapt_default, device=d)
                       for d, a, b in self._shards]
        # backgrounds are kept u8 in the frames' layout (s2d: packed, ready
        # for the packed composite)
        self._bgs = [torch.zeros((b - a, *bg_shape), dtype=torch.uint8, device=d)
                     for d, a, b in self._shards]
        self.active = np.zeros((num_streams,), bool)
        # host clock of each stream's last applied face round (L_MIN_MS)
        self._last_face_at = np.zeros((num_streams,), np.float64)
        self.face_min_interval_s = 0.180
        # the asynchronous paths' device mirror of _last_face_at (seconds
        # since _face_epoch, -1e9 = never), a tensor a shard, built at
        # their first dispatch
        self._face_epoch = time.monotonic()
        self._face_lasts = None
        self._now_bucket = None
        self._now_dev = {}
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
    def _zero_rec(self, n: int | None = None, device=None) -> tuple:
        """The model's cold per-stream state of ``n`` streams (all by
        default) on ``device`` (the engine's by default; the reference's
        service/engine.py:145-156): the RecurrentMatteNet's r1..r4, the
        multi-class smoothed class maps, or nothing."""
        st = self.statics
        n = self.num_streams if n is None else n
        device = device or self.device
        if st.matting_arch == "recurrent":
            return rvm_init_state(n, st.mask_hw, device=device)
        if st.num_classes > 1:
            return (torch.zeros((n, *st.mask_hw, st.num_classes),
                                dtype=torch.float32, device=device),)
        return ()

    def _seeded_matting_tree(self) -> dict:
        """The matting tree drawn from the seed: the MatteNetHD's float tree
        of the plan (int8: then quantized) with the native input, else the
        K-class MatteNet's, the RecurrentMatteNet's, the SaliencyNet's or
        the MatteNet's, by ``statics.matting_arch``."""
        st = self.statics
        if st.matting_input == "native":
            tree = init_params(st.matting_decoder, self.seed, st.s2d_block, st.num_classes)
            if st.matting_precision == "int8":
                tree = quantize_mattenet_hd(tree, st.s2d_block, st.matting_decoder)
            return tree
        if st.num_classes > 1:
            return init_mattenet_params(self.seed, st.num_classes)
        init = {"recurrent": init_rvm_params, "saliency": init_u2net_params}
        return init.get(st.matting_arch, init_mattenet_params)(self.seed)

    def _matting_model(self, params, device=None) -> torch.nn.Module:
        """The matting model (the reference's service/engine.py:338-424) on
        the tree ``params``, on ``device`` (the engine's by default): with
        the native input the MatteNetHD, int8 or float by
        ``matting_precision``, on either layout; else the K-class MatteNet
        (``num_classes > 1``), the RecurrentMatteNet, the SaliencyNet or
        the float MatteNet, by ``statics.matting_arch``."""
        st = self.statics
        arch = st.matting_arch
        device = device or self.device
        if st.matting_input == "native" and st.matting_precision == "int8":
            model = self._int8_model(params, device)
        elif st.matting_input == "native":
            model = self._float_hd_model(params, device)
        elif st.num_classes > 1:
            model = MatteNet(params, device=device)
            if model.num_classes != st.num_classes:
                raise ValueError(f"params have {model.num_classes} classes; statics ask "
                                 f"for num_classes={st.num_classes}")
        elif arch == "recurrent":
            model = RecurrentMatteNet(params, device=device)
        elif arch == "saliency":
            model = SaliencyNet(params, device=device)
        else:
            model = MatteNet(params, device=device)
        # served models are frozen (not inference_mode, whose tensors refuse
        # the rounds' in-place row writes)
        return freeze(model)

    def _float_hd_model(self, params, device) -> MatteNetHD:
        """The float MatteNetHD over the natural or packed frames (the
        reference's service/engine.py:345-388): the plan of the stem
        stride ``s2d_block`` and ``matting_decoder``, ``num_classes``
        classes; the mask is uf x the stem grid ``ceil(frame /
        s2d_block)``."""
        st = self.statics
        fh, fw = st.frame_hw
        mh, mw = st.mask_hw
        ss = st.s2d_block
        stem_hw = (-(-fh // ss), -(-fw // ss))
        uf = max(1, mh // stem_hw[0])
        if (uf * stem_hw[0], uf * stem_hw[1]) != (mh, mw):
            raise ValueError(f"native matting: mask_hw must be an integer multiple of the "
                             f"stem grid ceil(frame/{ss}) = {stem_hw}, got {(mh, mw)}")
        model = MatteNetHD(ss, uf, st.matting_decoder, params=params, device=device)
        if model.num_classes != st.num_classes:
            raise ValueError(f"params have {model.num_classes} classes; statics ask "
                             f"for num_classes={st.num_classes}")
        return model

    def _int8_model(self, params, device) -> QuantizedMatteNetHD:
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
        # the head grid is the stem grid; mask_hw = uf x that (uf = 1: the
        # class maps are served at the head grid, as multiclass_fast_pico)
        model = QuantizedMatteNetHD(params, blk, mh // hp, device=device,
                                    conv_impl=st.int8_conv_impl,
                                    head_impl=st.int8_head_impl)
        if model.decoder != st.matting_decoder:
            raise ValueError(f"params are the {model.decoder} plan's; statics ask "
                             f"for matting_decoder={st.matting_decoder!r}")
        if model.num_classes != st.num_classes:
            raise ValueError(f"params have {model.num_classes} classes; statics ask "
                             f"for num_classes={st.num_classes}")
        return model

    def _build_face_models(self, trees: dict | None = None,
                           device=None) -> FaceModels | None:
        """The face subpath's two models on ``device`` (the engine's by
        default): each the MediaPipe graph where
        :meth:`use_reference_face_models` put it, else the fast model on its
        float tree, from ``trees`` (``{"face", "lmk"}``) or the engine's own
        (:meth:`_swap_in_quantized_face` with ``face_precision='int8'``)."""
        if not self.statics.face_path:
            return None
        if self._face_params is None:
            self._face_params = {"face": init_face_finder_params(self.seed + 1),
                                 "lmk": init_landmark_net_params(self.seed + 2)}
        trees = trees or self._face_params
        device = device or self.device
        fm = FaceModels(
            face=ReferenceFaceFinder(device) if self._ref_face["face"] else FaceFinder(
                trees["face"], self.statics.fd_size, device=device),
            lmk=ReferenceLandmarkNet(device) if self._ref_face["lmk"] else LandmarkNet(
                trees["lmk"], device=device))
        freeze(fm.face)
        freeze(fm.lmk)
        if self.statics.face_precision == "int8":
            self._swap_in_quantized_face(fm, trees, device)
        return fm

    def _swap_in_quantized_face(self, fm: FaceModels, trees: dict, device) -> None:
        """Replace the fast face models of ``fm`` with their int8 serving
        graphs on ``device``, quantized from the float ``trees``
        (models/quantized_face.py); a MediaPipe graph stays float."""
        if not self._ref_face["face"]:
            fm.face = QuantizedFaceFinder(quantize_face_finder(trees["face"]),
                                          self.statics.fd_size, device=device)
        if not self._ref_face["lmk"]:
            fm.lmk = QuantizedLandmarkNet(quantize_landmark_net(trees["lmk"]),
                                          device=device)
        freeze(fm.face)
        freeze(fm.lmk)

    def _reference_face_swap(self) -> None:
        """Check the geometry the MediaPipe graphs need and mark both face
        models as theirs (what :meth:`use_reference_face_models` and
        ``face_models='reference'`` do before the models are built)."""
        st = self.statics
        fd, lm = ReferenceFaceFinder.input_size, ReferenceLandmarkNet.input_size
        if st.fd_size != fd or st.lmk_size != lm:
            raise ValueError(
                f"reference face graphs need fd_size={fd} / lmk_size={lm} (statics has "
                f"{st.fd_size}/{st.lmk_size}); build the Engine with matching statics "
                "before swapping")
        if st.face_precision == "int8":
            warnings.warn("face_precision='int8' does not apply to the reference ONNX face "
                          "graphs; serving them in float", stacklevel=3)
        self._ref_face = {"face": True, "lmk": True}

    def use_reference_face_models(self) -> None:
        """Serve the reference application's MediaPipe face graphs
        (models/reference_face.py) on the face subpath, in f32 (with a
        warning under ``face_precision='int8'``), and rebuild the steps and
        the cached round steps.  They need ``fd_size=256`` and
        ``lmk_size=192``: other statics raise ValueError and leave the
        engine serving as it was.  A later :meth:`load_face_params`
        reinstalls the fast models it loads."""
        self._reference_face_swap()
        self.face_models = self._build_face_models()
        self._build_steps()

    def _build_steps(self) -> None:
        """(Re)build the serving steps over the current models and, on a
        mesh, the models' replicas on its other devices with their steps
        (built from the engine's trees by the same constructors)."""
        st = self.statics
        self._step = make_step(self.model, st, self.face_models)
        self._range_step = make_range_step(self.model, st, self.face_models)
        self._round_steps: dict = {}
        # the fast refine's routing; host_lanes: the step takes (packed, lanes)
        self.routing = fast_routing(self.model, st)
        self.host_lanes = self.routing["host_lanes"]
        self._replicas = {}
        for dev in replicated(self._mesh):
            if dev == self.device:
                continue
            model = self._matting_model(self.matte_params, dev)
            faces = self._build_face_models(device=dev)
            self._replicas[dev] = {"model": model, "face_models": faces,
                                   "step": make_step(model, st, faces),
                                   "range_step": make_range_step(model, st, faces)}

    def _step_on(self, dev):
        """The step on ``dev``'s models (``self._step`` on the first)."""
        return self._step if dev == self.device else self._replicas[dev]["step"]

    def _range_step_on(self, dev):
        return self._range_step if dev == self.device else self._replicas[dev]["range_step"]

    def load_matting_params(self, path) -> None:
        """Serve the matting weights of an ``.npz`` export
        (bridge.py::save_export; the committed ones are under ``weights/``):
        the int8 serving dict for the int8 presets, else the float tree of
        the model (``mattenet.npz``, ``rvm.npz``, ``u2net.npz``,
        ``mattenet_hd.npz`` on either layout, ``mattenet_multiclass.npz``),
        as the constructor's ``params``."""
        self.load_matting_tree(load_export(path))

    def load_matting_tree(self, tree: dict) -> None:
        """Serve the matting tree ``tree`` (as the constructor's ``params``)
        and rebuild the steps."""
        self.model = self._matting_model(tree)
        self.matte_params = tree
        self._build_steps()

    @property
    def params(self) -> dict:
        """The trees the engine's models are built from (the reference's
        ``bundle.params``): ``{"matte", "face", "lmk"}``, the face trees None
        without the face path."""
        faces = self._face_params if self.statics.face_path else None
        return {"matte": self.matte_params, "face": (faces or {}).get("face"),
                "lmk": (faces or {}).get("lmk")}

    def build_models(self, matte: dict, faces: dict | None = None):
        """``(model, face_models)`` built from the trees ``matte`` and
        ``faces`` (``{"face", "lmk"}``; None: the engine's own) by the
        engine's own builders, without serving them."""
        return self._matting_model(matte), self._build_face_models(faces)

    def load_face_params(self, face_path, lmk_path=None) -> None:
        """Serve the FaceFinder tree of the ``.npz`` export ``face_path``
        and, with ``lmk_path``, the LandmarkNet tree of that one (else the
        current one stays), as the constructor's ``face_params``; quantized
        again with ``face_precision='int8'``.  Over a
        :meth:`use_reference_face_models` swap, the fast FaceFinder comes
        back, and the fast LandmarkNet with ``lmk_path`` only (else the
        MediaPipe landmark graph stays, as in the reference)."""
        if lmk_path is not None:
            lmk = load_export(lmk_path)
        else:  # the current tree (drawn from the seed if there is none yet)
            lmk = (self._face_params or {"lmk": init_landmark_net_params(self.seed + 2)})["lmk"]
        self._face_params = {"face": load_export(face_path), "lmk": lmk}
        self._ref_face["face"] = False
        if lmk_path is not None:
            self._ref_face["lmk"] = False
        self.face_models = self._build_face_models()
        self._build_steps()

    # ---- the shards ------------------------------------------------------
    def _whole(self, parts: list):
        """Per-shard trees as one in slot order: the one shard's itself, or
        a mesh's gathered on its first device, a copy whose tensors refuse
        in-place writes (inference tensors: a write would be lost on the
        shards, so it raises; a slot's write goes through the engine's
        setters)."""
        if len(parts) == 1:
            return parts[0]
        with torch.inference_mode():
            return gather_stream_tree(parts, self.device)

    def _split(self, tree) -> list:
        """A whole ``[S, ...]`` tree as the shards' trees, each on its
        shard's device (one shard: the tree itself)."""
        if len(self._shards) == 1:  # a mesh's read copy refuses the steps' writes
            tree = tree_map(lambda t: t.clone() if t.is_inference() else t, tree)
        return shard_stream_tree(self._mesh, tree)

    @property
    def state(self) -> StreamState:
        """The whole stream state in slot order (on a mesh: a read-only
        copy, :meth:`_whole`)."""
        return self._whole(self._states)

    @state.setter
    def state(self, value: StreamState) -> None:
        self._states = self._split(value)

    @property
    def knobs(self):
        return self._whole(self._knobs)

    @knobs.setter
    def knobs(self, value) -> None:
        self._knobs = self._split(value)

    @property
    def backgrounds(self) -> torch.Tensor:
        return self._whole(self._bgs)

    @backgrounds.setter
    def backgrounds(self, value: torch.Tensor) -> None:
        self._bgs = self._split(value)

    @property
    def _face_last_dev(self):
        """The device face clock, whole (None before the first dispatch)."""
        return None if self._face_lasts is None else self._whole(self._face_lasts)

    def _owner(self, slot: int) -> tuple[int, int]:
        """``(shard, row in the shard)`` of a slot."""
        for j, (_, a, b) in enumerate(self._shards):
            if a <= slot < b:
                return j, slot - a
        raise IndexError(f"slot {slot} of {self.num_streams}")

    def _pieces(self, i0: int, i1: int) -> list[tuple[int, int, int, int]]:
        """The shards' parts of rows ``[i0, i1)``, in slot order: ``(shard,
        first row in the shard, end row in the shard, offset in [i0,
        i1))``; a shard the rows miss has none."""
        out = []
        for j, (_, a, b) in enumerate(self._shards):
            lo, hi = max(a, i0), min(b, i1)
            if lo < hi:
                out.append((j, lo - a, hi - a, lo - i0))
        return out

    def _piece_trees(self, j: int, la: int, lb: int):
        """Shard ``j``'s state, backgrounds and knobs of its rows ``[la,
        lb)``: the trees themselves where that is the whole shard, else
        views."""
        st, bgs, kn = self._states[j], self._bgs[j], self._knobs[j]
        if (la, lb) == (0, st.num_streams):
            return st, bgs, kn
        rows = slice(la, lb)
        return rows_of(st, rows), bgs[rows], rows_of(kn, rows)

    # ---- stream admission ---------------------------------------------
    def _reset_slot(self, slot: int) -> None:
        """Cold-start a slot's state and device face clock on its shard."""
        j, r = self._owner(slot)
        reset_stream(self._states[j], r)
        if self._face_lasts is not None:
            self._face_lasts[j][r] = -1e9

    def admit(self) -> int:
        """Take a free slot; cold-start its state.  Returns the slot id."""
        with self._lock:
            free = np.flatnonzero(~self.active)
            if free.size == 0:
                raise RuntimeError("engine full: no free stream slots")
            s = int(free[0])
            self.active[s] = True
        self._reset_slot(s)
        self._last_face_at[s] = 0.0
        return s

    def admit_all(self) -> list[int]:
        """Activate every free slot at once, with one state reset a shard."""
        with self._lock:
            free = np.flatnonzero(~self.active)
            self.active[:] = True
        if free.size:
            mask = np.zeros((self.num_streams,), bool)
            mask[free] = True
            for j, (d, a, b) in enumerate(self._shards):
                mask_t = torch.as_tensor(mask[a:b], device=d)
                reset_streams(self._states[j], mask_t)
                if self._face_lasts is not None:
                    last = self._face_lasts[j]
                    last.copy_(torch.where(mask_t, -1e9, last))
            self._last_face_at[free] = 0.0
        return [int(s) for s in free]

    def evict(self, slot: int) -> None:
        with self._lock:
            self.active[slot] = False
        self._reset_slot(slot)

    def set_cadence_phases(self, slots, phases) -> None:
        """Set the slots' ``frame_idx`` (their face cadence phase), one
        write a shard (runtime/scheduler.py staggers admission with it)."""
        mask = np.zeros((self.num_streams,), bool)
        vals = np.zeros((self.num_streams,), np.int32)
        mask[np.asarray(slots, int)] = True
        vals[np.asarray(slots, int)] = phases
        for st, (d, a, b) in zip(self._states, self._shards):
            fi = st.frame_idx
            fi.copy_(torch.where(torch.as_tensor(mask[a:b], device=d),
                                 torch.as_tensor(vals[a:b], device=d), fi))

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
        j, r = self._owner(slot)
        dev = self._shards[j][0]
        img = torch.as_tensor(np.asarray(image), device=dev)
        if img.dtype == torch.uint8:
            img = img.to(torch.float32) / 255.0
        img = img.to(torch.float32)
        fh, fw = self.statics.frame_hw
        if tuple(img.shape[:2]) != (fh, fw):
            a_h = interp_matrix(fh, img.shape[0], "half_pixel", device=dev)
            a_w = interp_matrix(fw, img.shape[1], "half_pixel", device=dev)
            with pinned():
                img = torch.einsum("oh,hwc->owc", a_h, img)
                img = torch.einsum("pw,hwc->hpc", a_w, img)
        img_u8 = denormalize_to_u8(img)
        if self.packed:
            img_u8 = space_to_depth(img_u8, self.statics.s2d_block)
        self._bgs[j][r] = img_u8

    def _apply_staged(self):
        with self._lock:
            staged, self._staged_knobs = self._staged_knobs, {}
        for slot, kw in staged.items():
            j, r = self._owner(slot)
            self._knobs[j].replace_stream(r, **kw)

    # ---- ingest --------------------------------------------------------
    def _to_device(self, x, device=None) -> torch.Tensor:
        """u8 frames (numpy, possibly a view into a FramePool ring, or a
        tensor) on ``device`` (the engine's by default).  A host array goes
        over with a non-blocking copy: from pageable memory the copy has
        taken the bytes when it returns, so the ring buffer may be
        refilled."""
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x, dtype=np.uint8))
        if x.dtype != torch.uint8:
            raise ValueError(f"frames must be u8, got {x.dtype}")
        return x.to(device or self.device, non_blocking=True)

    def _ingest(self, frames, rows: int | None = None, i0: int = 0):
        """Normalise step input for ``rows`` streams (all by default) from
        slot ``i0`` on, on the device.  Returns ``(frames_in,
        step_input)``: the caller's frames as passed (a tuple's packed
        frames), for passthrough, and what the step takes -- packed frames
        for the s2d layout and, where the step takes host lanes, a
        ``(packed, lanes)`` tuple (the caller's lanes, or gathered here from
        the packed frames).  A tuple is refused where the step takes no
        host lanes.  Both are lists, one entry a piece of the rows
        (:meth:`_pieces`; one without a mesh), each piece's frames copied
        from the caller straight to its shard's device (lanes carry
        streams on axis 1)."""
        rows = self.num_streams if rows is None else rows
        if isinstance(frames, tuple):
            if not self.host_lanes:
                raise ValueError("(packed, lanes) input needs guide_source='host' on a route "
                                 "that takes the lanes (engine.host_lanes)")
            n = frames[0].shape[0]
        else:
            if not isinstance(frames, torch.Tensor):
                frames = np.asarray(frames)
            n = frames.shape[0]
        if n != rows:
            raise ValueError(f"frames must have {rows} rows, got {n}")
        fins, steps = [], []
        for j, la, lb, off in self._pieces(i0, i0 + rows):
            k = lb - la
            part = ((frames[0][off:off + k], frames[1][:, off:off + k])
                    if isinstance(frames, tuple) else frames[off:off + k])
            fin, fj = self._ingest_on(part, k, self._shards[j][0])
            fins.append(fin)
            steps.append(fj)
        return fins, steps

    def _ingest_on(self, frames, rows: int, device):
        """:meth:`_ingest` of ``rows`` streams on ``device``."""
        st = self.statics
        fh, fw = st.frame_hw
        blk = st.s2d_block
        natural = (rows, fh, fw, 3)
        packed = (rows, fh // blk, fw // blk, blk * blk * 3) if self.packed else None
        if isinstance(frames, tuple):
            if not self.host_lanes:
                raise ValueError("(packed, lanes) input needs guide_source='host' on a route "
                                 "that takes the lanes (engine.host_lanes)")
            fp, lanes = (self._to_device(x, device) for x in frames)
            if tuple(fp.shape) != packed:
                raise ValueError(f"(packed, lanes) input: packed frames must be u8 {packed}, "
                                 f"got {tuple(fp.shape)}")
            return fp, (fp, lanes.contiguous())
        fin = self._to_device(frames, device)
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
        where the step has already run); on a mesh of several cards one a
        card (:class:`_Events`)."""
        if self.device.type != "cuda":
            return None
        evs = []
        for dev in dict.fromkeys(d for d, _, _ in self._shards):
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            evs.append(ev)
        return evs[0] if len(evs) == 1 else _Events(evs)

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

    def _passthrough(self, frames_in) -> dict:
        """The input frames as they came (a mesh's pieces gathered on its
        first device), alpha f32 ones, no face applied."""
        if isinstance(frames_in, list):
            frames_in = gather_rows(frames_in, self.device)
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
    def _face_mirrors(self) -> list:
        """The device mirror of the host face clock, a tensor a shard, built
        at first use (seconds since the engine's epoch; never -> -1e9)."""
        if self._face_lasts is None:
            host = self._last_face_at
            base = np.where(host > 0, host - self._face_epoch, -1e9).astype(np.float32)
            self._face_lasts = [torch.as_tensor(base[a:b], device=d)
                                for d, a, b in self._shards]
        return self._face_lasts

    def _now_device(self, now: float, device=None) -> torch.Tensor:
        """``now - epoch`` as a scalar on ``device`` (the engine's by
        default), in 25 ms buckets (made by a fill on the device, not
        copied from the host)."""
        device = device or self.device
        q = int((now - self._face_epoch) * 40.0)
        if self._now_bucket != q:
            self._now_bucket = q
            self._now_dev = {}
        if device not in self._now_dev:
            self._now_dev[device] = torch.full((), q / 40.0, dtype=torch.float32,
                                               device=device)
        return self._now_dev[device]

    def _min_interval_device(self, device=None) -> torch.Tensor:
        device = device or self.device
        mi = float(self.face_min_interval_s)
        if self._mi_cache is None or self._mi_cache[0] != mi:
            self._mi_cache = (mi, {})
        cache = self._mi_cache[1]
        if device not in cache:
            cache[device] = torch.full((), mi, dtype=torch.float32, device=device)
        return cache[device]

    def _shard_rows(self, i0: int, gs: int) -> tuple[int, int, torch.device]:
        """``(shard, its row of slot i0, its device)`` of rows ``[i0,
        i0+gs)``, which must lie in one shard."""
        j, r = self._owner(i0)
        if i0 + gs > self._shards[j][2]:
            raise ValueError(f"rows [{i0}, {i0 + gs}) span more than one shard")
        return j, r, self._shards[j][0]

    def _face_gate_async(self, i0: int, gs: int, now: float) -> torch.Tensor:
        """The min-interval gate of rows ``[i0, i0+gs)`` (of one shard), on
        its shard's device."""
        j, r, dev = self._shard_rows(i0, gs)
        return (self._now_device(now, dev) - self._face_mirrors()[j][r:r + gs]) \
            >= self._min_interval_device(dev)

    def _face_applied_async(self, i0: int, applied: torch.Tensor, now: float) -> None:
        """Fold a step's ``face_applied`` of rows from ``i0`` (of one shard)
        into the device mirror in place."""
        j, r, dev = self._shard_rows(i0, applied.shape[0])
        cur = self._face_mirrors()[j][r:r + applied.shape[0]]
        cur.copy_(torch.where(applied, self._now_device(now, dev), cur))

    # ---- running the step on the shards ------------------------------------
    def _host_gates(self, gate: np.ndarray, pieces) -> list:
        """The host face gate of a batch's rows, a device tensor a piece."""
        return [torch.as_tensor(gate[off:off + lb - la], device=self._shards[j][0])
                for j, la, lb, off in pieces]

    def _gather(self, outs: list) -> dict:
        """The pieces' output dicts as one, rows in slot order, on the
        engine's device (one piece: its own tensors)."""
        return {k: gather_rows([o[k] for o in outs], self.device) for k in outs[0]}

    def _run_pieces(self, pieces, parts: list, gates: list, rows: int):
        """The step on each piece (:meth:`_pieces`), each on its shard's
        device, in slot order, with no host synchronisation between them;
        the face path's selection spans the ``rows`` rows.  ``parts`` and
        ``gates``: a piece each.  Returns the pieces' trees
        (:meth:`_piece_trees`) and their ``(new state, outputs)``."""
        trees = [self._piece_trees(j, la, lb) for j, la, lb, _ in pieces]
        sels = face_selections(self.statics, [t[0].frame_idx for t in trees], gates, rows)
        res = self._run_steps([(st, part, bgs, kn, gate)
                               for (st, bgs, kn), part, gate in zip(trees, parts, gates)],
                              [{} if sel is None else {"face_sel": sel} for sel in sels],
                              [j for j, _, _, _ in pieces])
        return trees, res

    def _run_range(self, i0: int, i1: int, parts: list, now: float) -> dict:
        """The range step (runtime/pipeline.py::make_range_step) of rows
        ``[i0, i1)`` on each piece, its rows written back in place, the face
        gate and its update on each shard's device.  Returns the rows'
        outputs."""
        pieces = self._pieces(i0, i1)
        lasts = self._face_mirrors()
        sels = [None]
        if len(pieces) > 1:  # the face path's selection spans the pieces
            sels = face_selections(
                self.statics, [self._states[j].frame_idx[la:lb] for j, la, lb, _ in pieces],
                [self._face_gate_async(self._shards[j][1] + la, lb - la, now)
                 for j, la, lb, _ in pieces], i1 - i0)
        args = [(self._states[j], la, part, self._bgs[j], self._knobs[j], lasts[j],
                 self._now_device(now, self._shards[j][0]),
                 self._min_interval_device(self._shards[j][0]), lb - la)
                for (j, la, lb, _), part in zip(pieces, parts)]
        outs = self._run_range_steps(args, [{} if sel is None else {"face_sel": sel}
                                            for sel in sels], [j for j, _, _, _ in pieces])
        return self._gather([out for _, _, out in outs])

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
        pieces = self._pieces(0, self.num_streams)
        gates = self._host_gates((now - self._last_face_at) >= self.face_min_interval_s, pieces)
        t1 = time.perf_counter()
        try:
            with pinned():
                _, res = self._run_pieces(pieces, fj, gates, self.num_streams)
            self._sync()
            out = self._gather([o for _, o in res])
            applied = out["face_applied"].cpu().numpy()
        except Exception as e:  # a failed step degrades to passthrough
            self.health.record_failure(e)
            return self._finish(self._passthrough(frames_in), self._n_active(), t0, t0)
        self.health.record_success()
        self._states = [new for new, _ in res]
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
        frames_in, fj = self._ingest(frames, rows=gs, i0=i0)
        if self.health.serve_passthrough:
            return self._finish(self._passthrough(frames_in), gs, t0, t0, (i0, i1))
        pieces = self._pieces(i0, i1)
        gates = self._host_gates(
            (now - self._last_face_at[i0:i1]) >= self.face_min_interval_s, pieces)
        t1 = time.perf_counter()
        try:
            with pinned():
                trees, res = self._run_pieces(pieces, fj, gates, gs)
            self._sync()
            out = self._gather([o for _, o in res])
            applied = out["face_applied"].cpu().numpy()
        except Exception as e:
            self.health.record_failure(e)
            return self._finish(self._passthrough(frames_in), gs, t0, t0, (i0, i1))
        for (gstate, _, _), (new_g, _) in zip(trees, res):
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
        gate = (now - self._last_face_at) >= self.face_min_interval_s

        def frame_rows(x, rows):  # (packed, lanes): lanes carry streams on axis 1
            if isinstance(x, tuple):
                return x[0][rows], x[1][:, rows].contiguous()
            return x[rows]

        t1 = time.perf_counter()
        try:
            states = [[] for _ in self._shards]
            outs = []
            with pinned():
                for i0 in range(0, self.num_streams, chunk_size):
                    pieces = self._pieces(i0, i0 + chunk_size)
                    _, res = self._run_pieces(
                        pieces, [frame_rows(fj[j], slice(la, lb)) for j, la, lb, _ in pieces],
                        self._host_gates(gate[i0:i0 + chunk_size], pieces), chunk_size)
                    for (j, _, _, _), (new_c, out_c) in zip(pieces, res):
                        states[j].append(new_c)
                        outs.append(out_c)
                new_states = [_cat_rows(p, d) for p, (d, _, _) in zip(states, self._shards)]
                out = _cat_rows(outs, self.device)
            self._sync()
            applied = out["face_applied"].cpu().numpy()
        except Exception as e:
            self.health.record_failure(e)
            return self._finish(self._passthrough(frames_in), self._n_active(), t0, t0)
        self.health.record_success()
        self._states = new_states
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
        pieces = self._pieces(0, self.num_streams)
        try:
            with pinned():
                gates = [self._face_gate_async(a, b - a, now) for _, a, b in self._shards]
                _, res = self._run_pieces(pieces, fj, gates, self.num_streams)
                for (_, a, _), (_, out) in zip(self._shards, res):
                    self._face_applied_async(a, out["face_applied"], now)
                out = self._gather([o for _, o in res])
        except Exception as e:  # a failure while enqueueing: nothing was written
            self.health.record_failure(e)
            token["failed"] = True
            return token
        token.update(out=out, t1=t1, prev_state=self._states, done=self._done_event())
        self._states = [new for new, _ in res]
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
                self._states = token["prev_state"]
                # the dispatch's mirror update chained on the failed step:
                # rebuilt from the host clock at the next dispatch
                self._face_lasts = None
        return self._finish(self._passthrough(token["frames_in"]), self._n_active(), t0, t0)

    def _fail_in_place(self, e: Exception) -> None:
        """A range or round step failed after it may have written rows:
        record it, restore the snapshot, rebuild the face clock's mirror."""
        self.health.record_failure(e)
        self._recover_state()
        self._face_lasts = None

    def dispatch_range(self, i0: int, i1: int, frames) -> dict:
        """Launch the group step of rows ``[i0, i1)`` without waiting
        (runtime/pipeline.py::make_range_step: slice, step, write back in
        place, the face gate on the device).  Pair with
        :meth:`collect_range`."""
        t0 = time.perf_counter()
        self._apply_staged()
        now = time.monotonic()
        frames_in, fj = self._ingest(frames, rows=i1 - i0, i0=i0)
        token = {"t0": t0, "now": now, "frames_in": frames_in, "slots": (i0, i1)}
        if self.health.serve_passthrough:
            token["degraded"] = True
            return token
        self._maybe_snapshot()
        t1 = time.perf_counter()
        try:
            with pinned():
                out = self._run_range(i0, i1, fj, now)
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
        """The round over ``group_sizes``, cached: ``rs(step_frames, now) ->
        [outputs a group]`` steps each group in order, each group's pieces
        on their shards (:meth:`_run_range`), with the face clock on the
        devices (the reference's runtime/pipeline.py::make_round_step:
        every group's range step over the full state at the schedule's
        offsets, one knob snapshot and one ``now``)."""
        key = tuple(int(g) for g in group_sizes)
        rs = self._round_steps.get(key)
        if rs is None:
            if sum(key) != self.num_streams:
                raise ValueError(f"group_sizes {key} do not sum to {self.num_streams}")
            offs = np.concatenate([[0], np.cumsum(key)]).astype(int).tolist()

            def rs(step_frames, now):
                return [self._run_range(offs[g], offs[g + 1], step_frames[g], now)
                        for g in range(len(key))]
            self._round_steps[key] = rs
        return rs

    def round_step(self, group_sizes, step_frames, now: float) -> list[dict]:
        """The round itself, after ingest (``step_frames``: each group's
        :meth:`_ingest` step input): the recovery snapshot on its cadence,
        then every group's range step over the full state in order, the
        face clock on the device.  It makes no host synchronisation once
        the face clock's mirror exists (the first dispatch builds it).
        Returns each group's step outputs."""
        rs = self._round_step_for(group_sizes)
        self._maybe_snapshot()
        with pinned():
            return rs(step_frames, now)

    def dispatch_round(self, group_sizes, frames_list) -> dict:
        """Launch one whole rotation round (every group stepped once) without
        waiting: the groups' frames are ingested, then :meth:`round_step`.
        Knobs and the face clock advance once a round.  Pair with
        :meth:`collect_round`."""
        t0 = time.perf_counter()
        self._apply_staged()
        now = time.monotonic()
        sizes = [int(g) for g in group_sizes]
        offs = np.concatenate([[0], np.cumsum(sizes)]).astype(int).tolist()
        ins = [self._ingest(f, rows=g, i0=o) for f, g, o in zip(frames_list, sizes, offs)]
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
        before the step being dispatched, shard by shard on the shard's
        device: a device copy (the cheap fields packed into one ``[rows,
        K]`` f32 tensor, or every field) and a non-blocking copy of it into
        pinned host memory, with an event after the copies.  Nothing here
        waits for the card, and nothing crosses from one card to another."""
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
            trees = [{str(i): t.clone() for i, t in enumerate(state_tensors(st))}
                     for st in self._states]
        else:
            kind = "cheap_packed"
            trees = [{"packed": self._cheap_pack(st)} for st in self._states]
        self._snap_pending = {"kind": kind, **self._to_host_async(trees)}

    def _to_host_async(self, trees: list) -> dict:
        """``{"host": [copies of each shard's tree on the host], "done":
        event after the copies or None}``; on the CPU the device copies are
        the host copies."""
        if self.device.type != "cuda":
            return {"host": trees, "done": None}
        host = []
        for tree in trees:
            host.append({})
            for k, t in tree.items():
                host[-1][k] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host[-1][k].copy_(t, non_blocking=True)
        return {"host": host, "done": self._done_event()}

    def _cheap_pack(self, st: StreamState) -> torch.Tensor:
        """A shard's cheap per-stream fields as one fresh ``[rows, K]`` f32
        tensor (f32 carries ``frame_idx`` exactly up to 2**24 frames)."""
        if self._cheap_spec is None:
            self._cheap_spec = [(k, tuple(getattr(st, k).shape[1:]), getattr(st, k).dtype)
                                for k in self._CHEAP_FIELDS if getattr(st, k) is not None]
        return torch.cat([getattr(st, k).reshape(st.num_streams, -1).to(torch.float32)
                          for k, _, _ in self._cheap_spec], dim=1)

    def _cheap_unpack(self, packed: torch.Tensor) -> dict:
        """Inverse of :meth:`_cheap_pack`."""
        out, o = {}, 0
        for k, shp, dt in self._cheap_spec:
            n = int(np.prod(shp)) if shp else 1
            out[k] = packed[:, o:o + n].reshape(packed.shape[0], *shp).to(dt)
            o += n
        return out

    def _recover_state(self) -> None:
        """Rebuild the state after a range or round step failed, shard by
        shard on the shard's device: the newest snapshot that can be read
        (its host copies; this is where the copies are waited for), else
        the older one, else a cold start.  A full snapshot is restored as
        it was; a cheap one gives its fields over a cold EMA (every
        stream's ``prev_alpha`` and class maps zero, ``initialized``
        False), so face tracking and cadence phase survive and only the EMA
        re-warms (the model's state ``rec`` zeroed, as the reference's)."""
        snap = None
        for cand in (self._snap_pending, self._snap):
            if cand is None:
                continue
            try:
                if cand["done"] is not None:
                    cand["done"].synchronize()
                snap = {"kind": cand["kind"], "trees": [
                    {k: t.clone() for k, t in tree.items()} for tree in cand["host"]]}
                break
            except RuntimeError:
                continue  # an unreadable copy: try the older snapshot
        self._snap_pending = None
        states = []
        for j, (d, a, b) in enumerate(self._shards):
            if snap is not None and snap["kind"] == "full":
                tree = snap["trees"][j]
                tensors = iter(tree[str(i)] for i in range(len(tree)))
                states.append(map_state(lambda _, it=tensors, d=d: next(it).to(d),
                                        self._states[j]))
                continue
            fresh = init_state(b - a, self.statics.mask_hw, device=d,
                               rec=self._zero_rec(b - a, d))
            if snap is not None:
                fields = self._cheap_unpack(snap["trees"][j]["packed"])
                fresh = dataclasses.replace(fresh, **{k: v.to(d) for k, v in fields.items()})
            states.append(fresh)
        self._states = states

    # ---- observability -------------------------------------------------
    def stats(self) -> dict:
        """FPS / latency / thread-load counters, the passthrough steps
        served, health."""
        return {**self.counters.snapshot(), "passthrough_steps": self.passthrough_steps,
                "health": self.health.snapshot()}

    def stream_stats(self) -> list[dict]:
        """Per-stream counters: frames served, activity, face-tracking
        freshness."""
        idx = torch.cat([st.frame_idx.cpu() for st in self._states]).numpy()
        has_aff = torch.cat([st.has_affine.cpu() for st in self._states]).numpy()
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
