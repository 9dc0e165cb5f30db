"""The per-batch serving steps (port of ``runtime/pipeline.py::make_step``):
the single-class step of ``active``, ``fast`` and ``active``'s variants
``blaze_tracking``, ``branch``, ``rvm`` and ``u2`` (the natural layout) and
of the ``fast_int8``, ``fast_int8_lite``, ``fast_int8_pico``,
``fast_int8_nano``, ``fast_int8_femto`` and ``fast_int8_micro`` presets (the
s2d layout), face path on or off, and the multi-class step of
``multiclass`` (natural), ``multiclass_fast_pico`` and ``multiclass_fast``
(:func:`make_multiclass_step`).  The single-class step:

  natural u8 frames [S, H, W, 3] -> f32 0..1 and the asymmetric resize to
    the mask (gathers, or interpolation products with resize_impl='mxu')
    -> bf16 MatteNet, SaliencyNet or RecurrentMatteNet (its ConvGRU state
    in StreamState.rec), and the planar u8 guide floor(small*255+0.5);
  or (fast, matting_input='native') the u8 frames -> the bf16 float
    MatteNetHD of the plan the stem stride and decoder pick (plan A's 5x5
    stride-5 stem, or plans B, C, D), and the guide as the frames' nearest
    u8 taps (guide_impl='nearest_u8');
  or packed u8 frames [S, H/b, W/b, b*b*3] -> the int8 MatteNetHD (bf16
    stem, trunk kernel, x4 upsample, sigmoid) or, matting_precision=
    'bf16', the float one (its stem one product over the packed lanes),
    and the planar u8 guide as lanes of the packed frames (guide_impl=
    'bilinear': the unpacked frames' resize); with refine_alpha_src='lowres' the head-grid
    logits instead (the refine kernel upsamples them), with
    guide_kernel_unfold=True the guide's raw tap lanes (gathered here, or
    with guide_source='host' handed in beside the packed frames);
    -> face subpath on the full-resolution frames (frame coordinates;
       on s2d the packed frames unpacked where they are read) or the
       guide (mask coordinates), compacted to the <= K streams whose
       cadence fires (face_compact=False: all S, gated): letterbox ->
       FaceFinder -> best box -> prior (4 scalars or the rendered plane)
       -> ROI crop -> LandmarkNet -> Procrustes affine (affine_mode
       'exact' or the reference client's); the models bf16, int8
       (face_precision='int8') or the reference application's MediaPipe
       graphs (face_models='reference'); or, face_tracking='translation',
       the detector on a plain resize of every firing stream's source ->
       the box centre's delta as an integer translation
    -> the refine stages by :func:`refine_routing`: the fused temporal
       refine kernel (stages 3-9, the analytic or the plane prior); or
       the warp (separable or 2-D nearest), the blend ('lerp' or 'max')
       and the temporal filter ('ema', 'hole_fill', 'none') eager, then
       the fused refine kernel (5/7/8/9) where morphology is on, else the
       unfused chain (morphology, bilateral, threshold/gamma)
    -> natural: the fused composite kernel (use_fused_composite=True) or
       the upsample (planar products, or gathers with
       upsample_impl='gather') and blend; s2d: the packed composite
       (bf16 products, or f32 with upsample_precision='exact'); each at
       upsample_method's taps; over each
       stream's image, one colour, or (background='blur') the frames
       blurred, by the plain upsample and blend
    -> affine low-pass with the face path's updates (translation: the
       update applied once, then identity)

make_range_step serves the scheduler's rotation (the Engine's rounds, a
range step a group), make_round_step the rollouts' rounds: a group of
rows stepped out of the full state and written back in place, the face
min-interval gate on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from video_stream_segmenetation_tpu_torch.kernels.composite_fused import (
    ROW_BLOCK,
    fused_composite,
)
from video_stream_segmenetation_tpu_torch.kernels.refine_fused import (
    fused_refine,
    fused_temporal_refine,
    fused_temporal_refine_fast,
    fused_temporal_refine_plane,
)
from video_stream_segmenetation_tpu_torch.ops.blur import gaussian_blur_auto
from video_stream_segmenetation_tpu_torch.ops.composite import (
    multiclass_composite,
    natural_composite,
)
from video_stream_segmenetation_tpu_torch.ops.consts import device_const
from video_stream_segmenetation_tpu_torch.ops.detect import best_box_decode
from video_stream_segmenetation_tpu_torch.ops.geometry import (
    affine_from_landmarks,
    letterbox_params,
    pad_box,
)
from video_stream_segmenetation_tpu_torch.ops.layout import (
    alpha_composite_s2d,
    depth_to_space,
    effect_algebra,
    guide_from_s2d,
    guide_lanes_s2d,
    guide_s2d_sel,
    lanes_to_planar,
    multiclass_composite_s2d,
    packed_color,
)
from video_stream_segmenetation_tpu_torch.ops.prior import face_prior_mask, face_prior_params
from video_stream_segmenetation_tpu_torch.ops.resize import (
    crop_and_resize,
    crop_and_resize_mxu,
    resize_bilinear,
    resize_bilinear_mxu,
    resize_frames_u8,
    resize_nearest,
)
from video_stream_segmenetation_tpu_torch.ops.bilateral import joint_bilateral3x3
from video_stream_segmenetation_tpu_torch.ops.morphology import (
    morphological_closing_in_prior,
    morphological_opening,
)
from video_stream_segmenetation_tpu_torch.ops.refine import refine_alpha
from video_stream_segmenetation_tpu_torch.ops.temporal import (
    affine_lowpass,
    hole_filling_ema,
    motion_gate,
    temporal_ema,
)
from video_stream_segmenetation_tpu_torch.ops.warp import (
    warp_affine_nearest,
    warp_affine_separable,
)
from video_stream_segmenetation_tpu_torch.parallel.mesh import exclusive_prefix
from video_stream_segmenetation_tpu_torch.runtime.config import (
    DEBUG_TOKENS,
    PipelineKnobs,
    PipelineStatics,
    debug_tokens,
)
from video_stream_segmenetation_tpu_torch.runtime.state import (
    IDENTITY_AFFINE,
    StreamState,
    map_state,
)

# (field, the values the port serves, where the row holds) -- one table;
# every value the reference has is served unless a row below pins it.
# Where: None every statics, else a predicate of _WHERE.
_ALLOWED = (
    ("frame_layout", ("s2d", "natural"), None),
    # the s2d layout feeds the packed frames to a MatteNetHD (the
    # reference raises without the native input, runtime/pipeline.py:
    # 444-451; its Engine builds a MatteNet, RVM or U2Net on no layout but
    # the natural one)
    ("matting_input", ("native",), "s2d"),
    ("matting_arch", ("feedforward",), "s2d"),
    # the natural layout's models are float (its int8 graph is
    # MatteNetHD's alone)
    ("matting_precision", ("bf16",), "natural"),
    # the native input on the natural layout is the float MatteNetHD
    ("matting_arch", ("feedforward",), "natural native"),
    # K classes: the reference's Engine makes the recurrent state for
    # matting_arch='recurrent' (service/engine.py:145) and hands
    # guide_source='host' steps a (packed, lanes) tuple (:222-236), which
    # its multi-class step does not take; its natural multi-class step
    # feeds the MatteNetHD the mask-size resize, whose alpha is off the
    # mask grid (it fails at the first step: "sub got incompatible shapes
    # for broadcasting")
    ("matting_arch", ("feedforward",), "multi-class"),
    ("guide_source", ("gather",), "multi-class"),
    ("matting_input", ("resized",), "natural multi-class"),
    ("matting_input", ("resized", "native"), None),
    ("matting_precision", ("int8", "bf16"), None),
    ("matting_arch", ("feedforward", "recurrent", "saliency"), None),
    ("matting_decoder", ("pico", "nano", "femto", "micro", "light", "full"), None),
    ("upsample_method", ("half_pixel", "asymmetric", "align_corners"), None),
    ("upsample_precision", ("fast", "exact"), None),
    ("upsample_impl", ("mxu", "gather"), None),
    ("warp_impl", ("separable", "exact"), None),
    ("guide_impl", ("bilinear", "nearest_u8"), None),
    ("prior_impl", ("auto", "plane"), None),
    ("use_fused_composite", (False, True, "auto"), None),
    ("use_fused_refine", ("auto", True, False), None),
    ("refined_dtype", ("f32", "bf16"), None),
    ("preprocess_precision", ("fast", "exact"), None),
    ("resize_impl", ("gather", "mxu"), None),
    ("affine_mode", ("exact", "reference"), None),
    ("face_models", ("fast", "reference"), None),
    ("face_precision", ("bf16", "int8"), None),
    ("int8_conv_impl", ("xla", "pallas"), None),
    ("int8_head_impl", ("int8", "bf16"), None),
    # the single-class step's stages; the multi-class step and the
    # reference's Engine never read these with K classes, so there they
    # are served and ignored, as face_path is
    ("background", ("image", "color", "blur"), None),
    ("refine_alpha_src", ("full", "lowres", "auto"), None),
    ("guide_kernel_unfold", (False, True, "auto"), None),
    ("guide_source", ("gather", "host"), None),
    ("morphology", (True, False), None),
    ("temporal_filter", ("ema", "hole_fill", "none"), None),
    ("warp_blend_mode", ("lerp", "max"), None),
    ("face_tracking", ("landmarks", "translation"), None),
    ("face_compact", (True, False), None),
    ("face_input", ("frames", "guide"), None),
    ("crop_impl", ("gather", "mxu"), None),
)
_WHERE = {
    None: lambda st: True,
    "s2d": lambda st: st.frame_layout == "s2d",
    "natural": lambda st: st.frame_layout == "natural",
    "natural native": lambda st: (st.frame_layout == "natural"
                                  and st.matting_input == "native" and st.num_classes == 1),
    "multi-class": lambda st: st.num_classes > 1,
    "natural multi-class": lambda st: st.frame_layout == "natural" and st.num_classes > 1,
}


def _refuse(field, got, want, suffix=""):
    raise NotImplementedError(f"{field}={got!r}: the torch port serves {field}={want!r} "
                              f"only{suffix}")


def check_statics(statics: PipelineStatics) -> None:
    """Refuse what the port's steps do not serve (the rows of
    ``_ALLOWED``, in order): the s2d layout with another input or matting
    architecture; the natural layout's int8 precision; with K classes the
    recurrent and saliency models, host guide lanes and the natural
    layout's native input; and every value the reference does not have.
    A one-value row names its value (with K classes, and the class count),
    other rows the tuple of values.  Every ``debug_stage`` token must be
    one of ``DEBUG_TOKENS``: a typo must not time the full step."""
    unknown = sorted(debug_tokens(statics) - set(DEBUG_TOKENS))
    if unknown:
        raise ValueError(f"debug_stage={statics.debug_stage!r}: unknown token "
                         f"{unknown[0]!r}; the tokens are {DEBUG_TOKENS}")
    multiclass = statics.num_classes > 1
    suffix = f" with num_classes={statics.num_classes}" if multiclass else ""
    if multiclass:
        if len(statics.class_effects) != statics.num_classes:
            raise ValueError(f"class_effects: {len(statics.class_effects)} effects for "
                             f"{statics.num_classes} classes")
        effect_algebra(statics.class_effects)
    for field, values, where in _ALLOWED:
        if not _WHERE[where](statics):
            continue
        got = getattr(statics, field)
        if not any(got == v and type(got) is type(v) for v in values):
            one = len(values) == 1
            _refuse(field, got, values[0] if one else values, suffix if one else "")


@dataclasses.dataclass
class FaceModels:
    """The face subpath's two models: the FaceFinder and LandmarkNet of
    models/blazeface.py and facemesh.py, their int8 forms
    (models/quantized_face.py) or the MediaPipe graphs
    (models/reference_face.py)."""

    face: torch.nn.Module
    lmk: torch.nn.Module


def letterbox_to_square(frames: torch.Tensor, frame_hw, target: int,
                        impl: str = "mxu") -> torch.Tensor:
    """Fit-resize (half-pixel bilinear: the two-tap gathers with
    ``impl='gather'``, the interpolation products with ``'mxu'``)
    ``[S, h, w, 3]`` into a ``target`` square and pad with black
    (toSquareLetterbox)."""
    _, dw, dh, off_x, off_y = letterbox_params(frame_hw, target)
    resize = resize_bilinear if impl == "gather" else resize_bilinear_mxu
    small = resize(frames, (dh, dw), method="half_pixel")
    return F.pad(small, (0, 0, off_x, target - dw - off_x, off_y, target - dh - off_y))


def face_subpath(models: FaceModels, frames_f32: torch.Tensor, fire: torch.Tensor,
                 statics: PipelineStatics, prior_form: str = "params"):
    """Stage 6 on ``frames_f32 [K, h, w, 3]`` (0..1; ``statics.frame_hw`` is
    their size): detector -> prior -> ROI -> landmarks -> affine.
    ``fire [K]`` gates the streams.  Returns (prior, has_prior,
    affine_update ``[K, 6]``, has_update, det_score): the prior as its 4
    scalars ``[K, 4]`` (``prior_form='params'``) or as the rendered plane
    ``[K, mh, mw]``, zero where the detection failed (``'plane'``).

    The bench-only ``debug_stage`` tokens cut it short (the reference's
    runtime/pipeline.py:112-158): ``fd_stub`` a fixed box and score in
    place of the detector's forward (plus an epsilon of the letterbox, so
    that it still runs), ``fd_only`` the detector alone (no prior, no
    update), ``no_lmk`` the detector and the prior (no update)."""
    mh, mw = statics.mask_hw
    fh, fw = statics.frame_hw
    k = frames_f32.shape[0]
    dev = frames_f32.device
    debug = debug_tokens(statics)
    fd_in = letterbox_to_square(frames_f32, (fh, fw), statics.fd_size, statics.resize_impl)
    if "fd_stub" in debug:
        eps = torch.sum(fd_in.to(torch.float32)) * 1e-20
        # a device constant: a copy from the host would wait for the card
        box = device_const(("fd_stub_box", fh, fw), dev, lambda: np.asarray(
            [fw * 0.3, fh * 0.2, fw * 0.7, fh * 0.8], np.float32)).expand(k, 4) + eps
        score = torch.full((k,), 0.9, dtype=torch.float32, device=dev) + eps
        valid = torch.ones((k,), dtype=torch.bool, device=dev)
    else:
        det = models.face(fd_in)
        box, score, valid = best_box_decode(det["box_coords"], det["box_scores"], (fh, fw),
                                            statics.fd_size, letterboxed=True)
    det_ok = fire & valid & (score >= statics.face_score_thresh)
    no_update = torch.zeros((k, 6), dtype=torch.float32, device=dev)
    if "fd_only" in debug:
        zero_prior = torch.zeros((k, 4) if prior_form == "params" else (k, mh, mw),
                                 dtype=torch.float32, device=dev)
        return (zero_prior, det_ok & False, no_update, det_ok & False,
                torch.where(fire, score, 0.0))
    if prior_form == "params":
        prior = face_prior_params(box, (fh, fw), (mh, mw))
    else:
        prior = torch.where(det_ok[:, None, None], face_prior_mask(box, (fh, fw), (mh, mw)),
                            torch.zeros((), device=box.device))
    if "no_lmk" in debug:
        return prior, det_ok, no_update, det_ok & False, torch.where(fire, score, 0.0)
    roi = pad_box(box, statics.roi_pad, (fh, fw))
    crop = crop_and_resize if statics.crop_impl == "gather" else crop_and_resize_mxu
    roi_img = crop(frames_f32, roi, (statics.lmk_size, statics.lmk_size))
    lmk = models.lmk(roi_img)
    lmk_ok = det_ok & (lmk["scores"] >= statics.lmk_score_thresh)
    rw = (roi[:, 2] - roi[:, 0])[:, None]
    rh = (roi[:, 3] - roi[:, 1])[:, None]
    pts = torch.stack([lmk["landmarks"][..., 0] * rw + roi[:, 0:1],
                       lmk["landmarks"][..., 1] * rh + roi[:, 1:2]], dim=-1)
    affine_update = affine_from_landmarks(pts, (fh, fw), (mh, mw), statics.affine_mode)
    return prior, det_ok, affine_update, lmk_ok, torch.where(fire, score, 0.0)


def first_k(fire: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the first ``k`` True entries of ``fire [S]``, padded with
    S (``jnp.where(fire, size=k, fill_value=S)``), without a host sync."""
    s = fire.shape[0]
    pos = torch.cumsum(fire.to(torch.int64), 0) - 1
    slot = torch.where(fire & (pos < k), pos, torch.full_like(pos, k))
    idxs = torch.full((k + 1,), s, dtype=torch.int64, device=fire.device)
    idxs.scatter_(0, slot, torch.arange(s, device=fire.device))  # slot k: dropped
    return idxs[:k]


def face_image(src: torch.Tensor, planar: bool = False, s2d_block=None,
               lanes_geom=None) -> torch.Tensor:
    """A face source as ``[S, h, w, 3]`` images in its own dtype: the
    guide's tap lanes ``[nl, S, hp, wp]`` reassembled (``lanes_geom``), the
    packed frames unpacked (``s2d_block``), a planar ``[S, 3, h, w]`` guide
    made channel-last (``planar``); natural images as they are."""
    if lanes_geom:
        src = lanes_to_planar(src, lanes_geom)
    if s2d_block:
        src = depth_to_space(src, s2d_block)
    return src.permute(0, 2, 3, 1) if planar or lanes_geom else src


def face_f32(src: torch.Tensor, planar: bool = False, s2d_block=None,
             lanes_geom=None) -> torch.Tensor:
    """:func:`face_image` in f32 0..1 (u8 divided by 255)."""
    img = face_image(src, planar, s2d_block, lanes_geom)
    return img.to(torch.float32) / 255.0 if img.dtype == torch.uint8 else img.to(torch.float32)


def face_statics(statics: PipelineStatics) -> PipelineStatics:
    """The statics the face subpath works in: with ``face_input='guide'``
    its source is the mask-resolution guide, so ``frame_hw := mask_hw``."""
    if statics.face_input == "guide":
        return dataclasses.replace(statics, frame_hw=statics.mask_hw)
    return statics


@dataclasses.dataclass
class FaceSel:
    """A shard's part in a cadence selection made over more rows than its
    own: ``k`` (the batch's or group's K), ``rows`` (that batch's or group's
    row count) and ``rank0`` (a scalar tensor on the shard's device: how
    many rows fired in the shards before it)."""

    k: int
    rows: int
    rank0: torch.Tensor


def face_fire(frame_idx: torch.Tensor, face_gate: torch.Tensor,
              statics: PipelineStatics) -> torch.Tensor:
    """The streams whose face cadence fires: ``frame_idx % lmk_interval ==
    0`` where the engine's min-interval gate is open."""
    return ((frame_idx % statics.lmk_interval) == 0) & face_gate


def face_k(statics: PipelineStatics, rows: int) -> int:
    """K, the most streams the compacted face path takes from ``rows``:
    ``face_batch``, or ceil(rows / lmk_interval)."""
    return statics.face_batch or max(1, -(-rows // statics.lmk_interval))


def compacts_faces(statics: PipelineStatics) -> bool:
    """Whether the step's face path is the cadence-compacted one (the one
    whose selection spans the batch)."""
    return bool(statics.num_classes == 1 and statics.face_path and statics.face_compact
                and statics.face_tracking != "translation")


def face_selections(statics: PipelineStatics, frame_idxs: list, gates: list,
                    rows: int) -> list:
    """Each shard's :class:`FaceSel` of a batch or group of ``rows`` rows
    split over shards (``frame_idxs`` and ``gates``: each shard's rows, on
    its device, in slot order), so that the shards together take the
    streams one step over all the rows takes: the first K fired in slot
    order.  The only cross-device traffic is one int64 scalar a shard
    (parallel/mesh.py::exclusive_prefix).  None where the step does not
    compact its face path, or for one shard (its own rows are the batch's,
    so its own selection is the batch's)."""
    if len(gates) == 1 or not compacts_faces(statics):
        return [None] * len(gates)
    counts = [face_fire(fi, g, statics).sum() for fi, g in zip(frame_idxs, gates)]
    k = face_k(statics, rows)
    return [FaceSel(k, rows, r) for r in
            exclusive_prefix(counts, [g.device for g in gates])]


def face_subpath_compact(models: FaceModels, src: torch.Tensor,
                         frame_idx: torch.Tensor, face_gate: torch.Tensor,
                         statics: PipelineStatics, prior_form: str = "params",
                         src_lanes_geom=None, src_planar=None, s2d_block=None,
                         sel: FaceSel | None = None):
    """Cadence-compacted stage 6 (the reference's ``_face_subpath_compact``)
    on a face source: the planar u8 guide ``[S, 3, mh, mw]``
    (``src_planar``, by default ``face_input='guide'``), its tap lanes
    ``[nl, S, hp, wp]`` (``src_lanes_geom=(fy, fx)``: gathered on the
    stream axis, and only the gathered streams are reassembled), a
    channel-last guide ``[S, mh, mw, 3]`` (u8, or the f32 resize of the
    natural layout), the natural frames ``[S, H, W, 3]``, or the packed
    frames (``s2d_block``: only the gathered streams are unpacked); with
    ``face_input='guide'`` the face path works in mask coordinates.  The
    streams whose cadence fires (``frame_idx % lmk_interval == 0`` and the
    engine's ``face_gate``) are gathered, at most K = ``face_batch`` or
    ceil(S / lmk_interval) of them (overflow streams skip this round, as in
    the reference), converted to f32 0..1 and scattered back after.
    Returns what :func:`face_subpath` returns, for all S streams.

    ``sel``: these S rows are one shard's part of a batch or group the
    selection spans (:func:`face_selections`): K and the choice between
    compaction and all rows are the whole batch's, and the shard takes its
    fired rows whose rank in the batch (``sel.rank0`` plus the rank here)
    is under K, at most min(K, S) of them (a static size: no host
    synchronisation)."""
    axis = 1 if src_lanes_geom else 0
    s = src.shape[axis]
    planar = statics.face_input == "guide" if src_planar is None else src_planar
    fstat = face_statics(statics)
    fire = face_fire(frame_idx, face_gate, statics)

    def to_f32(g):
        return face_f32(g, planar, s2d_block, src_lanes_geom)

    k = face_k(statics, s) if sel is None else sel.k
    if k >= (s if sel is None else sel.rows):
        return face_subpath(models, to_f32(src), fire, fstat, prior_form)
    if sel is not None:
        rank = sel.rank0 + torch.cumsum(fire.to(torch.int64), 0) - 1
        fire = fire & (rank < k)
        k = min(k, s)
    idxs = first_k(fire, k)
    sel_valid = idxs < s
    f_sel = to_f32(torch.index_select(src, axis, torch.clamp(idxs, max=s - 1)))
    outs = face_subpath(models, f_sel, sel_valid, fstat, prior_form)

    def scatter(v):  # row s takes the fill indices and is dropped
        full = torch.zeros((s + 1,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
        return full.index_copy_(0, idxs, v)[:s]

    return tuple(scatter(v) for v in outs)


def face_translation_subpath(face_model, frames: torch.Tensor, state: StreamState,
                             statics: PipelineStatics, face_gate: torch.Tensor):
    """Translation-only tracking (the BlazeFace variant, runBlazeFace +
    warpTranslate, frameProcessor.ts:244-342,369-386; the reference's
    ``_face_translation_subpath``) on ``frames [S, h, w, 3]`` (u8, or f32
    0..1; ``statics.frame_hw`` is their size), every stream whose cadence
    fires (no compaction): the detector on a plain ``fd_size`` asymmetric
    resize (no letterbox), the best box's centre in mask coordinates (JS
    round and clamp), its delta against the previous centre times
    ``translation_gain``, truncated to an integer translation affine.  No
    landmarks, no prior.

    Returns (affine_update [S, 6], has_update [S], det_score [S],
    new_center [S, 2], new_has_center [S])."""
    s = frames.shape[0]
    mh, mw = statics.mask_hw
    fh, fw = statics.frame_hw
    fire = ((state.frame_idx % statics.lmk_interval) == 0) & face_gate
    fd_hw = (statics.fd_size, statics.fd_size)
    fd_in = (resize_frames_u8(frames, fd_hw, "asymmetric") if frames.dtype == torch.uint8
             else resize_bilinear(frames.to(torch.float32), fd_hw, method="asymmetric"))
    det = face_model(fd_in)
    box, score, det_valid = best_box_decode(det["box_coords"], det["box_scores"], (fh, fw),
                                            statics.fd_size, letterboxed=False)
    det_ok = fire & det_valid & (score >= statics.face_score_thresh)
    cx = torch.clamp(torch.floor((box[:, 0] + box[:, 2]) / 2 / fw * mw + 0.5), 0, mw - 1)
    cy = torch.clamp(torch.floor((box[:, 1] + box[:, 3]) / 2 / fh * mh + 0.5), 0, mh - 1)
    center = torch.stack([cx, cy], dim=-1)
    has_prev = det_ok & state.has_center
    delta = (center - state.face_center) * statics.translation_gain
    one = torch.ones((s,), dtype=torch.float32, device=frames.device)
    zero = torch.zeros_like(one)
    affine_update = torch.stack([one, zero, torch.trunc(delta[:, 0]), zero, one,
                                 torch.trunc(delta[:, 1])], dim=-1)
    new_center = torch.where(det_ok[:, None], center, state.face_center)
    return (affine_update, has_prev, torch.where(fire, score, 0.0), new_center,
            state.has_center | det_ok)


def simplex_ema(ca: torch.Tensor, prev: torch.Tensor, knobs: PipelineKnobs,
                initialized: torch.Tensor) -> torch.Tensor:
    """The motion-adaptive EMA of the class maps ``ca [S, h, w, K]`` against
    the previous blend ``prev``, renormalised onto the simplex: the EMA
    weight shrinks where the maps moved (m: the largest class change, so
    a hand-off between classes counts as motion); a stream not yet
    initialized takes ``ca``."""
    kk = knobs.ema[:, None, None, None]
    ad = knobs.ema_adapt[:, None, None, None]
    m = motion_gate(torch.amax(torch.abs(ca - prev), dim=-1, keepdim=True))
    ke = kk * (1.0 - ad * m)
    blended = torch.where(initialized[:, None, None, None], ke * prev + (1 - ke) * ca, ca)
    return blended / torch.clamp(blended.sum(-1, keepdim=True), min=1e-6)


def planar_resize_f32(frames_f32: torch.Tensor, mask_hw) -> torch.Tensor:
    """The natural multi-class step's resize (runtime/pipeline.py:353-363):
    each channel of ``frames_f32 [S, H, W, 3]`` by the asymmetric
    interpolation products in f32 (the reference's HIGHEST), stacked."""
    return torch.stack([resize_bilinear_mxu(frames_f32[..., c], tuple(mask_hw), "asymmetric",
                                            channel_last=False) for c in range(3)], dim=-1)


def make_multiclass_step(model, statics: PipelineStatics):
    """The multi-class step (BASELINE config 5; the reference's
    ``make_multiclass_step``): K-class softmax maps -> the motion-adaptive
    EMA on the class simplex, renormalised -> the per-class composite.  The
    s2d branch feeds the packed frames to the int8 K-class MatteNetHD and
    composites in the packed layout; the natural branch resizes the f32
    frames to the mask one channel at a time (asymmetric interpolation
    products in f32, the reference's HIGHEST), runs the K-class MatteNet
    and composites the f32 frames (:func:`multiclass_composite`).  The
    single-matte stages (morphology, prior, bilateral, face path) are
    bypassed, as in the reference.  Same signature as :func:`make_step`'s
    step; ``outputs``: ``frame`` (u8, the frames' layout), ``alpha`` (class
    1's map ``[S, mh, mw]``, as the reference), ``class_alpha`` ``[S, mh,
    mw, K]``, ``det_score`` and ``face_applied`` (zeros).  ``debug_stage``:
    ``model_only`` takes the raw class maps (no EMA, no renormalisation),
    ``no_composite`` passes the frames through (the reference's
    runtime/pipeline.py:374-402)."""
    fh, fw = statics.frame_hw
    mh, mw = statics.mask_hw
    blk = statics.s2d_block
    s2d = statics.frame_layout == "s2d"
    debug = debug_tokens(statics)

    def step(state: StreamState, frames, backgrounds, knobs: PipelineKnobs, face_gate,
             face_sel=None):
        s = frames.shape[0]
        dev = frames.device
        if s2d:
            ca = model(frames)["alpha"]
        else:
            frames_f32 = frames.to(torch.float32) / 255.0
            ca = model(planar_resize_f32(frames_f32, (mh, mw)))["alpha"]
        ca = ca.to(torch.float32)  # [S, mh, mw, K]
        blended = (ca if "model_only" in debug
                   else simplex_ema(ca, state.rec[0], knobs, state.initialized))
        if "no_composite" in debug:
            out_u8 = frames
        elif s2d:
            out_u8 = multiclass_composite_s2d(frames, blended, statics.class_effects, (fh, fw),
                                              blk, method=statics.upsample_method)
        else:
            out_u8 = multiclass_composite(frames_f32, blended, statics.class_effects,
                                          upsample_method=statics.upsample_method, out_u8=True)
        # class 1 alone, as the reference keeps it
        alpha = blended[..., 1:2].sum(-1)
        new_state = dataclasses.replace(
            state,
            prev_alpha=alpha,
            initialized=torch.ones_like(state.initialized),
            frame_idx=state.frame_idx + 1,
            rec=(blended,),
        )
        # the outputs are copies: the state's tensors are written in place
        # by a later admission or eviction (runtime/state.py::reset_streams),
        # which must not rewrite a step's results once returned
        outputs = {
            "frame": out_u8,
            "alpha": alpha.clone(),
            "class_alpha": blended.clone(),
            "det_score": torch.zeros((s,), dtype=torch.float32, device=dev),
            "face_applied": torch.zeros((s,), dtype=torch.bool, device=dev),
        }
        return new_state, outputs

    return step


def refine_routing(statics: PipelineStatics) -> dict:
    """The reference's build-time routing of the refine stages
    (runtime/pipeline.py:472-481, 740-830): ``use_fused`` (the refine
    kernels: ``use_fused_refine``, 'auto' served as on, and morphology
    on), ``use_fused_tr`` (stages 3-9 in one kernel: the separable warp,
    the EMA and the lerp blend besides), ``analytic_prior`` (the prior as
    4 scalars, on that kernel only).  Otherwise the warp, the blend and
    the temporal filter run eager, then ``fused_refine`` where
    ``use_fused``, else the unfused stage chain."""
    use_fused = statics.use_fused_refine in ("auto", True) and statics.morphology is True
    use_fused_tr = (use_fused and statics.warp_impl == "separable"
                    and statics.temporal_filter == "ema" and statics.warp_blend_mode == "lerp")
    return {"use_fused": use_fused, "use_fused_tr": use_fused_tr,
            "analytic_prior": use_fused_tr and statics.prior_impl != "plane"}


def planar_guide_route(statics: PipelineStatics) -> bool:
    """The reference's ``planar_guide`` (runtime/pipeline.py:488-498): the
    fused temporal refine takes the planar u8 guide of the packed frames
    (or its tap lanes), which nothing else of the step needs."""
    return bool(refine_routing(statics)["use_fused_tr"] and statics.frame_layout == "s2d"
                and statics.matting_input == "native"
                and statics.matting_arch == "feedforward"
                and statics.guide_impl == "nearest_u8"
                and (not statics.face_path
                     or (statics.face_compact and statics.face_tracking != "translation")))


def fast_routing(model, statics: PipelineStatics) -> dict:
    """The reference's build-time routing of the fast refine's inputs
    (runtime/pipeline.py:476-539): ``use_lowres_alpha``,
    ``use_guide_lanes``, ``lane_geom`` ((fy, fx) or None) and
    ``host_lanes``, each under the reference's conditions (on the fused
    temporal refine of :func:`refine_routing`, a feed-forward model, the
    low-res alpha not under ``debug_stage='model_only'``), with what the
    port fixes: no stem-aux guide.  'auto' resolves as the reference
    resolves it off a TPU (its ``_on_tpu`` is False there): off."""
    fh, fw = statics.frame_hw
    mh, mw = statics.mask_hw
    blk = statics.s2d_block
    feedforward = statics.matting_arch == "feedforward"
    analytic_prior = statics.num_classes == 1 and refine_routing(statics)["analytic_prior"]
    planar_guide = planar_guide_route(statics)
    use_lowres_alpha = bool(
        analytic_prior and feedforward and statics.matting_input == "native"
        and "model_only" not in debug_tokens(statics)
        and getattr(model, "supports_lowres_alpha", False)
        and getattr(model, "head_upsample", 1) > 1
        and statics.refine_alpha_src == "lowres")
    use_guide_lanes = bool(
        planar_guide and analytic_prior and statics.guide_kernel_unfold is True
        and guide_s2d_sel((fh, fw), (mh, mw), blk) is not None)
    lane_geom = (mh // (fh // blk), mw // (fw // blk)) if use_guide_lanes else None
    return {"use_lowres_alpha": use_lowres_alpha, "use_guide_lanes": use_guide_lanes,
            "lane_geom": lane_geom,
            "host_lanes": use_guide_lanes and statics.guide_source == "host"}


def warp_blend(state: StreamState, alpha_raw: torch.Tensor,
               statics: PipelineStatics) -> torch.Tensor:
    """Stage 3 off the fused kernel: the previous alpha warped by the
    stream's affine (``warp_impl``: the separable or the 2-D nearest warp)
    and blended with the model's alpha (``warp_blend_mode``: ``wb *
    warped + (1 - wb) * alpha`` or ``max(alpha, warped * wb)``) where the
    stream has an affine and is initialized; elsewhere the model's alpha."""
    wb = statics.warp_blend_weight
    warp = warp_affine_separable if statics.warp_impl == "separable" else warp_affine_nearest
    warped = warp(state.prev_alpha, state.affine)
    if statics.warp_blend_mode == "max":
        blended = torch.maximum(alpha_raw, warped * wb)
    else:
        blended = warped * wb + alpha_raw * (1 - wb)
    use_warp = (state.has_affine & state.initialized)[:, None, None]
    return torch.where(use_warp, blended, alpha_raw)


def temporal_filter(state: StreamState, base: torch.Tensor, knobs: PipelineKnobs,
                    statics: PipelineStatics):
    """Stage 4 off the fused kernel, by ``temporal_filter``: the
    motion-adaptive EMA, the hole-filling EMA, or none (the base passed
    through).  Returns (new_prev, alpha)."""
    if statics.temporal_filter == "none":
        return base, base
    if statics.temporal_filter == "hole_fill":
        return hole_filling_ema(state.prev_alpha, base, knobs.ema, state.initialized)
    return temporal_ema(state.prev_alpha, base, knobs.ema, state.initialized,
                        adapt=knobs.ema_adapt)


def refine_chain(a: torch.Tensor, guide: torch.Tensor, prior: torch.Tensor,
                 has_prior: torch.Tensor, knobs: PipelineKnobs,
                 statics: PipelineStatics) -> torch.Tensor:
    """Stages 5/7/8/9 unfused: opening and prior-gated closing (with
    morphology), the joint bilateral under its per-stream toggle, the
    threshold/gamma refine with the plane prior."""
    if statics.morphology:
        a = morphological_opening(a)
        a = morphological_closing_in_prior(a, prior, has_prior)
    a_bi = joint_bilateral3x3(a, guide, knobs.sigma_spatial, knobs.sigma_range)
    a = torch.where(knobs.use_bilateral[:, None, None], a_bi, a)
    return refine_alpha(a, knobs.noise_cutoff, knobs.high_threshold, knobs.gamma, prior,
                        has_prior)


def make_step(model, statics: PipelineStatics, face_models: FaceModels | None = None):
    """step(state, frames, backgrounds, knobs, face_gate) -> (new_state,
    outputs); with ``statics.num_classes > 1`` the step of
    :func:`make_multiclass_step`.  ``face_sel`` (a keyword, :class:`FaceSel`):
    the batch is one shard's part of a larger one, whose cadence selection
    the face path follows (:func:`face_subpath_compact`).

    frames: natural ``[S, H, W, 3]`` u8 (the float models) or packed
    ``[S, H/b, W/b, b*b*3]`` u8 (the int8 MatteNetHD), by
    ``statics.frame_layout``; backgrounds in the same layout, ``[S, ...]``
    or one row to broadcast; face_gate ``[S]`` bool (the engine's
    min-interval gate).  ``outputs``: ``frame`` (u8, the frames' layout),
    ``alpha`` (``[S, mh, mw]``, bf16 or f32 by ``refined_dtype`` on the
    fused temporal refine, f32 elsewhere), ``det_score``,
    ``face_applied``, ``face_has_prior``, and with the prior as scalars
    (the fused temporal refine, ``prior_impl='auto'``)
    ``face_prior_params``, as the reference's step exports them (its plane
    routes export ``face_has_prior`` only with ``debug_face_outputs``;
    here it is a free view of the step's own tensor).

    ``model``: the MatteNet or SaliencyNet (``small -> {"alpha"}``), the
    RecurrentMatteNet (``(small, rec) -> {"alpha", "state"}``, the state
    threaded through ``StreamState.rec``), the float MatteNetHD (the u8
    natural or packed frames, ``matting_input='native'``) or the int8
    MatteNetHD, by ``statics.matting_arch``, the input, the layout and
    ``statics.matting_precision``.
    ``small`` is the frames resized to the mask (``resize_impl``: the
    gathers, or the interpolation products at ``preprocess_precision``);
    the natural guide is ``floor(small*255+0.5)``, or with the native
    input and ``guide_impl='nearest_u8'`` the frames' nearest taps.  The
    refine stages take the route of :func:`refine_routing`.

    With the fast refine's ``host_lanes`` on (:func:`fast_routing`), frames
    is a ``(packed, lanes [nl, S, hp, wp] u8)`` tuple.

    ``debug_stage`` (bench-only, the reference's runtime/pipeline.py:
    737-846): ``model_only`` serves the model's alpha f32 as it is (no
    warp, EMA or refine; it is also the new prev_alpha), ``no_morph`` and
    ``no_bilateral`` reach the fused temporal refine's variants,
    ``no_guide`` hands that kernel a zero guide of its input's shape (the
    planar guide or the tap lanes) where the packed frames' guide feeds
    nothing but the kernel (the guide is then not built unless the face
    path reads it), ``no_composite`` passes the frames through; the face
    tokens act in :func:`face_subpath`."""
    check_statics(statics)
    if statics.num_classes > 1:
        return make_multiclass_step(model, statics)
    if statics.face_path and face_models is None:
        raise ValueError("make_step: the face path needs face_models")
    mh, mw = statics.mask_hw
    fh, fw = statics.frame_hw
    blk = statics.s2d_block
    natural = statics.frame_layout == "natural"
    native = statics.matting_input == "native"
    recurrent = statics.matting_arch == "recurrent"
    translation = statics.face_path and statics.face_tracking == "translation"
    face_guide = statics.face_input == "guide"
    fstat = face_statics(statics)
    refine_route = refine_routing(statics)
    use_fused, use_fused_tr = refine_route["use_fused"], refine_route["use_fused_tr"]
    prior_form = "params" if refine_route["analytic_prior"] else "plane"
    bg_mode = statics.background
    method = statics.upsample_method
    fused_comp = (natural and statics.use_fused_composite is True and bg_mode != "blur"
                  and fh % ROW_BLOCK == 0)
    out_dtype = torch.bfloat16 if statics.refined_dtype == "bf16" else torch.float32
    wb = statics.warp_blend_weight
    route = fast_routing(model, statics)
    lowres = route["use_lowres_alpha"]
    lane_geom = route["lane_geom"]
    host_lanes = route["host_lanes"]
    debug = debug_tokens(statics)
    model_only = "model_only" in debug
    kdebug = tuple(t for t in ("no_morph", "no_bilateral") if t in debug)
    no_guide = "no_guide" in debug and planar_guide_route(statics)
    # the guide is not built at all where only the kernel reads it
    skip_guide = no_guide and not (statics.face_path and face_guide)
    if statics.resize_impl == "mxu":
        bf16_pre = statics.preprocess_precision == "fast"

        def resize_down(f):  # the reference's _resize_down (runtime/pipeline.py:455-465)
            return resize_bilinear_mxu(f.to(torch.float32) / 255.0, (mh, mw), "asymmetric",
                                       bf16_pass=bf16_pre)
    else:
        def resize_down(f):
            return resize_frames_u8(f, (mh, mw), "asymmetric")

    def composite(frames, a, backgrounds):
        """The reference's stage 10 (runtime/pipeline.py:836-937), each
        route with its own rounding of the colour: s2d packed (the colour
        as one packed u8 patch), the composite kernel (u8 frames and
        background: the colour as one u8 row), the plain upsample and
        blend (float background: the colour unrounded, the blurred natural
        frames; s2d frames with 'blur' come out natural, as the
        reference's do)."""
        dev = frames.device
        if not natural and bg_mode != "blur":
            bg = backgrounds if bg_mode == "image" else device_const(
                ("packed_color", statics.bg_color, blk), dev,
                lambda: packed_color(statics.bg_color, blk))
            return alpha_composite_s2d(frames, a, bg, (fh, fw), blk, method=method,
                                       precision=statics.upsample_precision)
        if fused_comp:
            bg = backgrounds if bg_mode == "image" else device_const(
                ("color_row", statics.bg_color, fh, fw), dev,
                lambda: np.ascontiguousarray(np.broadcast_to(
                    np.floor(np.asarray(statics.bg_color, np.float32) * np.float32(255.0)
                             + np.float32(0.5)).astype(np.uint8), (1, fh, fw, 3))))
            return fused_composite(frames, a, bg, method=method)
        nat = frames if natural else depth_to_space(frames, blk)
        if bg_mode == "blur":
            bg = gaussian_blur_auto(nat.to(torch.float32) / 255.0, statics.bg_blur_sigma)
        elif bg_mode == "color":
            bg = device_const(("color", statics.bg_color), dev,
                              lambda: np.asarray(statics.bg_color, np.float32))
        else:
            bg = backgrounds
        return natural_composite(nat, a, bg, method=method,
                                 bf16_pass=statics.upsample_precision == "fast",
                                 impl=statics.upsample_impl)

    def unfused(state, alpha_raw, guide, prior, has_prior, knobs):
        """Stages 3-9 off the fused temporal refine (runtime/pipeline.py:
        774-830): :func:`warp_blend` and :func:`temporal_filter`, then
        ``fused_refine`` where ``use_fused``, else :func:`refine_chain`."""
        base = warp_blend(state, alpha_raw, statics)
        new_prev, a = temporal_filter(state, base, knobs, statics)
        if use_fused:
            return new_prev, fused_refine(a.contiguous(), guide, prior, has_prior, knobs)
        return new_prev, refine_chain(a, guide, prior, has_prior, knobs, statics)

    def step(state: StreamState, frames, backgrounds, knobs: PipelineKnobs, face_gate,
             face_sel: FaceSel | None = None):
        lanes = None
        if host_lanes:
            frames, lanes = frames
        s = frames.shape[0]
        dev = frames.device
        new_rec = state.rec
        if natural:
            small = None
            if native:
                # the plan-A MatteNetHD on the u8 frames: its stem is the resize
                out_m = model(frames)
                if statics.guide_impl == "nearest_u8":
                    # floor((g/255)*255+0.5) of the reference is g itself
                    guide = resize_nearest(frames, (mh, mw), "half_pixel")
                else:
                    small = resize_down(frames)
            else:
                small = resize_down(frames)
                # RVM-class stateful matting: the ConvGRU state in rec
                out_m = model(small, state.rec) if recurrent else model(small)
                new_rec = out_m["state"] if recurrent else new_rec
            alpha_raw = out_m["alpha"]
            if small is not None:
                # u8-valued guide (the reference's canvas data): exact in u8
                guide = torch.floor(small * 255.0 + 0.5).to(torch.uint8)
            guide = guide.permute(0, 3, 1, 2).contiguous()
        else:
            small = None
            # lowres: the head-grid logits; the refine kernel upsamples them
            alpha_raw = (model(frames, lowres=True)["alpha_logit_lr"] if lowres
                         else model(frames)["alpha"])
            if statics.guide_impl == "bilinear":
                # the reference resizes the unpacked frames (its frames_nat)
                small = resize_down(depth_to_space(frames, blk))
                guide = torch.floor(small * 255.0 + 0.5).to(torch.uint8).permute(0, 3, 1, 2)
            elif skip_guide and lanes is None:
                fy, fx = lane_geom or (1, 1)
                guide = torch.zeros((3 * fy * fx, s, mh // fy, mw // fx) if lane_geom
                                    else (s, 3, mh, mw), dtype=torch.uint8, device=dev)
            elif lane_geom is None:
                guide = guide_from_s2d(frames, (fh, fw), (mh, mw), blk)
            elif lanes is None:
                guide = guide_lanes_s2d(frames, (fh, fw), (mh, mw), blk)[0]
            else:
                guide = lanes
            guide = guide.contiguous()
        alpha_raw = alpha_raw.to(torch.float32).contiguous()
        new_center, new_has_center = state.face_center, state.has_center
        zero_prior = (lambda: torch.zeros((s, 4) if prior_form == "params" else (s, mh, mw),
                                          dtype=torch.float32, device=dev))
        if statics.face_path:
            # the face source (the reference's runtime/pipeline.py:660-690):
            # the frames (s2d: packed, unpacked where they are read), or the
            # guide: the natural layout's f32 resize where there is one,
            # else the planar u8 guide or its tap lanes
            if not face_guide:
                src, planar, src_blk, geom = frames, False, None if natural else blk, None
            elif small is not None:
                src, planar, src_blk, geom = small, False, None, None
            else:
                src, planar, src_blk, geom = guide, True, None, lane_geom
        if translation:
            (affine_update, has_update, det_score, new_center,
             new_has_center) = face_translation_subpath(
                face_models.face, face_image(src, planar, src_blk, geom), state, fstat,
                face_gate)
            prior = zero_prior()
            has_prior = torch.zeros((s,), dtype=torch.bool, device=dev)
        elif statics.face_path and statics.face_compact:
            prior, has_prior, affine_update, has_update, det_score = face_subpath_compact(
                face_models, src, state.frame_idx, face_gate, statics, prior_form,
                src_lanes_geom=geom, src_planar=planar, s2d_block=src_blk, sel=face_sel)
            prior = prior.contiguous()
        elif statics.face_path:
            fire = face_fire(state.frame_idx, face_gate, statics)
            prior, has_prior, affine_update, has_update, det_score = face_subpath(
                face_models, face_f32(src, planar, src_blk, geom), fire, fstat, prior_form)
            prior = prior.contiguous()
        else:
            prior = zero_prior()
            has_prior = torch.zeros((s,), dtype=torch.bool, device=dev)
            affine_update = torch.zeros((s, 6), dtype=torch.float32, device=dev)
            has_update = torch.zeros((s,), dtype=torch.bool, device=dev)
            det_score = torch.zeros((s,), dtype=torch.float32, device=dev)

        use_warp = state.has_affine & state.initialized
        kguide = guide
        if no_guide and (guide is lanes or not skip_guide):
            kguide = torch.zeros_like(guide)
        if model_only:
            # the output a copy: the state's tensor is written in place later
            new_prev, a = alpha_raw, alpha_raw.clone()
        elif not use_fused_tr:
            new_prev, a = unfused(state, alpha_raw, guide, prior, has_prior, knobs)
        elif lowres or lane_geom is not None:
            new_prev, a = fused_temporal_refine_fast(
                alpha_raw, state.prev_alpha, state.affine, use_warp, state.initialized, wb,
                kguide, prior, has_prior, knobs, out_dtype=out_dtype,
                alpha_lowres_hw=(mh, mw) if lowres else None, guide_lanes_geom=lane_geom,
                debug=kdebug)
        else:
            refine = fused_temporal_refine if prior_form == "params" \
                else fused_temporal_refine_plane
            new_prev, a = refine(alpha_raw, state.prev_alpha, state.affine, use_warp,
                                 state.initialized, wb, kguide, prior, has_prior, knobs,
                                 out_dtype=out_dtype, debug=kdebug)
        out_u8 = frames if "no_composite" in debug else composite(frames, a, backgrounds)
        if statics.face_tracking == "translation":
            # a per-frame displacement, applied once, then identity
            # (frameProcessor.ts:375-384)
            ident = device_const(("identity_affine",), dev,
                                 lambda: np.asarray(IDENTITY_AFFINE, np.float32))
            new_affine = torch.where(has_update[:, None], affine_update, ident)
            new_has_affine = has_update
        else:
            new_affine, new_has_affine = affine_lowpass(
                state.affine, affine_update, statics.warp_gain, state.has_affine,
                has_update,
            )
        new_state = dataclasses.replace(
            state,
            prev_alpha=new_prev,
            affine=new_affine,
            has_affine=new_has_affine,
            initialized=torch.ones_like(state.initialized),
            frame_idx=state.frame_idx + 1,
            rec=new_rec,
            face_center=new_center,
            has_center=new_has_center,
        )
        outputs = {
            "frame": out_u8,
            "alpha": a,
            "det_score": det_score,
            "face_applied": has_update,
            "face_has_prior": has_prior,
        }
        if prior_form == "params":
            outputs["face_prior_params"] = prior
        return new_state, outputs

    return step


def rows_of(tree, rows: slice):
    """A StreamState (``rec``'s tensors included) or PipelineKnobs of the
    rows ``rows`` of ``tree``, as views into its tensors."""
    if isinstance(tree, StreamState):
        return map_state(lambda t: t[rows], tree)
    return type(tree)(**{f.name: getattr(tree, f.name)[rows]
                         for f in dataclasses.fields(tree)})


def write_rows(group: StreamState, new: StreamState) -> None:
    """Copy a group step's new state into the group's views of the full
    state, in place (tensors the step passed through unchanged are the
    views themselves)."""
    def copy(dst, src):
        if src is not dst:
            dst.copy_(src)

    map_state(copy, group, new)


def make_range_step(model, statics: PipelineStatics, face_models: FaceModels | None = None):
    """The group step of the scheduler's rotation (the reference's
    ``make_range_step``): ``range_step(full_state, i0, frames, full_bgs,
    full_knobs, face_last, now, min_interval, gs) -> (full_state,
    face_last, outputs)``.

    Rows ``[i0, i0+gs)`` of the full state, knobs and backgrounds (one
    background row is broadcast) are sliced out as views, stepped, and the
    new rows are written back in place into the full state's tensors; no
    other row is read or written.  The face clock ``face_last [S]`` f32
    (seconds since the engine's epoch of each stream's last applied face
    round) and the scalars ``now`` and ``min_interval`` are tensors on the
    step's device: the gate compare and the applied-scatter run there, and
    the step reads nothing back to the host.  ``frames`` as the step takes
    them (a ``(packed, lanes)`` tuple with host lanes); ``face_sel`` as
    :func:`make_step`'s."""
    step = make_step(model, statics, face_models)

    def range_step(full_state: StreamState, i0: int, frames, full_bgs, full_knobs,
                   face_last, now, min_interval, gs: int, face_sel=None):
        rows = slice(i0, i0 + gs)
        gstate = rows_of(full_state, rows)
        gbgs = full_bgs if full_bgs.shape[0] == 1 else full_bgs[rows]
        last_g = face_last[rows]
        face_gate = (now - last_g) >= min_interval
        kw = {} if face_sel is None else {"face_sel": face_sel}
        new_g, out = step(gstate, frames, gbgs, rows_of(full_knobs, rows), face_gate, **kw)
        write_rows(gstate, new_g)
        last_g.copy_(torch.where(out["face_applied"], now, last_g))
        return full_state, face_last, out

    return range_step


def make_round_step(model, statics: PipelineStatics, group_sizes,
                    face_models: FaceModels | None = None):
    """One whole rotation round (the reference's ``make_round_step``): every
    group's range step over the full state, at the schedule's offsets, in
    order.  ``round_step(full_state, frames_list, full_bgs, full_knobs,
    face_last, now, min_interval) -> (full_state, face_last, [outputs a
    group])``.  The round shares one knob snapshot and one ``now``."""
    rstep = make_range_step(model, statics, face_models)
    sizes = [int(g) for g in group_sizes]
    offs = [0]
    for g in sizes:
        offs.append(offs[-1] + g)

    def round_step(full_state, frames_list, full_bgs, full_knobs, face_last, now,
                   min_interval):
        outs = []
        for g, gs in enumerate(sizes):
            full_state, face_last, out = rstep(full_state, offs[g], frames_list[g], full_bgs,
                                               full_knobs, face_last, now, min_interval, gs)
            outs.append(out)
        return full_state, face_last, outs

    return round_step


def segment_once(model, statics: PipelineStatics):
    """Single-shot ``segment(frames) -> mask`` (the reference's
    ``segment_once``): ``seg(frames_u8 [S, H, W, 3]) -> alpha [S, mh, mw]
    f32``, the frames over 255 resized to the mask (asymmetric taps) and
    the model's alpha; no temporal state, no refine."""

    def seg(frames_u8: torch.Tensor) -> torch.Tensor:
        small = resize_frames_u8(frames_u8, tuple(statics.mask_hw), "asymmetric")
        return model(small)["alpha"].to(torch.float32)

    return seg
