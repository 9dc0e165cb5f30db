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
  or (fast, matting_input='native') the u8 frames -> the bf16 plan-A
    MatteNetHD (5x5 stride-5 stem), and the guide as the frames' nearest
    u8 taps (guide_impl='nearest_u8');
  or packed u8 frames [S, H/b, W/b, b*b*3] -> int8 MatteNetHD (bf16 stem,
    trunk kernel, x4 upsample, sigmoid), and the planar u8 guide as lanes
    of the packed frames; with refine_alpha_src='lowres' the head-grid
    logits instead (the refine kernel upsamples them), with
    guide_kernel_unfold=True the guide's raw tap lanes (gathered here, or
    with guide_source='host' handed in beside the packed frames);
    -> face subpath, compacted to the <= K streams whose cadence fires,
       on the full-resolution frames (frame coordinates) or the guide
       (mask coordinates): letterbox -> FaceFinder -> best box -> prior
       (4 scalars or the rendered plane) -> ROI crop -> LandmarkNet ->
       Procrustes affine; or, face_tracking='translation', the detector
       on a plain resize of every stream's frame -> the box centre's
       delta as an integer translation
    -> the refine stages by :func:`refine_routing`: the fused temporal
       refine kernel (stages 3-9, the analytic or the plane prior); or
       the warp (separable or 2-D nearest), the blend ('lerp' or 'max')
       and the temporal filter ('ema', 'hole_fill', 'none') eager, then
       the fused refine kernel (5/7/8/9) where morphology is on, else the
       unfused chain (morphology, bilateral, threshold/gamma)
    -> natural: the fused composite kernel (use_fused_composite=True) or
       the upsample (planar products, or gathers with
       upsample_impl='gather') and blend; s2d: the packed composite; over each
       stream's image, one colour, or (background='blur') the frames
       blurred, by the plain upsample and blend
    -> affine low-pass with the face path's updates (translation: the
       update applied once, then identity)

make_range_step and make_round_step serve the scheduler's rotation: a
group of rows stepped out of the full state and written back in place,
the face min-interval gate on the card.
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
    temporal_ema,
)
from video_stream_segmenetation_tpu_torch.ops.warp import (
    warp_affine_nearest,
    warp_affine_separable,
)
from video_stream_segmenetation_tpu_torch.runtime.config import (
    EMA_ADAPT_T0,
    EMA_ADAPT_T1,
    PipelineKnobs,
    PipelineStatics,
)
from video_stream_segmenetation_tpu_torch.runtime.state import (
    IDENTITY_AFFINE,
    StreamState,
    map_state,
)

# (field, the only value the port serves) -- anything else is refused
_SERVED = (
    ("upsample_method", "half_pixel"),
    ("affine_mode", "exact"),
)
# ... by frame layout: the int8 MatteNetHD over packed frames, or the
# float models (MatteNet, RecurrentMatteNet, SaliencyNet over resized
# natural frames; the plan-A MatteNetHD over the natural frames themselves)
_SERVED_LAYOUT = {
    "s2d": (("matting_input", "native"), ("matting_precision", "int8"),
            ("matting_arch", "feedforward"), ("warp_impl", "separable"),
            ("upsample_precision", "fast"), ("face_tracking", "landmarks")),
    "natural": (("matting_precision", "bf16"),),
}
# ... the single-class step's bilateral guide (natural: _ALLOWED_NATURAL)
_SERVED_GUIDE = {"s2d": (("guide_impl", "nearest_u8"),), "natural": ()}
# ... with the face path on
_SERVED_FACE = {
    "s2d": (("face_compact", True), ("face_input", "guide"), ("crop_impl", "mxu"),
            ("resize_impl", "mxu")),
    "natural": (("face_compact", True), ("face_input", "frames"), ("crop_impl", "gather")),
}
# the multi-class step bypasses the single-matte stages and the face path
# (the reference's step never reads face_path): they stay at the
# reference's defaults; natural frames go to the K-class MatteNet resized
_SERVED_MULTICLASS = (
    ("background", "image"), ("matting_arch", "feedforward"),
    ("face_tracking", "landmarks"), ("temporal_filter", "ema"), ("warp_blend_mode", "lerp"),
    ("morphology", True), ("refine_alpha_src", "full"), ("guide_kernel_unfold", False),
    ("guide_source", "gather"),
)
_SERVED_MULTICLASS_LAYOUT = {
    "s2d": _SERVED_LAYOUT["s2d"],
    "natural": (("matting_input", "resized"), ("matting_precision", "bf16")),
}
# (field, the values the port serves)
_ALLOWED = (
    ("prior_impl", ("auto", "plane")),
    ("use_fused_composite", (False, True, "auto")),
    ("refined_dtype", ("f32", "bf16")),
    ("warp_impl", ("separable", "exact")),
    ("upsample_precision", ("fast", "exact")),
    ("upsample_impl", ("mxu", "gather")),
    ("preprocess_precision", ("fast", "exact")),
)
# the single-class step: the background, the fast refine's inputs ('auto'
# resolves as off the TPU), and the stage chain's options
_ALLOWED_SINGLE = (
    ("background", ("image", "color", "blur")),
    ("refine_alpha_src", ("full", "lowres", "auto")),
    ("guide_kernel_unfold", (False, True, "auto")),
    ("guide_source", ("gather", "host")),
    ("use_fused_refine", ("auto", True, False)),
    ("morphology", (True, False)),
    ("temporal_filter", ("ema", "hole_fill", "none")),
    ("warp_blend_mode", ("lerp", "max")),
    ("face_tracking", ("landmarks", "translation")),
    ("matting_arch", ("feedforward", "recurrent", "saliency")),
)
_ALLOWED_NATURAL = (
    ("matting_input", ("resized", "native")),
    ("resize_impl", ("gather", "mxu")),
    ("guide_impl", ("bilinear", "nearest_u8")),
)
_ALLOWED_S2D = (
    ("int8_conv_impl", ("xla", "pallas")),
    ("int8_head_impl", ("int8", "bf16")),
)
# the trunk plans the port serves, with one class and with K
_DECODERS = {False: ("pico", "nano", "femto", "micro", "light", "full"),
             True: ("pico", "nano")}


def _refuse(field, got, want, suffix=""):
    raise NotImplementedError(f"{field}={got!r}: the torch port serves {field}={want!r} "
                              f"only{suffix}")


# what the port has not ported yet, by the ROADMAP item that ports it:
# (field, the value refused, the condition, the item)
_UNPORTED = (
    ("face_models", "reference", lambda st: True,
     "the reference's MediaPipe face graphs: ROADMAP Queue 1 item 6"),
)


def check_statics(statics: PipelineStatics) -> None:
    """Refuse what the port's steps do not serve.  Still refused, besides
    :data:`_UNPORTED`: the s2d layout with another matting architecture,
    the exact warp or translation tracking; on the natural layout the
    native input (the plan-A MatteNetHD) with another architecture or a
    stem stride of 8 or more, and the guide as the face source; the face
    path without compaction; affine_mode='reference'; upsample methods but
    'half_pixel' (ROADMAP Queue 1 item 6)."""
    for field, value, when, item in _UNPORTED:
        if getattr(statics, field) == value and when(statics):
            raise NotImplementedError(f"{field}={value!r}: {item} is not ported yet")
    multiclass = statics.num_classes > 1
    layout = statics.frame_layout
    if layout not in _SERVED_LAYOUT:
        _refuse("frame_layout", layout, tuple(_SERVED_LAYOUT))
    if multiclass:
        served = _SERVED_MULTICLASS + _SERVED + _SERVED_MULTICLASS_LAYOUT[layout]
    else:
        served = (_SERVED + _SERVED_LAYOUT[layout] + _SERVED_GUIDE[layout]
                  + (_SERVED_FACE[layout] if statics.face_path else ()))
        if layout == "natural" and statics.matting_input == "native":
            # the plan-A float MatteNetHD (mattenet_hd.py:115-186)
            served += (("matting_arch", "feedforward"),)
            if statics.s2d_block >= 8:
                raise NotImplementedError(
                    f"s2d_block={statics.s2d_block}: the torch port serves the natural "
                    "layout's native input with plan A's stem stride (under 8) only")
    suffix = f" with num_classes={statics.num_classes}" if multiclass else ""
    for field, want in served:
        got = getattr(statics, field)
        if got != want or type(got) is not type(want):
            _refuse(field, got, want, suffix)
    allowed = _ALLOWED + ((("use_fused_refine", ("auto", True)),) if multiclass
                          else _ALLOWED_SINGLE)
    if layout == "s2d":
        allowed += (("matting_decoder", _DECODERS[multiclass]),) + _ALLOWED_S2D
    elif not multiclass:
        allowed += _ALLOWED_NATURAL
    if multiclass:
        if len(statics.class_effects) != statics.num_classes:
            raise ValueError(f"class_effects: {len(statics.class_effects)} effects for "
                             f"{statics.num_classes} classes")
        effect_algebra(statics.class_effects)
    for field, values in allowed:
        got = getattr(statics, field)
        if not any(got == v and type(got) is type(v) for v in values):
            _refuse(field, got, values)


@dataclasses.dataclass
class FaceModels:
    """The face subpath's two models (models/blazeface.py, facemesh.py)."""

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
    ``[K, mh, mw]``, zero where the detection failed (``'plane'``)."""
    mh, mw = statics.mask_hw
    fh, fw = statics.frame_hw
    fd_in = letterbox_to_square(frames_f32, (fh, fw), statics.fd_size, statics.resize_impl)
    det = models.face(fd_in)
    box, score, valid = best_box_decode(det["box_coords"], det["box_scores"], (fh, fw),
                                        statics.fd_size, letterboxed=True)
    det_ok = fire & valid & (score >= statics.face_score_thresh)
    if prior_form == "params":
        prior = face_prior_params(box, (fh, fw), (mh, mw))
    else:
        prior = torch.where(det_ok[:, None, None], face_prior_mask(box, (fh, fw), (mh, mw)),
                            torch.zeros((), device=box.device))
    roi = pad_box(box, statics.roi_pad, (fh, fw))
    crop = crop_and_resize if statics.crop_impl == "gather" else crop_and_resize_mxu
    roi_img = crop(frames_f32, roi, (statics.lmk_size, statics.lmk_size))
    lmk = models.lmk(roi_img)
    lmk_ok = det_ok & (lmk["scores"] >= statics.lmk_score_thresh)
    rw = (roi[:, 2] - roi[:, 0])[:, None]
    rh = (roi[:, 3] - roi[:, 1])[:, None]
    pts = torch.stack([lmk["landmarks"][..., 0] * rw + roi[:, 0:1],
                       lmk["landmarks"][..., 1] * rh + roi[:, 1:2]], dim=-1)
    affine_update = affine_from_landmarks(pts, (fh, fw), (mh, mw))
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


def face_subpath_compact(models: FaceModels, src_u8: torch.Tensor,
                         frame_idx: torch.Tensor, face_gate: torch.Tensor,
                         statics: PipelineStatics, prior_form: str = "params",
                         src_lanes_geom=None):
    """Cadence-compacted stage 6 on u8 images: the planar guide ``[S, 3,
    mh, mw]`` (``face_input='guide'``: the face path works in mask
    coordinates), or with ``src_lanes_geom=(fy, fx)`` the guide's tap lanes
    ``[nl, S, hp, wp]`` (gathered on the stream axis; only the gathered
    streams are reassembled), or the natural frames ``[S, H, W, 3]``
    (``face_input='frames'``: frame coordinates).  The streams whose
    cadence fires (``frame_idx % lmk_interval == 0`` and the engine's
    ``face_gate``) are gathered in u8, at most K = ``face_batch`` or
    ceil(S / lmk_interval) of them (overflow streams skip this round, as
    in the reference), converted to f32 0..1 and scattered back after.
    Returns what :func:`face_subpath` returns, for all S streams."""
    axis = 1 if src_lanes_geom else 0
    s = src_u8.shape[axis]
    planar = statics.face_input == "guide"
    fstat = dataclasses.replace(statics, frame_hw=statics.mask_hw) if planar else statics
    fire = ((frame_idx % statics.lmk_interval) == 0) & face_gate

    def to_f32(g):
        if src_lanes_geom:
            g = lanes_to_planar(g, src_lanes_geom)
        return (g.permute(0, 2, 3, 1) if planar else g).to(torch.float32) / 255.0

    k = statics.face_batch or max(1, -(-s // statics.lmk_interval))
    if k >= s:
        return face_subpath(models, to_f32(src_u8), fire, fstat, prior_form)
    idxs = first_k(fire, k)
    sel_valid = idxs < s
    f_sel = to_f32(torch.index_select(src_u8, axis, torch.clamp(idxs, max=s - 1)))
    outs = face_subpath(models, f_sel, sel_valid, fstat, prior_form)

    def scatter(v):  # row s takes the fill indices and is dropped
        full = torch.zeros((s + 1,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
        return full.index_copy_(0, idxs, v)[:s]

    return tuple(scatter(v) for v in outs)


def face_translation_subpath(face_model, frames_u8: torch.Tensor, state: StreamState,
                             statics: PipelineStatics, face_gate: torch.Tensor):
    """Translation-only tracking (the BlazeFace variant, runBlazeFace +
    warpTranslate, frameProcessor.ts:244-342,369-386; the reference's
    ``_face_translation_subpath``) on the natural frames ``[S, H, W, 3]``
    u8, every stream whose cadence fires (no compaction): the detector on
    a plain ``fd_size`` asymmetric resize (no letterbox), the best box's
    centre in mask coordinates (JS round and clamp), its delta against the
    previous centre times ``translation_gain``, truncated to an integer
    translation affine.  No landmarks, no prior.

    Returns (affine_update [S, 6], has_update [S], det_score [S],
    new_center [S, 2], new_has_center [S])."""
    s = frames_u8.shape[0]
    mh, mw = statics.mask_hw
    fh, fw = statics.frame_hw
    fire = ((state.frame_idx % statics.lmk_interval) == 0) & face_gate
    fd_in = resize_frames_u8(frames_u8, (statics.fd_size, statics.fd_size), "asymmetric")
    det = face_model(fd_in)
    box, score, det_valid = best_box_decode(det["box_coords"], det["box_scores"], (fh, fw),
                                            statics.fd_size, letterboxed=False)
    det_ok = fire & det_valid & (score >= statics.face_score_thresh)
    cx = torch.clamp(torch.floor((box[:, 0] + box[:, 2]) / 2 / fw * mw + 0.5), 0, mw - 1)
    cy = torch.clamp(torch.floor((box[:, 1] + box[:, 3]) / 2 / fh * mh + 0.5), 0, mh - 1)
    center = torch.stack([cx, cy], dim=-1)
    has_prev = det_ok & state.has_center
    delta = (center - state.face_center) * statics.translation_gain
    one = torch.ones((s,), dtype=torch.float32, device=frames_u8.device)
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
    m = torch.clamp((torch.amax(torch.abs(ca - prev), dim=-1, keepdim=True)
                     - EMA_ADAPT_T0) * (1.0 / (EMA_ADAPT_T1 - EMA_ADAPT_T0)), 0.0, 1.0)
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
    mw, K]``, ``det_score`` and ``face_applied`` (zeros)."""
    fh, fw = statics.frame_hw
    mh, mw = statics.mask_hw
    blk = statics.s2d_block
    s2d = statics.frame_layout == "s2d"

    def step(state: StreamState, frames, backgrounds, knobs: PipelineKnobs, face_gate):
        s = frames.shape[0]
        dev = frames.device
        if s2d:
            ca = model(frames)["alpha"]
        else:
            frames_f32 = frames.to(torch.float32) / 255.0
            ca = model(planar_resize_f32(frames_f32, (mh, mw)))["alpha"]
        ca = ca.to(torch.float32)  # [S, mh, mw, K]
        blended = simplex_ema(ca, state.rec[0], knobs, state.initialized)
        if s2d:
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
        outputs = {
            "frame": out_u8,
            "alpha": alpha,
            "class_alpha": blended,
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


def fast_routing(model, statics: PipelineStatics) -> dict:
    """The reference's build-time routing of the fast refine's inputs
    (runtime/pipeline.py:476-539): ``use_lowres_alpha``,
    ``use_guide_lanes``, ``lane_geom`` ((fy, fx) or None) and
    ``host_lanes``, each under the reference's conditions (on the fused
    temporal refine of :func:`refine_routing`, a feed-forward model), with
    what the port fixes: no stem-aux guide, no debug stages.  'auto'
    resolves as the reference resolves it off a TPU (its ``_on_tpu`` is
    False there): off."""
    fh, fw = statics.frame_hw
    mh, mw = statics.mask_hw
    blk = statics.s2d_block
    s2d = statics.frame_layout == "s2d"
    route = refine_routing(statics)
    feedforward = statics.matting_arch == "feedforward"
    analytic_prior = statics.num_classes == 1 and route["analytic_prior"]
    planar_guide = (route["use_fused_tr"] and s2d and statics.matting_input == "native"
                    and feedforward and statics.guide_impl == "nearest_u8"
                    and (not statics.face_path
                         or (statics.face_compact and statics.face_tracking != "translation")))
    use_lowres_alpha = bool(
        analytic_prior and feedforward and statics.matting_input == "native"
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
    :func:`make_multiclass_step`.

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
    threaded through ``StreamState.rec``), the float plan-A MatteNetHD
    (the u8 natural frames, ``matting_input='native'``) or the int8
    MatteNetHD, by ``statics.matting_arch``, the input and the layout.
    ``small`` is the frames resized to the mask (``resize_impl``: the
    gathers, or the interpolation products at ``preprocess_precision``);
    the natural guide is ``floor(small*255+0.5)``, or with the native
    input and ``guide_impl='nearest_u8'`` the frames' nearest taps.  The
    refine stages take the route of :func:`refine_routing`.

    With the fast refine's ``host_lanes`` on (:func:`fast_routing`), frames
    is a ``(packed, lanes [nl, S, hp, wp] u8)`` tuple."""
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
    refine_route = refine_routing(statics)
    use_fused, use_fused_tr = refine_route["use_fused"], refine_route["use_fused_tr"]
    prior_form = "params" if refine_route["analytic_prior"] else "plane"
    bg_mode = statics.background
    fused_comp = (natural and statics.use_fused_composite is True and bg_mode != "blur"
                  and fh % ROW_BLOCK == 0)
    out_dtype = torch.bfloat16 if statics.refined_dtype == "bf16" else torch.float32
    wb = statics.warp_blend_weight
    route = fast_routing(model, statics)
    lowres = route["use_lowres_alpha"]
    lane_geom = route["lane_geom"]
    host_lanes = route["host_lanes"]
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
            return alpha_composite_s2d(frames, a, bg, (fh, fw), blk)
        if fused_comp:
            bg = backgrounds if bg_mode == "image" else device_const(
                ("color_row", statics.bg_color, fh, fw), dev,
                lambda: np.ascontiguousarray(np.broadcast_to(
                    np.floor(np.asarray(statics.bg_color, np.float32) * np.float32(255.0)
                             + np.float32(0.5)).astype(np.uint8), (1, fh, fw, 3))))
            return fused_composite(frames, a, bg)
        nat = frames if natural else depth_to_space(frames, blk)
        if bg_mode == "blur":
            bg = gaussian_blur_auto(nat.to(torch.float32) / 255.0, statics.bg_blur_sigma)
        elif bg_mode == "color":
            bg = device_const(("color", statics.bg_color), dev,
                              lambda: np.asarray(statics.bg_color, np.float32))
        else:
            bg = backgrounds
        return natural_composite(nat, a, bg, bf16_pass=statics.upsample_precision == "fast",
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

    def step(state: StreamState, frames, backgrounds, knobs: PipelineKnobs, face_gate):
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
            # lowres: the head-grid logits; the refine kernel upsamples them
            alpha_raw = (model(frames, lowres=True)["alpha_logit_lr"] if lowres
                         else model(frames)["alpha"])
            if lane_geom is None:
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
        if translation:
            (affine_update, has_update, det_score, new_center,
             new_has_center) = face_translation_subpath(face_models.face, frames, state,
                                                        statics, face_gate)
            prior = zero_prior()
            has_prior = torch.zeros((s,), dtype=torch.bool, device=dev)
        elif statics.face_path:
            prior, has_prior, affine_update, has_update, det_score = face_subpath_compact(
                face_models, frames if natural else guide, state.frame_idx, face_gate,
                statics, prior_form, src_lanes_geom=lane_geom)
            prior = prior.contiguous()
        else:
            prior = zero_prior()
            has_prior = torch.zeros((s,), dtype=torch.bool, device=dev)
            affine_update = torch.zeros((s, 6), dtype=torch.float32, device=dev)
            has_update = torch.zeros((s,), dtype=torch.bool, device=dev)
            det_score = torch.zeros((s,), dtype=torch.float32, device=dev)

        use_warp = state.has_affine & state.initialized
        if not use_fused_tr:
            new_prev, a = unfused(state, alpha_raw, guide, prior, has_prior, knobs)
        elif lowres or lane_geom is not None:
            new_prev, a = fused_temporal_refine_fast(
                alpha_raw, state.prev_alpha, state.affine, use_warp, state.initialized, wb,
                guide, prior, has_prior, knobs, out_dtype=out_dtype,
                alpha_lowres_hw=(mh, mw) if lowres else None, guide_lanes_geom=lane_geom)
        else:
            refine = fused_temporal_refine if prior_form == "params" \
                else fused_temporal_refine_plane
            new_prev, a = refine(alpha_raw, state.prev_alpha, state.affine, use_warp,
                                 state.initialized, wb, guide, prior, has_prior, knobs,
                                 out_dtype=out_dtype)
        out_u8 = composite(frames, a, backgrounds)
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
    them (a ``(packed, lanes)`` tuple with host lanes)."""
    step = make_step(model, statics, face_models)

    def range_step(full_state: StreamState, i0: int, frames, full_bgs, full_knobs,
                   face_last, now, min_interval, gs: int):
        rows = slice(i0, i0 + gs)
        gstate = rows_of(full_state, rows)
        gbgs = full_bgs if full_bgs.shape[0] == 1 else full_bgs[rows]
        last_g = face_last[rows]
        face_gate = (now - last_g) >= min_interval
        new_g, out = step(gstate, frames, gbgs, rows_of(full_knobs, rows), face_gate)
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
