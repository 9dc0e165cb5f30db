"""The per-batch serving steps (port of ``runtime/pipeline.py::make_step``):
the single-class step of ``active`` (the natural layout) and of the
``fast_int8``, ``fast_int8_lite``, ``fast_int8_pico`` and
``fast_int8_micro`` presets (the s2d layout), face path on or off, and the
multi-class step of ``multiclass_fast_pico`` and ``multiclass_fast``
(:func:`make_multiclass_step`).  The single-class step:

  natural u8 frames [S, H, W, 3] -> f32 0..1 and the asymmetric gather
    resize to the mask -> bf16 MatteNet, and the planar u8 guide
    floor(small*255+0.5);
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
       Procrustes affine
    -> warp_impl='separable': the fused temporal refine kernel (stages
       3-9, the analytic or the plane prior); 'exact' (natural): the 2-D
       nearest warp and the EMA, then the fused refine kernel (5/7/8/9)
    -> natural: the fused composite kernel (use_fused_composite=True) or
       the planar upsample and blend; s2d: the packed composite
    -> affine low-pass with the face path's updates

make_range_step and make_round_step serve the scheduler's rotation: a
group of rows stepped out of the full state and written back in place,
the face min-interval gate on the card.
"""

from __future__ import annotations

import dataclasses

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
from video_stream_segmenetation_tpu_torch.ops.composite import natural_composite
from video_stream_segmenetation_tpu_torch.ops.detect import best_box_decode
from video_stream_segmenetation_tpu_torch.ops.geometry import (
    affine_from_landmarks,
    letterbox_params,
    pad_box,
)
from video_stream_segmenetation_tpu_torch.ops.layout import (
    alpha_composite_s2d,
    effect_algebra,
    guide_from_s2d,
    guide_lanes_s2d,
    guide_s2d_sel,
    lanes_to_planar,
    multiclass_composite_s2d,
)
from video_stream_segmenetation_tpu_torch.ops.prior import face_prior_mask, face_prior_params
from video_stream_segmenetation_tpu_torch.ops.resize import (
    crop_and_resize,
    crop_and_resize_mxu,
    resize_bilinear,
    resize_bilinear_mxu,
    resize_frames_u8,
)
from video_stream_segmenetation_tpu_torch.ops.temporal import affine_lowpass, temporal_ema
from video_stream_segmenetation_tpu_torch.ops.warp import warp_affine_nearest
from video_stream_segmenetation_tpu_torch.runtime.config import (
    EMA_ADAPT_T0,
    EMA_ADAPT_T1,
    PipelineKnobs,
    PipelineStatics,
)
from video_stream_segmenetation_tpu_torch.runtime.state import StreamState

# (field, the only value the port serves) -- anything else is refused
_SERVED = (
    ("upsample_method", "half_pixel"),
    ("background", "image"),
    ("face_tracking", "landmarks"),
    ("affine_mode", "exact"),
    ("temporal_filter", "ema"),
    ("warp_blend_mode", "lerp"),
    ("morphology", True),
    ("upsample_impl", "mxu"),
)
# ... by frame layout: the int8 MatteNetHD over packed frames, or the
# float MatteNet over resized natural frames
_SERVED_LAYOUT = {
    "s2d": (("matting_input", "native"), ("matting_precision", "int8"),
            ("warp_impl", "separable"), ("upsample_precision", "fast")),
    "natural": (("matting_input", "resized"), ("matting_precision", "bf16"),
                ("resize_impl", "gather"), ("refined_dtype", "f32")),
}
# ... the single-class step's bilateral guide
_SERVED_GUIDE = {"s2d": ("guide_impl", "nearest_u8"), "natural": ("guide_impl", "bilinear")}
# ... and, with the face path on
_SERVED_FACE = {
    "s2d": (("face_compact", True), ("face_input", "guide"), ("crop_impl", "mxu"),
            ("resize_impl", "mxu")),
    "natural": (("face_compact", True), ("face_input", "frames"), ("crop_impl", "gather")),
}
# (field, the values the port serves)
_ALLOWED = (
    ("prior_impl", ("auto", "plane")),
    ("use_fused_refine", ("auto", True)),
    ("use_fused_composite", (False, True, "auto")),
    ("refined_dtype", ("f32", "bf16")),
    ("warp_impl", ("separable", "exact")),
    ("upsample_precision", ("fast", "exact")),
)
# the fast refine's inputs (single class); 'auto' resolves as off the TPU
_ALLOWED_FAST = (
    ("refine_alpha_src", ("full", "lowres", "auto")),
    ("guide_kernel_unfold", (False, True, "auto")),
    ("guide_source", ("gather", "host")),
)
_ALLOWED_S2D = (
    ("int8_conv_impl", ("xla", "pallas")),
    ("int8_head_impl", ("int8", "bf16")),
)


def _refuse(field, got, want, suffix=""):
    raise NotImplementedError(f"{field}={got!r}: the torch port serves {field}={want!r} "
                              f"only{suffix}")


def check_statics(statics: PipelineStatics) -> None:
    """Refuse what the port's steps do not serve."""
    multiclass = statics.num_classes > 1
    layout = statics.frame_layout
    if multiclass:
        served = ((("frame_layout", "s2d"), ("face_path", False)) + _SERVED
                  + _SERVED_LAYOUT["s2d"] + (("refine_alpha_src", "full"),
                                             ("guide_kernel_unfold", False),
                                             ("guide_source", "gather")))
    elif layout not in _SERVED_LAYOUT:
        _refuse("frame_layout", layout, tuple(_SERVED_LAYOUT))
    else:
        served = (_SERVED + _SERVED_LAYOUT[layout] + (_SERVED_GUIDE[layout],)
                  + (_SERVED_FACE[layout] if statics.face_path else ()))
    suffix = f" with num_classes={statics.num_classes}" if multiclass else ""
    for field, want in served:
        got = getattr(statics, field)
        if got != want or type(got) is not type(want):
            _refuse(field, got, want, suffix)
    allowed = _ALLOWED if multiclass else _ALLOWED + _ALLOWED_FAST
    if layout == "s2d":
        decoders = ("pico", "nano") if multiclass else ("pico", "micro", "light", "full")
        allowed += (("matting_decoder", decoders),) + _ALLOWED_S2D
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


def make_multiclass_step(model, statics: PipelineStatics):
    """The multi-class step (BASELINE config 5; the s2d branch of the
    reference's ``make_multiclass_step``): K-class softmax maps -> the
    motion-adaptive EMA on the class simplex, renormalised -> the packed
    per-class composite.  The single-matte stages (morphology, prior,
    bilateral, face path) are bypassed, as in the reference.  Same
    signature as :func:`make_step`'s step; ``outputs``: ``frame`` (packed
    u8), ``alpha`` (class 1's map ``[S, mh, mw]``, as the reference),
    ``class_alpha`` ``[S, mh, mw, K]``, ``det_score`` and ``face_applied``
    (zeros)."""
    fh, fw = statics.frame_hw
    blk = statics.s2d_block

    def step(state: StreamState, frames_p, backgrounds_p, knobs: PipelineKnobs,
             face_gate):
        s = frames_p.shape[0]
        dev = frames_p.device
        ca = model(frames_p)["alpha"].to(torch.float32)  # [S, mh, mw, K]
        blended = simplex_ema(ca, state.rec, knobs, state.initialized)
        out_u8 = multiclass_composite_s2d(frames_p, blended, statics.class_effects,
                                          (fh, fw), blk, method=statics.upsample_method)
        # class 1 alone, as the reference keeps it
        alpha = blended[..., 1:2].sum(-1)
        new_state = dataclasses.replace(
            state,
            prev_alpha=alpha,
            initialized=torch.ones_like(state.initialized),
            frame_idx=state.frame_idx + 1,
            rec=blended,
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


def fast_routing(model, statics: PipelineStatics) -> dict:
    """The reference's build-time routing of the fast refine's inputs
    (runtime/pipeline.py:476-539): ``use_lowres_alpha``,
    ``use_guide_lanes``, ``lane_geom`` ((fy, fx) or None) and
    ``host_lanes``, each under the reference's conditions, with what the
    port fixes: the fused refine on (the port refuses
    ``use_fused_refine=False``), a feed-forward matting model, no stem-aux
    guide, no debug stages.  'auto' resolves as the reference resolves it
    off a TPU (its ``_on_tpu`` is False there): off."""
    fh, fw = statics.frame_hw
    mh, mw = statics.mask_hw
    blk = statics.s2d_block
    s2d = statics.frame_layout == "s2d"
    use_fused_tr = statics.num_classes == 1 and statics.warp_impl == "separable"
    analytic_prior = use_fused_tr and statics.prior_impl != "plane"
    planar_guide = (use_fused_tr and s2d and statics.matting_input == "native"
                    and statics.guide_impl == "nearest_u8"
                    and (not statics.face_path
                         or (statics.face_compact and statics.face_tracking != "translation")))
    use_lowres_alpha = bool(
        analytic_prior and statics.matting_input == "native"
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


def make_step(model, statics: PipelineStatics, face_models: FaceModels | None = None):
    """step(state, frames, backgrounds, knobs, face_gate) -> (new_state,
    outputs); with ``statics.num_classes > 1`` the step of
    :func:`make_multiclass_step`.

    frames: natural ``[S, H, W, 3]`` u8 (the float MatteNet) or packed
    ``[S, H/b, W/b, b*b*3]`` u8 (the int8 MatteNetHD), by
    ``statics.frame_layout``; backgrounds in the same layout, ``[S, ...]``
    or one row to broadcast; face_gate ``[S]`` bool (the engine's
    min-interval gate).  ``outputs``: ``frame`` (u8, the frames' layout),
    ``alpha`` (``[S, mh, mw]``, bf16 or f32 by ``refined_dtype``; f32 on
    the exact-warp route), ``det_score``, ``face_applied``,
    ``face_has_prior``, and with the prior as scalars (``prior_impl='auto'``
    on the separable route) ``face_prior_params``, as the reference's step
    exports them (its plane routes export ``face_has_prior`` only with
    ``debug_face_outputs``; here it is a free view of the step's own
    tensor).

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
    exact_warp = statics.warp_impl == "exact"
    # the reference's routing (runtime/pipeline.py:476-487, 835-843)
    prior_form = "plane" if exact_warp or statics.prior_impl == "plane" else "params"
    fused_comp = natural and statics.use_fused_composite is True and fh % ROW_BLOCK == 0
    out_dtype = torch.bfloat16 if statics.refined_dtype == "bf16" else torch.float32
    wb = statics.warp_blend_weight
    route = fast_routing(model, statics)
    lowres = route["use_lowres_alpha"]
    lane_geom = route["lane_geom"]
    host_lanes = route["host_lanes"]

    def step(state: StreamState, frames, backgrounds, knobs: PipelineKnobs, face_gate):
        lanes = None
        if host_lanes:
            frames, lanes = frames
        s = frames.shape[0]
        dev = frames.device
        if natural:
            small = resize_frames_u8(frames, (mh, mw), "asymmetric")
            alpha_raw = model(small)["alpha"]
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
        if statics.face_path:
            prior, has_prior, affine_update, has_update, det_score = face_subpath_compact(
                face_models, frames if natural else guide, state.frame_idx, face_gate,
                statics, prior_form, src_lanes_geom=lane_geom)
            prior = prior.contiguous()
        else:
            prior = torch.zeros((s, 4) if prior_form == "params" else (s, mh, mw),
                                dtype=torch.float32, device=dev)
            has_prior = torch.zeros((s,), dtype=torch.bool, device=dev)
            affine_update = torch.zeros((s, 6), dtype=torch.float32, device=dev)
            has_update = torch.zeros((s,), dtype=torch.bool, device=dev)
            det_score = torch.zeros((s,), dtype=torch.float32, device=dev)

        use_warp = state.has_affine & state.initialized
        if exact_warp:
            warped = warp_affine_nearest(state.prev_alpha, state.affine)
            base = torch.where(use_warp[:, None, None], warped * wb + alpha_raw * (1 - wb),
                               alpha_raw)
            new_prev, a = temporal_ema(state.prev_alpha, base, knobs.ema, state.initialized,
                                       adapt=knobs.ema_adapt)
            a = fused_refine(a.contiguous(), guide, prior, has_prior, knobs)
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
        if not natural:
            out_u8 = alpha_composite_s2d(frames, a, backgrounds, (fh, fw), blk)
        elif fused_comp:
            out_u8 = fused_composite(frames, a, backgrounds)
        else:
            out_u8 = natural_composite(frames, a, backgrounds,
                                       bf16_pass=statics.upsample_precision == "fast")
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
    """A StreamState or PipelineKnobs of the rows ``rows`` of ``tree``, as
    views into its tensors."""
    return type(tree)(**{f.name: getattr(tree, f.name)[rows]
                         for f in dataclasses.fields(tree)})


def write_rows(group: StreamState, new: StreamState) -> None:
    """Copy a group step's new state into the group's views of the full
    state, in place (fields the step passed through unchanged are the
    views themselves)."""
    for f in dataclasses.fields(group):
        dst, src = getattr(group, f.name), getattr(new, f.name)
        if src is not dst:
            dst.copy_(src)


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
