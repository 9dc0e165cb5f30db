"""The per-batch serving steps (port of ``runtime/pipeline.py::make_step``):
the single-class step of the ``fast_int8``, ``fast_int8_lite``,
``fast_int8_pico`` and ``fast_int8_micro`` presets, face path on or off,
and the multi-class step of ``multiclass_fast_pico`` and
``multiclass_fast`` (:func:`make_multiclass_step`).  The single-class
step:

  packed u8 frames [S, H/b, W/b, b*b*3]
    -> int8 MatteNetHD (bf16 stem, the full, light, pico or micro trunk,
       int8 or bf16 alpha head, x4 upsample, sigmoid)
    -> planar u8 guide (lane selection of the packed frames)
    -> face subpath on the guide, compacted to the <= K streams whose
       cadence fires: letterbox -> FaceFinder -> best box -> prior
       scalars -> ROI crop -> LandmarkNet -> Procrustes affine
    -> fused temporal refine kernel (stages 3-9, analytic prior)
    -> packed composite over the background
    -> affine low-pass with the face path's updates
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from video_stream_segmenetation_tpu_torch.kernels.refine_fused import (
    fused_temporal_refine,
)
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
    multiclass_composite_s2d,
)
from video_stream_segmenetation_tpu_torch.ops.prior import face_prior_params
from video_stream_segmenetation_tpu_torch.ops.resize import (
    crop_and_resize_mxu,
    resize_bilinear_mxu,
)
from video_stream_segmenetation_tpu_torch.ops.temporal import affine_lowpass
from video_stream_segmenetation_tpu_torch.runtime.config import (
    EMA_ADAPT_T0,
    EMA_ADAPT_T1,
    PipelineKnobs,
    PipelineStatics,
)
from video_stream_segmenetation_tpu_torch.runtime.state import StreamState

# (field, the only value the port serves) -- anything else is refused
_SERVED = (
    ("frame_layout", "s2d"),
    ("matting_precision", "int8"),
    ("upsample_method", "half_pixel"),
    ("background", "image"),
    ("face_tracking", "landmarks"),
    ("refine_alpha_src", "full"),
    ("guide_kernel_unfold", False),
    ("affine_mode", "exact"),
)
# ... and, with the face path on
_SERVED_FACE = (
    ("face_compact", True),
    ("face_input", "guide"),
)


def check_statics(statics: PipelineStatics) -> None:
    """Refuse what the port's steps do not serve."""
    multiclass = statics.num_classes > 1
    if multiclass:
        served = _SERVED + (("face_path", False),)
    else:
        served = _SERVED + (_SERVED_FACE if statics.face_path else ())
    for field, want in served:
        got = getattr(statics, field)
        if got != want:
            raise NotImplementedError(
                f"{field}={got!r}: the torch port serves {field}={want!r} only"
                + (f" with num_classes={statics.num_classes}" if multiclass else ""))
    decoders = ("pico", "nano") if multiclass else ("pico", "micro", "light", "full")
    if multiclass:
        if len(statics.class_effects) != statics.num_classes:
            raise ValueError(f"class_effects: {len(statics.class_effects)} effects for "
                             f"{statics.num_classes} classes")
        effect_algebra(statics.class_effects)
    for field, allowed in (("matting_decoder", decoders),
                           ("prior_impl", ("auto",)),
                           ("int8_conv_impl", ("xla", "pallas")),
                           ("int8_head_impl", ("int8", "bf16")),
                           ("refined_dtype", ("f32", "bf16"))):
        got = getattr(statics, field)
        if got not in allowed:
            raise NotImplementedError(
                f"{field}={got!r}: the torch port serves {allowed} only")


@dataclasses.dataclass
class FaceModels:
    """The face subpath's two models (models/blazeface.py, facemesh.py)."""

    face: torch.nn.Module
    lmk: torch.nn.Module


def letterbox_to_square(frames: torch.Tensor, frame_hw, target: int) -> torch.Tensor:
    """Fit-resize (half-pixel bilinear, the matrix form of the reference's
    ``resize_impl='mxu'``) ``[S, h, w, 3]`` into a ``target`` square and
    pad with black (toSquareLetterbox)."""
    _, dw, dh, off_x, off_y = letterbox_params(frame_hw, target)
    small = resize_bilinear_mxu(frames, (dh, dw), method="half_pixel")
    return F.pad(small, (0, 0, off_x, target - dw - off_x, off_y, target - dh - off_y))


def face_subpath(models: FaceModels, frames_f32: torch.Tensor, fire: torch.Tensor,
                 statics: PipelineStatics):
    """Stage 6 on ``frames_f32 [K, h, w, 3]`` (0..1; ``statics.frame_hw`` is
    their size): detector -> prior scalars -> ROI -> landmarks -> affine.
    ``fire [K]`` gates the streams.  Returns (prior params ``[K, 4]``,
    has_prior, affine_update ``[K, 6]``, has_update, det_score)."""
    mh, mw = statics.mask_hw
    fh, fw = statics.frame_hw
    fd_in = letterbox_to_square(frames_f32, (fh, fw), statics.fd_size)
    det = models.face(fd_in)
    box, score, valid = best_box_decode(det["box_coords"], det["box_scores"], (fh, fw),
                                        statics.fd_size, letterboxed=True)
    det_ok = fire & valid & (score >= statics.face_score_thresh)
    prior = face_prior_params(box, (fh, fw), (mh, mw))
    roi = pad_box(box, statics.roi_pad, (fh, fw))
    roi_img = crop_and_resize_mxu(frames_f32, roi, (statics.lmk_size, statics.lmk_size))
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


def face_subpath_compact(models: FaceModels, guide_u8: torch.Tensor,
                         frame_idx: torch.Tensor, face_gate: torch.Tensor,
                         statics: PipelineStatics):
    """Cadence-compacted stage 6 on the planar u8 guide ``[S, 3, mh, mw]``
    (``face_input='guide'``: the face path works in mask coordinates).
    The streams whose cadence fires (``frame_idx % lmk_interval == 0`` and
    the engine's ``face_gate``) are gathered, at most K = ``face_batch`` or
    ceil(S / lmk_interval) of them (overflow streams skip this round, as in
    the reference); the results are scattered back.  Returns what
    :func:`face_subpath` returns, for all S streams."""
    s = guide_u8.shape[0]
    mh, mw = statics.mask_hw
    fstat = dataclasses.replace(statics, frame_hw=(mh, mw))
    fire = ((frame_idx % statics.lmk_interval) == 0) & face_gate

    def to_f32(g):
        return g.permute(0, 2, 3, 1).to(torch.float32) / 255.0

    k = statics.face_batch or max(1, -(-s // statics.lmk_interval))
    if k >= s:
        return face_subpath(models, to_f32(guide_u8), fire, fstat)
    idxs = first_k(fire, k)
    sel_valid = idxs < s
    f_sel = to_f32(torch.index_select(guide_u8, 0, torch.clamp(idxs, max=s - 1)))
    outs = face_subpath(models, f_sel, sel_valid, fstat)

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


def make_step(model, statics: PipelineStatics, face_models: FaceModels | None = None):
    """step(state, frames_p, backgrounds_p, knobs, face_gate) -> (new_state,
    outputs); with ``statics.num_classes > 1`` the step of
    :func:`make_multiclass_step`.

    frames_p ``[S, H/b, W/b, b*b*3]`` u8; backgrounds_p the same shape or
    one row to broadcast; face_gate ``[S]`` bool (the engine's min-interval
    gate).  ``outputs``: ``frame`` (packed u8), ``alpha`` (``[S, mh, mw]``,
    bf16 or f32 by ``refined_dtype``), ``det_score``, ``face_applied``,
    ``face_prior_params`` and ``face_has_prior``."""
    check_statics(statics)
    if statics.num_classes > 1:
        return make_multiclass_step(model, statics)
    if statics.face_path and face_models is None:
        raise ValueError("make_step: the face path needs face_models")
    mh, mw = statics.mask_hw
    fh, fw = statics.frame_hw
    blk = statics.s2d_block
    out_dtype = torch.bfloat16 if statics.refined_dtype == "bf16" else torch.float32

    def step(state: StreamState, frames_p, backgrounds_p, knobs: PipelineKnobs,
             face_gate):
        s = frames_p.shape[0]
        dev = frames_p.device
        alpha_raw = model(frames_p)["alpha"].to(torch.float32).contiguous()
        guide = guide_from_s2d(frames_p, (fh, fw), (mh, mw), blk).contiguous()
        if statics.face_path:
            prior, has_prior, affine_update, has_update, det_score = face_subpath_compact(
                face_models, guide, state.frame_idx, face_gate, statics)
            prior = prior.contiguous()
        else:
            prior = torch.zeros((s, 4), dtype=torch.float32, device=dev)
            has_prior = torch.zeros((s,), dtype=torch.bool, device=dev)
            affine_update = torch.zeros((s, 6), dtype=torch.float32, device=dev)
            has_update = torch.zeros((s,), dtype=torch.bool, device=dev)
            det_score = torch.zeros((s,), dtype=torch.float32, device=dev)

        new_prev, a = fused_temporal_refine(
            alpha_raw, state.prev_alpha, state.affine,
            state.has_affine & state.initialized, state.initialized,
            statics.warp_blend_weight, guide, prior, has_prior, knobs,
            out_dtype=out_dtype,
        )
        out_u8 = alpha_composite_s2d(frames_p, a, backgrounds_p, (fh, fw), blk)
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
            "face_prior_params": prior,
            "face_has_prior": has_prior,
        }
        return new_state, outputs

    return step
