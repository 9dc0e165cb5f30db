"""The per-batch serving step (port of the single-class branch of
``runtime/pipeline.py::make_step``) for ``fast_int8_pico`` with the face
path off:

  packed u8 frames [S, H/b, W/b, b*b*3]
    -> int8 MatteNetHD (bf16 stem, trunk kernel, x4 upsample, sigmoid)
    -> planar u8 guide (lane selection of the packed frames)
    -> zero face prior
    -> fused temporal refine kernel (stages 3-9)
    -> packed composite over the background
    -> affine low-pass (no update without the face path)
"""

from __future__ import annotations

import dataclasses

import torch

from video_stream_segmenetation_tpu_torch.kernels.refine_fused import (
    fused_temporal_refine,
)
from video_stream_segmenetation_tpu_torch.ops.layout import (
    alpha_composite_s2d,
    guide_from_s2d,
)
from video_stream_segmenetation_tpu_torch.ops.temporal import affine_lowpass
from video_stream_segmenetation_tpu_torch.runtime.config import (
    PipelineKnobs,
    PipelineStatics,
)
from video_stream_segmenetation_tpu_torch.runtime.state import StreamState

def check_statics(statics: PipelineStatics) -> None:
    """Refuse what the port's step does not serve yet."""
    if statics.face_path:
        raise NotImplementedError(
            "the torch port serves fast_int8_pico with face_path=False only")
    if statics.background != "image":
        raise NotImplementedError(
            f"background {statics.background!r}: the port composites over "
            "per-stream images only")


def make_step(model, statics: PipelineStatics):
    """step(state, frames_p, backgrounds_p, knobs) -> (new_state, outputs).

    frames_p ``[S, H/b, W/b, b*b*3]`` u8; backgrounds_p the same shape or
    one row to broadcast.  ``outputs``: ``frame`` (packed u8), ``alpha``
    (bf16 ``[S, mh, mw]``), ``det_score``, ``face_applied``,
    ``face_prior_params`` and ``face_has_prior``."""
    check_statics(statics)
    mh, mw = statics.mask_hw
    fh, fw = statics.frame_hw
    blk = statics.s2d_block

    def step(state: StreamState, frames_p, backgrounds_p, knobs: PipelineKnobs):
        s = frames_p.shape[0]
        dev = frames_p.device
        alpha_raw = model(frames_p)["alpha"].to(torch.float32).contiguous()
        guide = guide_from_s2d(frames_p, (fh, fw), (mh, mw), blk).contiguous()
        # face path off: no prior, no affine update (pipeline.py:722-729)
        prior = torch.zeros((s, 4), dtype=torch.float32, device=dev)
        has_prior = torch.zeros((s,), dtype=torch.bool, device=dev)
        affine_update = torch.zeros((s, 6), dtype=torch.float32, device=dev)
        has_update = torch.zeros((s,), dtype=torch.bool, device=dev)
        det_score = torch.zeros((s,), dtype=torch.float32, device=dev)

        new_prev, a = fused_temporal_refine(
            alpha_raw, state.prev_alpha, state.affine,
            state.has_affine & state.initialized, state.initialized,
            statics.warp_blend_weight, guide, prior, has_prior, knobs,
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
