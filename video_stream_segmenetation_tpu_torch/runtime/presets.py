"""Named pipeline presets (port of ``runtime/presets.py``).

``active`` (the reference's default pipeline, ``PipelineStatics()``: the
float MatteNet over resized natural-layout frames), ``fast_int8``,
``fast_int8_lite``, ``fast_int8_pico``, ``fast_int8_micro``,
``multiclass_fast_pico`` and ``multiclass_fast`` are ported, as the
reference defines them; ``preset(name, **overrides)`` takes overrides the
way the reference's does (``face_path=False``, ``frame_hw``,
``mask_hw``, ``warp_impl='exact'``, ...).  The reference's natural-layout
``multiclass`` preset is listed so that it is refused (runtime/
pipeline.py::check_statics: the K-class float MatteNet is not ported).
"""

from __future__ import annotations

from video_stream_segmenetation_tpu_torch.runtime.config import PipelineStatics

_FAST_INT8 = dict(
    ema_adapt_default=1.0,
    matting_input="native",
    guide_impl="nearest_u8",
    face_compact=True,
    s2d_block=10,
    face_input="guide",
    frame_layout="s2d",
    matting_precision="int8",
    crop_impl="mxu",
    resize_impl="mxu",
)
# the multi-class fast stack (no face path, so no crop)
_MULTICLASS_FAST = dict(matting_input="native", frame_layout="s2d", s2d_block=10,
                        matting_precision="int8", resize_impl="mxu", face_path=False)

# BASELINE config 5: background blurred, person kept, two tinted classes
# (the reference's runtime/presets.py:219-229); the simplex EMA at half
# strength
_MULTICLASS = dict(
    ema_adapt_default=0.5,
    num_classes=4,
    class_effects=(
        {"blur": 8.0},
        {"keep": True},
        {"tint": (0.9, 0.7, 0.3), "strength": 0.3},
        {"tint": (0.3, 0.5, 0.9), "strength": 0.3},
    ),
)

_PRESETS = {
    # the active pipeline, frameProcessorTest.ts (the reference's
    # runtime/presets.py:19): landmark affine warp, morphology, elliptical
    # prior, bilateral, live knobs; checkpoint mattenet
    "active": dict(),
    # plan-B trunk (the reference's runtime/presets.py:38-50, its "bench.py
    # headline configuration"): a residual b1 block at the stem grid, 2/4
    # dilation context, 3x3 decoder convs over the concat; face models at
    # 256/192, f32 refined alpha
    "fast_int8": dict(_FAST_INT8),
    # plan-C lite trunk (:53-66): one 3x3 b1 conv, 1x1-reduce decoder with
    # one 3x3 at the /2 level
    "fast_int8_lite": dict(_FAST_INT8, matting_decoder="light"),
    # plan-D micro trunk (the reference's runtime/presets.py:71-84):
    # residual blocks at 192/256, one dilation-3 context conv, 1x1-only
    # decoder; the face models at the reference geometry 256/192 and an
    # f32 refined alpha (the preset sets no refined_dtype)
    "fast_int8_micro": dict(_FAST_INT8, matting_decoder="micro"),
    # plan-F pico trunk (:119-136): bf16 refined alpha, face models
    # retrained at 128/128
    "fast_int8_pico": dict(_FAST_INT8, matting_decoder="pico", refined_dtype="bf16",
                           fd_size=128, lmk_size=128),
    # natural layout, float MatteNet (:219-229): refused by the port
    "multiclass": dict(_MULTICLASS),
    # plan-E nano trunk (192/256) with K=4 class heads, the class maps
    # upsampled x4 to the 288x512 mask (:236-255; checkpoint
    # mattenet_hd10_mc)
    "multiclass_fast": dict(_MULTICLASS, **_MULTICLASS_FAST, matting_decoder="nano"),
    # the pico trunk with K=4 heads, served at the 72x128 head grid
    # (head_upsample=1; :259-282; checkpoint mattenet_hd10_mc_pico)
    "multiclass_fast_pico": dict(_MULTICLASS, **_MULTICLASS_FAST, mask_hw=(72, 128),
                                 matting_decoder="pico"),
}


def preset(name: str, **overrides) -> PipelineStatics:
    if name not in _PRESETS:
        raise KeyError(f"unknown preset '{name}'; have {sorted(_PRESETS)}")
    return PipelineStatics(**{**_PRESETS[name], **overrides})


def list_presets() -> list[str]:
    return sorted(_PRESETS)
