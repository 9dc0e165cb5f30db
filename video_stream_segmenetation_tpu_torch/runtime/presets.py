"""Named pipeline presets (port of ``runtime/presets.py``).

``active`` (the reference's default pipeline, ``PipelineStatics()``: the
float MatteNet over resized natural-layout frames), ``fast`` (the float
plan-A MatteNetHD over the natural frames), its alternative pipelines
``blaze_tracking``, ``branch``, ``rvm`` and ``u2`` (the reference
application's other frame processors), ``fast_int8``, ``fast_int8_lite``,
``fast_int8_pico``, ``fast_int8_nano``, ``fast_int8_femto``,
``fast_int8_micro``, ``multiclass`` (the K=4 MatteNet over natural frames),
``multiclass_fast_pico``, ``multiclass_fast`` and
``fast_int8_pico_refface`` (pico with the MediaPipe face graphs) are
ported, as the reference defines them: all sixteen.  ``preset(name,
**overrides)`` takes overrides the way the reference's does
(``face_path=False``, ``frame_hw``, ``mask_hw``, ``warp_impl='exact'``,
...).
"""

from __future__ import annotations

import dataclasses

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
    # the float MatteNetHD (plan A, stem stride 5) over the natural u8
    # frames, its stem the resize, the guide the frames' nearest taps
    # (:26-32); checkpoint mattenet_hd
    "fast": dict(matting_input="native", guide_impl="nearest_u8", warp_impl="separable",
                 face_compact=True, ema_adapt_default=1.0),
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
    # plan-E nano trunk (:88-102): plan D with single 3x3 convs instead of
    # residual blocks, deep widths 192/256; checkpoint mattenet_hd10_nano
    "fast_int8_nano": dict(_FAST_INT8, matting_decoder="nano"),
    # plan-F pico trunk (:119-136): bf16 refined alpha, face models
    # retrained at 128/128
    "fast_int8_pico": dict(_FAST_INT8, matting_decoder="pico", refined_dtype="bf16",
                           fd_size=128, lmk_size=128),
    # pico with the reference's MediaPipe face graphs at 256/192 (:144-161),
    # served in f32 (models/reference_face.py)
    "fast_int8_pico_refface": dict(_FAST_INT8, matting_decoder="pico", refined_dtype="bf16",
                                   fd_size=256, lmk_size=192, face_models="reference"),
    # plan-G femto trunk (:165-180): every trunk level at 128 channels;
    # checkpoint mattenet_hd10_femto
    "fast_int8_femto": dict(_FAST_INT8, matting_decoder="femto"),
    # (:182-193) frameProcessor.ts: BlazeFace centre tracking, translation
    # warp (gain 0.9, 50/50 blend), no morphology or prior; the detector on
    # a plain 128 resize every frame; the explicitAlphaBlend colour
    "blaze_tracking": dict(face_tracking="translation", translation_gain=0.9,
                           warp_blend_weight=0.5, lmk_interval=1, morphology=False,
                           fd_size=128, background="color",
                           bg_color=(20 / 255, 25 / 255, 30 / 255)),
    # (:195-201) frameProcessor_branch.ts: warp + hole-filling EMA +
    # bilateral + refine, no FD/LMK/morphology inside (the affine supplied
    # from outside); the blend max(cur, warped * 0.75)
    "branch": dict(face_path=False, morphology=False, temporal_filter="hole_fill",
                   warp_blend_mode="max", warp_blend_weight=0.75),
    # (:203-208) frameProcessorRVM.ts: recurrent matting + EMA + composite
    # only; checkpoint rvm
    "rvm": dict(matting_arch="recurrent", face_path=False, morphology=False),
    # (:210-217) u2FrameProc.ts: 320x320 saliency, no temporal stage, a
    # constant colour; checkpoint u2net
    "u2": dict(matting_arch="saliency", mask_hw=(320, 320), face_path=False,
               morphology=False, temporal_filter="none", background="color"),
    # natural layout, the K=4 float MatteNet over the frames resized to the
    # mask, the per-class composite at full resolution (:219-229);
    # checkpoint mattenet_multiclass
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


def describe(name: str) -> str:
    """One line naming a preset and the statics it sets apart from
    ``PipelineStatics()``'s defaults (the reference's ``describe``; the
    fields in the port's order, of the fields the port has)."""
    base = PipelineStatics()
    p = preset(name)
    diffs = {f.name: getattr(p, f.name) for f in dataclasses.fields(PipelineStatics)
             if getattr(p, f.name) != getattr(base, f.name)}
    return f"{name}: {diffs or 'defaults (the active frameProcessorTest pipeline)'}"
