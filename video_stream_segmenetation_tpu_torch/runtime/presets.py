"""Named pipeline presets (port of ``runtime/presets.py``).

``fast_int8_pico`` and ``fast_int8_micro`` are ported, as the reference
defines them; ``preset(name, **overrides)`` takes overrides the way the
reference's does (``face_path=False``, ``frame_hw``, ``mask_hw``, ...).
The rest of each reference preset -- native int8 matting over s2d-packed
frames, the nearest-u8 planar guide, the separable warp, the matrix-form
ROI crop and letterbox resize (``crop_impl='mxu'``,
``resize_impl='mxu'``) -- is what the port's step does
unconditionally.
"""

from __future__ import annotations

from video_stream_segmenetation_tpu_torch.runtime.config import PipelineStatics

_FAST_INT8 = dict(
    ema_adapt_default=1.0,
    face_compact=True,
    s2d_block=10,
    face_input="guide",
)

_PRESETS = {
    # plan-D micro trunk (the reference's runtime/presets.py:71-84):
    # residual blocks at 192/256, one dilation-3 context conv, 1x1-only
    # decoder; the face models at the reference geometry 256/192 and an
    # f32 refined alpha (the preset sets no refined_dtype)
    "fast_int8_micro": dict(_FAST_INT8, matting_decoder="micro"),
    # plan-F pico trunk (:119-136): bf16 refined alpha, face models
    # retrained at 128/128
    "fast_int8_pico": dict(_FAST_INT8, matting_decoder="pico", refined_dtype="bf16",
                           fd_size=128, lmk_size=128),
}


def preset(name: str, **overrides) -> PipelineStatics:
    if name not in _PRESETS:
        raise KeyError(f"unknown preset '{name}'; have {sorted(_PRESETS)}")
    return PipelineStatics(**{**_PRESETS[name], **overrides})


def list_presets() -> list[str]:
    return sorted(_PRESETS)
