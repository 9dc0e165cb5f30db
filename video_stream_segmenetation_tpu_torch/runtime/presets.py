"""Named pipeline presets (port of ``runtime/presets.py``).

Only ``fast_int8_pico`` is ported so far; ``preset(name, **overrides)``
takes overrides the way the reference's does (``face_path=False``,
``frame_hw``, ``mask_hw``, ...).
"""

from __future__ import annotations

from video_stream_segmenetation_tpu_torch.runtime.config import PipelineStatics

_PRESETS = {
    # plan-F pico trunk, int8 serving over s2d-packed frames (the
    # reference's runtime/presets.py:119-136).  The rest of that preset --
    # native int8 pico matting, nearest-u8 guide, separable warp, bf16
    # refined alpha, the face-path geometry -- is what the port's step does
    # unconditionally, or, for the face path, not yet.
    "fast_int8_pico": dict(ema_adapt_default=1.0, s2d_block=10),
}


def preset(name: str, **overrides) -> PipelineStatics:
    if name not in _PRESETS:
        raise KeyError(f"unknown preset '{name}'; have {sorted(_PRESETS)}")
    return PipelineStatics(**{**_PRESETS[name], **overrides})


def list_presets() -> list[str]:
    return sorted(_PRESETS)
