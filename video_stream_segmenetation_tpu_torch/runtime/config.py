"""Static pipeline geometry and live per-stream knobs.

Port of ``video_stream_segmenetation_tpu/runtime/config.py``: the
``PipelineStatics`` fields that presets set, ``PipelineKnobs`` with one
``[S]`` tensor per knob (a slider move is a row write, never a rebuild),
``default_knobs`` and the motion-adaptive EMA ramp ``EMA_ADAPT_T0/T1``.
"""

from __future__ import annotations

import dataclasses

import torch

# defaultConfig values (frameProcessorTest.ts:12-28)
DEFAULT_EMA = 0.55
DEFAULT_EMA_ADAPT = 0.0
EMA_ADAPT_T0 = 0.10
EMA_ADAPT_T1 = 0.40
DEFAULT_NOISE_CUTOFF = 0.06
DEFAULT_HIGH_THRESHOLD = 0.95
DEFAULT_GAMMA = 0.4
DEFAULT_USE_BILATERAL = True
DEFAULT_BILATERAL_SIGMA_SPATIAL = 1.0
DEFAULT_BILATERAL_SIGMA_RANGE = 12.0


@dataclasses.dataclass
class PipelineKnobs:
    """Per-stream live knobs; every field is an ``[S]`` tensor."""

    ema: torch.Tensor
    ema_adapt: torch.Tensor
    noise_cutoff: torch.Tensor
    high_threshold: torch.Tensor
    gamma: torch.Tensor
    use_bilateral: torch.Tensor  # bool
    sigma_spatial: torch.Tensor
    sigma_range: torch.Tensor

    @property
    def num_streams(self) -> int:
        return self.ema.shape[0]

    def replace_stream(self, s: int, **kw) -> None:
        """Single-stream update in place (a slider move on stream s)."""
        names = {f.name for f in dataclasses.fields(self)}
        for k, v in kw.items():
            if k not in names:
                raise KeyError(f"unknown knob {k!r}")
            getattr(self, k)[s] = v


def default_knobs(
    num_streams: int, ema_adapt: float = DEFAULT_EMA_ADAPT, device="cpu"
) -> PipelineKnobs:
    """All streams at defaultConfig (the reset path, script.ts:43-46)."""

    def full(v, dtype=torch.float32):
        return torch.full((num_streams,), v, dtype=dtype, device=device)

    return PipelineKnobs(
        ema=full(DEFAULT_EMA),
        ema_adapt=full(ema_adapt),
        noise_cutoff=full(DEFAULT_NOISE_CUTOFF),
        high_threshold=full(DEFAULT_HIGH_THRESHOLD),
        gamma=full(DEFAULT_GAMMA),
        use_bilateral=full(DEFAULT_USE_BILATERAL, torch.bool),
        sigma_spatial=full(DEFAULT_BILATERAL_SIGMA_SPATIAL),
        sigma_range=full(DEFAULT_BILATERAL_SIGMA_RANGE),
    )


@dataclasses.dataclass(frozen=True)
class PipelineStatics:
    """Pipeline geometry and constants (the reference's tier 1).

    Defaults are the reference's.  Only the fields the port reads are here.
    The port's step is the reference's ``fast_int8_pico`` path and has no
    switches for what that preset selects (s2d-packed frames, native int8
    pico matting, nearest-u8 planar guide, separable warp, bf16 refined
    alpha); ``face_path`` must be False until the face path is ported.
    """

    frame_hw: tuple[int, int] = (720, 1280)
    mask_hw: tuple[int, int] = (288, 512)  # MODEL_INPUT_SIZE [W,H]=[512,288]
    warp_gain: float = 0.7  # WARP_GAIN (main.ts:12)
    warp_blend_weight: float = 0.3  # WARP_BLEND_WEIGHT (frameProcessorTest.ts:108)
    background: str = "image"  # the port serves 'image' only
    face_path: bool = True
    ema_adapt_default: float = 0.0
    s2d_block: int = 5
