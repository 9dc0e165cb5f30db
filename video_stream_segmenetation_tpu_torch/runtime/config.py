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

    Defaults are the reference's.  Only the fields the port reads or
    refuses are here.  The port's steps are the reference's ``fast_int8_*``
    and ``multiclass_fast*`` paths and have no switches for what those
    presets select (native int8 matting of s2d-packed frames, nearest-u8
    planar guide, separable warp, the fused temporal refine with the
    analytic prior); runtime/pipeline.py::check_statics refuses what they
    do not serve.
    """

    frame_hw: tuple[int, int] = (720, 1280)
    mask_hw: tuple[int, int] = (288, 512)  # MODEL_INPUT_SIZE [W,H]=[512,288]
    fd_size: int = 256  # FD_INPUT (frameProcessorTest.ts:33)
    lmk_size: int = 192  # LMK_INPUT (:34)
    lmk_interval: int = 6  # LANDMARK_INTERVAL (main.ts:10)
    warp_gain: float = 0.7  # WARP_GAIN (main.ts:12)
    warp_blend_weight: float = 0.3  # WARP_BLEND_WEIGHT (frameProcessorTest.ts:108)
    face_score_thresh: float = 0.6  # FACE_SCORE_THRESH (:35)
    lmk_score_thresh: float = 0.3  # (:143)
    roi_pad: float = 0.25  # cropFaceROI pad (:139)
    affine_mode: str = "exact"  # the port serves 'exact' conjugation only
    background: str = "image"  # the port serves 'image' only
    face_path: bool = True
    face_tracking: str = "landmarks"  # the port serves 'landmarks' only
    ema_adapt_default: float = 0.0
    # cadence compaction: the face models run on the <= face_batch streams
    # whose cadence fires (0 = ceil(S / lmk_interval)); the port serves
    # face_compact=True only
    face_compact: bool = True
    face_batch: int = 0
    # face source: 'guide' (the mask-resolution planar u8 guide; the only
    # one the port serves) or 'frames'
    face_input: str = "frames"
    s2d_block: int = 5
    # the port serves 'pico', 'micro', 'light' and 'full' with one class,
    # 'pico' and 'nano' with K
    matting_decoder: str = "full"
    prior_impl: str = "auto"  # 'auto' = analytic; the port refuses 'plane'
    refine_alpha_src: str = "full"  # the port refuses 'lowres'
    guide_kernel_unfold: bool = False  # the port refuses True
    refined_dtype: str = "f32"  # refined alpha: 'f32' or 'bf16'
    # multi-class mode (BASELINE config 5): K > 1 segmentation classes,
    # class 0 the background; the composite applies one effect a class
    # ({"keep": True}, {"blur": sigma}, {"tint": rgb, "strength": s},
    # {"color": rgb}), K of them
    num_classes: int = 1
    class_effects: tuple = ()
    upsample_method: str = "half_pixel"  # the port serves 'half_pixel' only
    # the port serves the packed layout ('s2d') and the int8 matting graph
    # only; the reference's defaults select its float natural-layout path
    frame_layout: str = "natural"
    matting_precision: str = "bf16"
    # the int8 graph's lowerings (models/quantized.py::QuantizedMatteNetHD):
    # 'xla' | 'pallas' -- with 'pallas' the micro, light and full trunks'
    # 3x3 stride-1 requant convs run through kernels/conv_int8.py
    int8_conv_impl: str = "xla"
    # 'int8' | 'bf16' -- the alpha head: int8 on u1 (in the trunk kernel),
    # or u1 out of the trunk and a bf16 conv with the float head
    int8_head_impl: str = "int8"
