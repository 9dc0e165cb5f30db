"""Static pipeline geometry and live per-stream knobs.

Port of ``video_stream_segmenetation_tpu/runtime/config.py``: the
``PipelineStatics`` fields that presets set, ``PipelineKnobs`` with one
``[S]`` tensor per knob (a slider move is a row write, never a rebuild),
``default_knobs`` and the motion-adaptive EMA ramp ``EMA_ADAPT_T0/T1``
(read by :func:`ema_gate` at each call of the EMA or the refine kernel,
as the reference reads them when it traces a step: a tool that moves
them, for instance with :func:`ema_gate_at`, moves the gate of every
path, the refine kernel's included).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

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


def ema_gate() -> tuple[float, float]:
    """The motion gate as this module holds it now: ``(t0, inv_ramp)``,
    ``inv_ramp = 1 / (EMA_ADAPT_T1 - EMA_ADAPT_T0)`` in Python double (an
    f32 operation rounds each once, as the reference's weak-typed
    constants are)."""
    return EMA_ADAPT_T0, 1.0 / (EMA_ADAPT_T1 - EMA_ADAPT_T0)


@contextlib.contextmanager
def ema_gate_at(t0: float | None = None, t1: float | None = None):
    """``EMA_ADAPT_T0/T1`` moved to ``t0``/``t1`` (None: that end kept)
    for the ``with`` block, then put back."""
    global EMA_ADAPT_T0, EMA_ADAPT_T1
    saved = EMA_ADAPT_T0, EMA_ADAPT_T1
    EMA_ADAPT_T0 = saved[0] if t0 is None else t0
    EMA_ADAPT_T1 = saved[1] if t1 is None else t1
    try:
        yield
    finally:
        EMA_ADAPT_T0, EMA_ADAPT_T1 = saved


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

    Defaults are the reference's: ``PipelineStatics()`` is its ``active``
    preset, the float MatteNet over resized natural-layout frames.  Only
    the fields the port reads or refuses are here; the port serves that
    natural path with its variants (``blaze_tracking``, ``branch``,
    ``rvm``, ``u2``) and the reference's ``fast_int8_*`` and
    ``multiclass_fast*`` s2d paths, ``fast`` (the float MatteNetHD over
    natural frames) and the natural ``multiclass``, and
    runtime/pipeline.py::check_statics refuses every value none of them
    serves.
    """

    frame_hw: tuple[int, int] = (720, 1280)
    mask_hw: tuple[int, int] = (288, 512)  # MODEL_INPUT_SIZE [W,H]=[512,288]
    fd_size: int = 256  # FD_INPUT (frameProcessorTest.ts:33)
    lmk_size: int = 192  # LMK_INPUT (:34)
    lmk_interval: int = 6  # LANDMARK_INTERVAL (main.ts:10)
    warp_gain: float = 0.7  # WARP_GAIN (main.ts:12)
    warp_blend_weight: float = 0.3  # WARP_BLEND_WEIGHT (frameProcessorTest.ts:108)
    # warp blend mode: 'lerp' (active pipeline, wb*warped + (1-wb)*cur) or
    # 'max' (the branch variant: max(cur, warped*warp_blend_weight),
    # frameProcessor_branch.ts:83-88 with 0.75)
    warp_blend_mode: str = "lerp"
    face_score_thresh: float = 0.6  # FACE_SCORE_THRESH (:35)
    lmk_score_thresh: float = 0.3  # (:143)
    roi_pad: float = 0.25  # cropFaceROI pad (:139)
    # the landmark affine into mask pixels: 'exact' (the conjugation by the
    # scale) or 'reference' (the reference client's: tx and ty scaled only)
    affine_mode: str = "exact"
    # 'image' (each stream's own, Engine.set_background), 'color' (one solid
    # bg_color for every stream) or 'blur' (each frame blurred, Gaussian of
    # bg_blur_sigma pixels); the multi-class step composites by
    # class_effects and serves 'image' only
    background: str = "image"
    bg_color: tuple[float, float, float] = (20 / 255, 25 / 255, 30 / 255)
    bg_blur_sigma: float = 8.0
    face_path: bool = True
    # face tracking mode: 'landmarks' = FD -> ROI -> 468 landmarks ->
    # Procrustes similarity (the active frameProcessorTest.ts pipeline);
    # 'translation' = detector-center delta only (the BlazeFace variant,
    # frameProcessor.ts:369-386: plain fd_size resize, center delta x gain,
    # no prior; on the face source of face_input, either layout)
    face_tracking: str = "landmarks"
    translation_gain: float = 0.9  # WARP_GAIN (frameProcessor.ts:26)
    # temporal filter: 'ema' (frameProcessorTest.ts:218-227), 'hole_fill'
    # (the documented alternative, frameProcessor_branch.ts:155-180) or
    # 'none' (the U2Net variant, which has no temporal stage)
    temporal_filter: str = "ema"
    ema_adapt_default: float = 0.0
    # opening and prior-gated closing (the blaze, branch, RVM and U2Net
    # variants run without morphology, and then without the refine kernels)
    morphology: bool = True
    # cadence compaction: the face models run on the <= face_batch streams
    # whose cadence fires (0 = ceil(S / lmk_interval)); False runs them on
    # all S streams, gated by the cadence
    face_compact: bool = True
    face_batch: int = 0
    # prev-alpha warp: 'separable' (scale + translate, inside the fused
    # temporal refine) or 'exact' (the rotation-aware 2-D nearest warp,
    # then the EMA, then the fused refine of stages 5/7/8/9)
    warp_impl: str = "separable"
    # the plain composite's alpha upsample: 'mxu' (planar interpolation
    # products) or 'gather' (two-tap gathers); the products' precision
    # (the natural plain composite and the packed one) 'fast' (the
    # reference's one bf16 pass) or 'exact' (f32)
    upsample_impl: str = "mxu"
    upsample_precision: str = "fast"
    # the refine kernels: 'auto' or True (the kernel on the card, its
    # plain version on the CPU), taken where morphology is on; False: the
    # unfused stage chain (warp, blend, temporal filter, morphology,
    # bilateral, refine), the reference's CPU default
    use_fused_refine: Any = "auto"
    # the face prior on the fused temporal refine: 'auto' (4 scalars, the
    # ellipse rasterised in the kernel) or 'plane' (rendered [S, H, W])
    prior_impl: str = "auto"
    # the natural layout's fused composite kernel: True, or False / 'auto'
    # (the plain upsample and blend, as the reference's 'auto')
    use_fused_composite: Any = False
    # the letterbox of the face path and the natural layout's resize to the
    # mask: 'gather' (two-tap gathers) or 'mxu' (interpolation products);
    # the ROI crop likewise, on either layout
    resize_impl: str = "gather"
    crop_impl: str = "gather"
    # the 'mxu' resize to the mask: 'fast' (one bf16 pass, the TPU's
    # DEFAULT precision) or 'exact' (f32)
    preprocess_precision: str = "fast"
    # matting input: 'resized' (frames resized to the mask, the float
    # MatteNet) or 'native' (the full-resolution frames, natural or
    # s2d-packed: the MatteNetHD, int8 or float by matting_precision; its
    # strided stem does the resize)
    matting_input: str = "resized"
    # face source: 'frames' (the full-resolution frames; on s2d the packed
    # frames of the gathered streams unpacked) or 'guide' (the
    # mask-resolution guide: the face path then works in mask coordinates)
    face_input: str = "frames"
    # the bilateral guide with matting_input='native': 'bilinear' (the
    # frame resized to the mask, u8-rounded) or 'nearest_u8' (nearest taps
    # of the u8 frames: lanes of the packed frames on s2d); the resized
    # input is its own guide
    guide_impl: str = "bilinear"
    s2d_block: int = 5
    # the MatteNetHD's plan at a stem stride of 8 or more: 'pico', 'nano',
    # 'femto', 'micro' (plan D's branch), 'light' (plan C), 'full' (plan B);
    # below 8 the net is plan A whatever this says
    matting_decoder: str = "full"
    # matting architecture: 'feedforward', 'recurrent' (RVM-class model
    # threading ConvGRU state through StreamState.rec), or 'saliency'
    # (U2Net-class SaliencyNet at its canonical square geometry)
    matting_arch: str = "feedforward"
    # the fused temporal refine's alpha: 'full' (the model's [S, mh, mw]
    # f32 alpha) or 'lowres' (the head-grid logits; the x4 upsample and the
    # sigmoid run in the kernel, so the full-resolution alpha is never
    # written).  'auto' resolves as the reference resolves it off a TPU:
    # 'full' (the reference turns it on on the TPU only)
    refine_alpha_src: str = "full"
    # True: the kernel takes the raw guide tap lanes [nl, S, hp, wp] u8
    # (ops/layout.py::guide_lanes_s2d) and unfolds them itself, so the
    # planar guide is never built; False: the planar u8 guide.  'auto'
    # resolves off, as the reference off a TPU
    guide_kernel_unfold: Any = False
    # where the lanes come from when guide_kernel_unfold is on: 'gather'
    # (gathered on the card from the packed frames) or 'host' (the step
    # takes a (packed, lanes) tuple; runtime/native.py::FramePool emits the
    # lanes while it packs)
    guide_source: str = "gather"
    refined_dtype: str = "f32"  # refined alpha: 'f32' or 'bf16'
    # multi-class mode (BASELINE config 5): K > 1 segmentation classes,
    # class 0 the background; the composite applies one effect a class
    # ({"keep": True}, {"blur": sigma}, {"tint": rgb, "strength": s},
    # {"color": rgb}), K of them
    num_classes: int = 1
    class_effects: tuple = ()
    upsample_method: str = "half_pixel"  # also "asymmetric", "align_corners"
    # 'natural' [S, H, W, 3] with the float models, or 's2d'
    # [S, H/b, W/b, b*b*3] with the MatteNetHD ('int8' or the float 'bf16'
    # by matting_precision)
    frame_layout: str = "natural"
    matting_precision: str = "bf16"
    # the int8 graph's lowerings (models/quantized.py::QuantizedMatteNetHD):
    # 'xla' | 'pallas' -- with 'pallas' the micro, light and full trunks'
    # 3x3 stride-1 requant convs run through kernels/conv_int8.py
    int8_conv_impl: str = "xla"
    # the face subpath's models: 'fast' (the FaceFinder and LandmarkNet
    # students) or 'reference' (the reference application's MediaPipe
    # graphs, models/reference_face.py; fd_size 256 and lmk_size 192, served
    # in f32 whatever face_precision says)
    face_models: str = "fast"
    # the fast face models' precision: 'bf16' (models/blazeface.py,
    # facemesh.py) or 'int8' (models/quantized_face.py)
    face_precision: str = "bf16"
    # 'int8' | 'bf16' -- the alpha head: int8 on u1 (in the trunk kernel),
    # or u1 out of the trunk and a bf16 conv with the float head
    int8_head_impl: str = "int8"
    # bench-only stage truncation for step-cost attribution (profile_step.py
    # --ablate): '' = full step; 'model_only' = skip warp/EMA/refine (a =
    # raw model alpha); 'no_composite' = full refine, passthrough output;
    # 'no_morph' / 'no_bilateral' = the fused temporal refine without stages
    # 5+7 / 8; 'no_guide' = a zero guide into that kernel; 'fd_stub',
    # 'fd_only', 'no_lmk' = the face subpath cut short (DEBUG_TOKENS).
    # Comma-combinable ('model_only,no_composite' = bare trunk cost).  NOT a
    # serving mode.
    debug_stage: str = ""


# the tokens debug_stage may combine (runtime/pipeline.py::check_statics
# refuses any other)
DEBUG_TOKENS = ("model_only", "no_composite", "fd_stub", "fd_only", "no_lmk", "no_morph",
                "no_bilateral", "no_guide")


def debug_tokens(statics: PipelineStatics) -> frozenset:
    """The tokens of ``statics.debug_stage`` (comma-separated, blanks
    ignored)."""
    return frozenset(t.strip() for t in statics.debug_stage.split(",") if t.strip())
