"""Alpha compositing (port of ``ops/composite.py::upsample_alpha``,
``alpha_composite``, ``multiclass_composite`` and ``binarize_alpha``), and the
natural layout's plain composite the reference's step runs
(``runtime/pipeline.py:899-938``)."""

from __future__ import annotations

import torch

from video_stream_segmenetation_tpu_torch.ops.blur import gaussian_blur, gaussian_blur_auto
from video_stream_segmenetation_tpu_torch.ops.color import (  # noqa: F401
    denormalize_to_u8,
    quantize_alpha_u8,
)
from video_stream_segmenetation_tpu_torch.ops.resize import resize_bilinear, resize_bilinear_mxu


def upsample_alpha(alpha: torch.Tensor, out_hw, method: str = "half_pixel",
                   clamp: bool = True) -> torch.Tensor:
    """Mask-resolution alpha ``[..., h, w]`` -> ``[..., H, W]`` (two-tap
    bilinear gathers), clipped to [0, 1] with ``clamp``."""
    up = resize_bilinear(alpha, out_hw, method=method, channel_last=False)
    return torch.clamp(up, 0.0, 1.0) if clamp else up


def alpha_composite(frame: torch.Tensor, alpha: torch.Tensor,
                    background: torch.Tensor | None = None,
                    bg_color: tuple[float, float, float] | None = None,
                    bg_blur_sigma: float | None = None,
                    upsample_method: str = "half_pixel",
                    quantize_alpha: bool = False, out_u8: bool = False) -> torch.Tensor:
    """``frame * a + bg * (1 - a)``.  frame ``[..., H, W, 3]`` float (0..1
    for ``out_u8``); alpha ``[..., h, w]`` at mask resolution (upsampled
    here) or ``[..., H, W]`` (clipped to [0, 1]).  The background, by
    priority: ``background`` (broadcast to the frame), the blurred frame
    (``bg_blur_sigma``), the solid ``bg_color``, black.  ``out_u8``: u8,
    round half up; ``quantize_alpha``: the alpha rounded to 1/255 first."""
    h, w = frame.shape[-3], frame.shape[-2]
    if tuple(alpha.shape[-2:]) != (h, w):
        alpha = upsample_alpha(alpha, (h, w), method=upsample_method)
    else:
        alpha = torch.clamp(alpha, 0.0, 1.0)
    if quantize_alpha:
        alpha = quantize_alpha_u8(alpha)
    a = alpha[..., None].to(frame.dtype)
    if background is not None:
        bg = background.to(frame.dtype)
    elif bg_blur_sigma is not None:
        bg = gaussian_blur(frame, bg_blur_sigma)
    elif bg_color is not None:
        bg = torch.tensor(bg_color, dtype=frame.dtype, device=frame.device)
    else:
        bg = torch.zeros((), dtype=frame.dtype, device=frame.device)
    out = frame * a + bg * (1 - a)
    return denormalize_to_u8(out) if out_u8 else out


def natural_composite(frames_u8: torch.Tensor, alpha: torch.Tensor,
                      background: torch.Tensor, method: str = "half_pixel",
                      bf16_pass: bool = True, impl: str = "mxu") -> torch.Tensor:
    """The reference step's plain composite: the mask-resolution ``alpha
    [S, mh, mw]`` upsampled to the frame and clipped, then
    :func:`alpha_composite` of ``frames_u8 / 255`` over the background: u8
    (``[S or 1, H, W, 3]``, divided by 255) or float 0..1 broadcastable to
    the frames (a colour ``[3]``, a blurred frame).  The upsample
    (``upsample_impl``): ``'mxu'`` planar interpolation products
    (``upsample_precision='fast'``: one bf16 pass, as the TPU's DEFAULT
    precision runs it; ``'exact'``: f32), a bf16 alpha (``refined_dtype=
    'bf16'``) in the reference's bf16 dtype flow, its operands and both
    products' results rounded to bf16; ``'gather'`` the two-tap gathers of
    :func:`upsample_alpha` in the alpha's dtype."""
    fh, fw = frames_u8.shape[1:3]
    if impl == "gather":
        up = alpha
    elif alpha.dtype == torch.bfloat16:
        up = resize_bilinear_mxu(alpha.to(torch.float32), (fh, fw), method=method,
                                 channel_last=False, bf16_pass=True).to(torch.bfloat16)
        up = torch.clamp(up, 0.0, 1.0)
    else:
        up = torch.clamp(resize_bilinear_mxu(alpha.to(torch.float32), (fh, fw),
                                             method=method, channel_last=False,
                                             bf16_pass=bf16_pass), 0.0, 1.0)
    bg = (background.to(torch.float32) / 255.0 if background.dtype == torch.uint8
          else background.to(torch.float32))
    return alpha_composite(frames_u8.to(torch.float32) / 255.0, up, background=bg,
                           upsample_method=method, out_u8=True)


def multiclass_composite(frame: torch.Tensor, class_alpha: torch.Tensor, effects,
                         upsample_method: str = "half_pixel",
                         out_u8: bool = False) -> torch.Tensor:
    """Per-class composite effects (port of ``multiclass_composite``; the
    natural layout's ``multiclass`` preset): frame ``[..., H, W, 3]`` f32
    0..1, class_alpha ``[..., h, w, K]`` softmax maps (class 0 the
    background), one effect a class: ``{"keep": True}``, ``{"color":
    rgb}``, ``{"blur": sigma}`` (:func:`gaussian_blur_auto` of the frame),
    ``{"tint": rgb, "strength": s}``.  Maps off the frame's grid are
    upsampled one class at a time by the planar interpolation products in
    f32 (the reference's ``precision=None``, HIGHEST), clipped and
    renormalised.  Output ``sum_k effect_k(frame) * alpha_k``, u8 with
    ``out_u8``."""
    h, w = frame.shape[-3], frame.shape[-2]
    k = class_alpha.shape[-1]
    if len(effects) != k:
        raise ValueError(f"need {k} effects, got {len(effects)}")
    if tuple(class_alpha.shape[-3:-1]) != (h, w):
        maps = [torch.clamp(resize_bilinear_mxu(class_alpha[..., i], (h, w),
                                                method=upsample_method, channel_last=False),
                            0.0, 1.0) for i in range(k)]
        class_alpha = torch.stack(maps, dim=-1)
        class_alpha = class_alpha / torch.clamp(class_alpha.sum(-1, keepdim=True), min=1e-6)
    out = torch.zeros_like(frame)
    for i, eff in enumerate(effects):
        a = class_alpha[..., i: i + 1]
        if eff.get("keep"):
            layer = frame
        elif "color" in eff:
            layer = torch.tensor(eff["color"], dtype=frame.dtype, device=frame.device)
        elif "blur" in eff:
            layer = gaussian_blur_auto(frame, float(eff["blur"]))
        elif "tint" in eff:
            st = float(eff.get("strength", 0.5))
            tint = torch.tensor(eff["tint"], dtype=frame.dtype, device=frame.device)
            layer = frame * (1 - st) + tint * st
        else:
            raise ValueError(f"unknown effect {eff!r}: the effects are keep, color, blur "
                             "and tint")
        out = out + layer * a
    return denormalize_to_u8(out) if out_u8 else out


def binarize_alpha(alpha: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """Hard alpha (the soft/hard composite switch of the U2Net variant's
    composeMatteOnCanvas, u2FrameProc.ts:78-148): 1 where ``alpha >=
    threshold``, else 0, in ``alpha``'s dtype."""
    return (alpha >= threshold).to(alpha.dtype)
