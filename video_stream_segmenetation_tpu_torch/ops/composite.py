"""Alpha compositing (port of ``ops/composite.py::upsample_alpha`` and
``alpha_composite``), and the natural layout's plain composite the
reference's step runs (``runtime/pipeline.py:899-938``)."""

from __future__ import annotations

import torch

from video_stream_segmenetation_tpu_torch.ops.blur import gaussian_blur
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
                      bf16_pass: bool = True) -> torch.Tensor:
    """The reference step's plain composite: the mask-resolution ``alpha
    [S, mh, mw]`` upsampled to the frame as planar interpolation products
    (``upsample_precision='fast'``: one bf16 pass, as the TPU's DEFAULT
    precision runs it; ``'exact'``: f32) and clipped, then
    :func:`alpha_composite` of ``frames_u8 / 255`` over the background:
    u8 (``[S or 1, H, W, 3]``, divided by 255) or float 0..1 broadcastable
    to the frames (a colour ``[3]``, a blurred frame)."""
    fh, fw = frames_u8.shape[1:3]
    up = torch.clamp(resize_bilinear_mxu(alpha.to(torch.float32), (fh, fw), method=method,
                                          channel_last=False, bf16_pass=bf16_pass),
                     0.0, 1.0)
    bg = (background.to(torch.float32) / 255.0 if background.dtype == torch.uint8
          else background.to(torch.float32))
    return alpha_composite(frames_u8.to(torch.float32) / 255.0, up, background=bg, out_u8=True)
