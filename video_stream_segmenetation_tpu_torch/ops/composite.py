"""The natural layout's composite (port of ``ops/composite.py::
alpha_composite`` on an alpha already at frame resolution, and of
``ops/color.py::denormalize_to_u8``), and the upsample the reference's
step runs before it (``runtime/pipeline.py:899-938``)."""

from __future__ import annotations

import torch

from video_stream_segmenetation_tpu_torch.ops.resize import resize_bilinear_mxu


def denormalize_to_u8(x: torch.Tensor) -> torch.Tensor:
    """float [0, 1] -> u8 with JS Math.round (round half up) semantics."""
    return torch.clamp(torch.floor(x * 255.0 + 0.5), 0, 255).to(torch.uint8)


def alpha_composite(frame: torch.Tensor, alpha: torch.Tensor,
                    background: torch.Tensor) -> torch.Tensor:
    """``frame * a + bg * (1 - a)`` in 0..1 units, then u8 (round half up).
    frame ``[S, H, W, 3]`` f32 0..1, alpha ``[S, H, W]`` at frame
    resolution (clipped to [0, 1] here), background f32 0..1 broadcastable
    to the frame."""
    a = torch.clamp(alpha, 0.0, 1.0)[..., None].to(frame.dtype)
    return denormalize_to_u8(frame * a + background.to(frame.dtype) * (1 - a))


def natural_composite(frames_u8: torch.Tensor, alpha: torch.Tensor,
                      background_u8: torch.Tensor, method: str = "half_pixel",
                      bf16_pass: bool = True) -> torch.Tensor:
    """The reference step's plain composite: the mask-resolution ``alpha
    [S, mh, mw]`` upsampled to the frame as planar interpolation products
    (``upsample_precision='fast'``: one bf16 pass, as the TPU's DEFAULT
    precision runs it; ``'exact'``: f32) and clipped, then
    :func:`alpha_composite` of ``frames_u8 / 255`` over ``background_u8 /
    255`` (``[S or 1, H, W, 3]``)."""
    fh, fw = frames_u8.shape[1:3]
    up = torch.clamp(resize_bilinear_mxu(alpha.to(torch.float32), (fh, fw), method=method,
                                          channel_last=False, bf16_pass=bf16_pass),
                     0.0, 1.0)
    return alpha_composite(frames_u8.to(torch.float32) / 255.0, up,
                           background_u8.to(torch.float32) / 255.0)
