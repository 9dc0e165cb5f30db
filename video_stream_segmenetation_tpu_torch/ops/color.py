"""Pixel-format and normalisation ops (port of ``ops/color.py``): u8
frames to float and back, and the mask dtype conversions.  Channel-last
``[..., C]`` throughout, as the reference."""

from __future__ import annotations

import torch


def normalize_frame(frame_u8: torch.Tensor, mode: str = "unit",
                    mean: tuple[float, float, float] | None = None,
                    std: tuple[float, float, float] | None = None,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """u8 ``[..., C]`` -> float: ``'unit'`` x/255, ``'centered'`` x/255*2 - 1,
    ``'imagenet'`` (x/255 - mean)/std."""
    x = frame_u8.to(dtype) / 255.0
    if mode == "unit":
        return x
    if mode == "centered":
        return x * 2.0 - 1.0
    if mode == "imagenet":
        mean = mean or (0.485, 0.456, 0.406)
        std = std or (0.229, 0.224, 0.225)
        return ((x - torch.tensor(mean, dtype=dtype, device=x.device))
                / torch.tensor(std, dtype=dtype, device=x.device))
    raise ValueError(f"unknown normalize mode: {mode}")


def denormalize_to_u8(x: torch.Tensor) -> torch.Tensor:
    """float [0, 1] -> u8 with JS Math.round (round half up) semantics."""
    return torch.clamp(torch.floor(x * 255.0 + 0.5), 0, 255).to(torch.uint8)


def u8_mask_to_f32(mask_u8: torch.Tensor) -> torch.Tensor:
    """u8 alpha -> f32 /255."""
    return mask_u8.to(torch.float32) / 255.0


def mask_to_f32(mask: torch.Tensor) -> torch.Tensor:
    """Any mask dtype -> f32 (u8 is divided by 255)."""
    if mask.dtype == torch.uint8:
        return u8_mask_to_f32(mask)
    return mask.to(torch.float32)


def quantize_alpha_u8(alpha: torch.Tensor) -> torch.Tensor:
    """clamp, then round(a*255)/255: the precision an RGBA canvas keeps of
    an alpha."""
    a = torch.clamp(alpha, 0.0, 1.0)
    return torch.floor(a * 255.0 + 0.5) / 255.0
