"""Affine inversion, the rotation-aware nearest warp and the separable
nearest-warp indices (port of ``ops/warp.py::invert_affine`` and
``warp_affine_nearest``, and of the index preparation at
``kernels/refine_fused.py:633-647``)."""

from __future__ import annotations

import torch


def invert_affine(affine: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Invert ``[..., 6]`` = (a11, a12, tx, a21, a22, ty); det == 0 -> eps
    (invertAffine, frameProcessorTest.ts:323-333)."""
    a11, a12, tx, a21, a22, ty = affine.unbind(-1)
    det = a11 * a22 - a12 * a21
    d = torch.where(det != 0, det, torch.full_like(det, eps))
    ia11 = a22 / d
    ia12 = -a12 / d
    ia21 = -a21 / d
    ia22 = a11 / d
    itx = -(ia11 * tx + ia12 * ty)
    ity = -(ia21 * tx + ia22 * ty)
    return torch.stack([ia11, ia12, itx, ia21, ia22, ity], dim=-1)


def warp_affine_nearest(src: torch.Tensor, affine: torch.Tensor) -> torch.Tensor:
    """Warp ``src [S, H, W]`` by the forward ``affine [S, 6]``: each output
    (x, y) samples src at the JS Math.round (floor(v + 0.5)) of the inverse
    affine's image of (x, y), the full 2-D map with its rotation
    (warpAffineNearest, frameProcessorTest.ts:335-353); out of range reads
    0."""
    h, w = src.shape[-2:]
    inv = invert_affine(affine)
    ia11, ia12, itx, ia21, ia22, ity = (inv[:, i, None, None] for i in range(6))
    x = torch.arange(w, dtype=src.dtype, device=src.device)[None, :]
    y = torch.arange(h, dtype=src.dtype, device=src.device)[:, None]
    sx = ia11 * x + ia12 * y + itx
    sy = ia21 * x + ia22 * y + ity
    xi = torch.floor(sx + 0.5).to(torch.int64)
    yi = torch.floor(sy + 0.5).to(torch.int64)
    valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    flat = torch.clamp(yi, 0, h - 1) * w + torch.clamp(xi, 0, w - 1)
    gathered = torch.gather(src.reshape(src.shape[0], -1), 1,
                            flat.reshape(src.shape[0], -1)).reshape(src.shape)
    return torch.where(valid, gathered, torch.zeros((), dtype=src.dtype, device=src.device))


def separable_warp_indices(affine: torch.Tensor, hw: tuple[int, int]):
    """Source row per output row ``yi [S, H]`` and source column per output
    column ``xi [S, W]`` (int32) of the scale+translate part of ``affine``;
    JS Math.round (floor(x + 0.5)), out of range -> -1."""
    h, w = hw
    inv = invert_affine(affine)
    dev = affine.device
    y = torch.arange(h, dtype=torch.float32, device=dev)
    x = torch.arange(w, dtype=torch.float32, device=dev)
    sy = inv[:, 4:5] * y + inv[:, 5:6]
    sx = inv[:, 0:1] * x + inv[:, 2:3]
    yi = torch.floor(sy + 0.5).to(torch.int32)
    xi = torch.floor(sx + 0.5).to(torch.int32)
    yi = torch.where((yi >= 0) & (yi < h), yi, torch.full_like(yi, -1))
    xi = torch.where((xi >= 0) & (xi < w), xi, torch.full_like(xi, -1))
    return yi.contiguous(), xi.contiguous()


def warp_separable_gather(src: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor):
    """``src [S, H, W]`` sampled at rows ``yi [S, H]`` and columns
    ``xi [S, W]``; a -1 index reads 0."""
    yc = yi.clamp(min=0).long()
    xc = xi.clamp(min=0).long()
    rows = torch.gather(src, 1, yc[:, :, None].expand(-1, -1, src.shape[2]))
    out = torch.gather(rows, 2, xc[:, None, :].expand(-1, src.shape[1], -1))
    valid = (yi >= 0)[:, :, None] & (xi >= 0)[:, None, :]
    return torch.where(valid, out, torch.zeros((), dtype=src.dtype, device=src.device))
