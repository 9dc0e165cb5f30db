"""Space-to-depth frame layout (port of ``ops/layout.py``).

Frames ride packed as ``[S, H/b, W/b, b*b*3]`` u8, patch lane order
``(dy, dx, c)``.  The guide is a lane selection of the packed frames; the
composite upsamples the mask-resolution alpha and blends in the packed
layout.
"""

from __future__ import annotations

import numpy as np
import torch

from video_stream_segmenetation_tpu_torch.ops.resize import (
    _nearest_taps,
    interp_matrix,
)


def space_to_depth(x: torch.Tensor, block: int) -> torch.Tensor:
    """``[..., H, W, C] -> [..., H/b, W/b, b*b*C]``, patch order (dy,dx,c)."""
    *lead, h, w, c = x.shape
    b = block
    if h % b or w % b:
        raise ValueError(f"space_to_depth: {h}x{w} not divisible by {b}")
    nd = len(lead)
    x = x.reshape(*lead, h // b, b, w // b, b, c)
    x = x.permute(*range(nd), nd, nd + 2, nd + 1, nd + 3, nd + 4)
    return x.reshape(*lead, h // b, w // b, b * b * c)


def depth_to_space(x: torch.Tensor, block: int) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    *lead, hp, wp, cc = x.shape
    b = block
    c = cc // (b * b)
    if cc != b * b * c:
        raise ValueError(f"depth_to_space: channel dim {cc} not {b}*{b}*c")
    nd = len(lead)
    x = x.reshape(*lead, hp, wp, b, b, c)
    x = x.permute(*range(nd), nd, nd + 2, nd + 1, nd + 3, nd + 4)
    return x.reshape(*lead, hp * b, wp * b, c)


def guide_s2d_sel(frame_hw, out_hw, block, channels=3, method="half_pixel"):
    """Lane indices that pick the nearest (half-pixel) guide taps out of
    each packed patch, channel-major (the reference's ``planar=True``
    order), or ``None`` where the taps do not repeat per patch."""
    fh, fw = frame_hw
    oh, ow = out_hw
    hp, wp = fh // block, fw // block
    if (oh % hp) or (ow % wp):
        raise ValueError(f"guide_from_s2d: {out_hw} not a multiple of {(hp, wp)}")
    fy, fx = oh // hp, ow // wp
    iy = _nearest_taps(oh, fh, method)
    ix = _nearest_taps(ow, fw, method)
    offs_y, offs_x = iy % block, ix % block
    ok = (
        np.array_equal(iy // block, np.repeat(np.arange(hp), fy))
        and np.array_equal(ix // block, np.repeat(np.arange(wp), fx))
        and np.array_equal(offs_y, np.tile(offs_y[:fy], hp))
        and np.array_equal(offs_x, np.tile(offs_x[:fx], wp))
    )
    if not ok:
        return None
    return (
        np.arange(channels)[:, None, None]
        + (offs_y[None, :fy, None] * block + offs_x[None, None, :fx]) * channels
    ).reshape(-1)


def guide_from_s2d(xp: torch.Tensor, frame_hw, out_hw, block, channels=3,
                   method="half_pixel") -> torch.Tensor:
    """Nearest-neighbour guide of packed frames ``[..., hp, wp, b*b*C]`` u8,
    planar: ``[..., C, oh, ow]`` u8 (the reference's ``planar=True``)."""
    sel = guide_s2d_sel(frame_hw, out_hw, block, channels, method)
    if sel is None:
        raise NotImplementedError(
            f"guide_from_s2d: the taps of {frame_hw} -> {out_hw} do not repeat per patch")
    oh, ow = out_hw
    hp, wp = frame_hw[0] // block, frame_hw[1] // block
    fy, fx = oh // hp, ow // wp
    g = xp[..., torch.as_tensor(sel, device=xp.device)]  # [..., hp, wp, nl]
    *lead, _, _, _ = g.shape
    nd = len(lead)
    g = g.reshape(*lead, hp, wp, channels, fy, fx)
    g = g.permute(*range(nd), nd + 2, nd, nd + 3, nd + 1, nd + 4)
    return g.reshape(*lead, channels, oh, ow)


def packed_color(color_f32, block: int, device="cpu") -> torch.Tensor:
    """Solid RGB colour (floats 0..1) as one packed patch vector
    ``[block*block*3]`` u8."""
    c = torch.as_tensor(color_f32, dtype=torch.float32, device=device)
    c_u8 = torch.clamp(torch.floor(c * 255.0 + 0.5), 0, 255).to(torch.uint8)
    return c_u8.repeat(block * block)


def alpha_composite_s2d(frame_p: torch.Tensor, alpha: torch.Tensor,
                        bg_p: torch.Tensor, frame_hw, block: int,
                        method: str = "half_pixel") -> torch.Tensor:
    """Upsample ``alpha [S, mh, mw]`` to the frame and blend
    ``frame*a + bg*(1-a)`` in the packed layout; u8 out, round half up.

    Same semantics as the reference's packed composite: half-pixel taps as
    two interpolation products whose operands and results round to bf16
    (the reference's DEFAULT-precision matmuls), the upsampled alpha
    clamped to [0, 1].
    """
    fh, fw = frame_hw
    s = frame_p.shape[0]
    dev = frame_p.device
    a_h = interp_matrix(fh, alpha.shape[-2], method, device=dev)
    a_w = interp_matrix(fw, alpha.shape[-1], method, device=dev)
    bf = torch.bfloat16
    a = alpha.to(bf).float()
    c = torch.matmul(a_h.to(bf).float(), a).to(bf).float()  # [S, fh, mw]
    up = torch.matmul(c, a_w.to(bf).float().t()).to(bf).float()  # [S, fh, fw]
    up = torch.clamp(up, 0.0, 1.0)
    a_p = space_to_depth(up.unsqueeze(-1), block)  # [S, hp, wp, b*b]
    a_p = a_p.repeat_interleave(3, dim=-1)
    f = frame_p.float()
    g = bg_p.expand(s, *frame_p.shape[1:]).float()
    blend = f * a_p + g * (1.0 - a_p)
    return torch.clamp(torch.floor(blend + 0.5), 0, 255).to(torch.uint8)
