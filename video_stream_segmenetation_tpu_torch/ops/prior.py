"""The soft elliptical face prior: its 4 scalars from a detector box and
its plane rasterised from them (port of ``ops/prior.py::
face_prior_params`` and ``prior_plane_from_params``)."""

from __future__ import annotations

import math

import torch


def prior_pad(mask_hw: tuple[int, int]) -> int:
    """Width of the >= 0.25 edge zone, in mask pixels."""
    mh, mw = mask_hw
    return max(4, int(min(mw, mh) * 0.02))


def prior_plane_from_params(params: torch.Tensor, mask_hw) -> torch.Tensor:
    """params ``[S, 4]`` = (cx, cy, rx, ry) in mask pixels -> ``[S, H, W]``:
    a cosine ramp from 1 at the centre to 0 at the ellipse edge, floored at
    0.25 in the edge zone, 0 outside."""
    mh, mw = mask_hw
    pad = prior_pad(mask_hw)
    dev = params.device
    cx, cy, rx, ry = (params[:, i, None, None] for i in range(4))
    x = torch.arange(mw, dtype=torch.float32, device=dev)[None, None, :]
    y = torch.arange(mh, dtype=torch.float32, device=dev)[None, :, None]
    dx = (x - cx) / rx
    dy = (y - cy) / ry
    d2 = dx * dx + dy * dy
    t = torch.sqrt(torch.clamp(d2, 0.0, 1.0))
    v = 0.5 - 0.5 * torch.cos(math.pi * (1.0 - t))
    edge_zone = d2 > 1.0 - pad / torch.maximum(rx, ry)
    v = torch.where(edge_zone, torch.clamp(v, min=0.25), v)
    return torch.where(d2 <= 1.0, v, torch.zeros_like(v))


def face_prior_params(box_video: torch.Tensor, video_hw, mask_hw) -> torch.Tensor:
    """Detector box ``[..., 4]`` in video pixels -> ``[..., 4]`` = (cx, cy,
    rx, ry) in mask pixels: the box floored/ceiled onto the mask grid,
    radii 0.56 and 0.70 of its width and height."""
    vh, vw = video_hw
    mh, mw = mask_hw
    sx, sy = mw / vw, mh / vh
    x0 = torch.floor(box_video[..., 0] * sx)
    y0 = torch.floor(box_video[..., 1] * sy)
    x1 = torch.ceil(box_video[..., 2] * sx)
    y1 = torch.ceil(box_video[..., 3] * sy)
    rx = torch.clamp((x1 - x0) * 0.56, min=1e-6)
    ry = torch.clamp((y1 - y0) * 0.70, min=1e-6)
    return torch.stack([(x0 + x1) / 2.0, (y0 + y1) / 2.0, rx, ry], dim=-1)
