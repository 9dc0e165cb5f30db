"""The soft elliptical face prior rasterised from 4 scalars (port of
``ops/prior.py::prior_plane_from_params``)."""

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
