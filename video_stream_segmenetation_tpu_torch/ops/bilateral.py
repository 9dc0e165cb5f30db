"""Joint (cross) bilateral 3x3 guided by the frame (port of
``ops/bilateral.py``).  The guide rides planar, ``[S, 3, H, W]`` in 0..255
(u8 or float); out-of-bounds neighbours are excluded, so the filter
self-normalises at the plane's edges."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def joint_bilateral3x3(alpha, guide_planar, sigma_spatial, sigma_range):
    """alpha ``[S, H, W]``; sigma_spatial / sigma_range ``[S]``."""
    h, w = alpha.shape[-2:]
    ss = sigma_spatial.to(alpha.dtype)[:, None, None]
    sr = sigma_range.to(alpha.dtype)[:, None, None]
    inv_two_ss2 = 1.0 / (2.0 * ss * ss)
    inv_two_sr2 = 1.0 / (2.0 * sr * sr)
    g = guide_planar.to(alpha.dtype)
    apad = F.pad(alpha, (1, 1, 1, 1))
    gpad = F.pad(g, (1, 1, 1, 1))
    vpad = F.pad(torch.ones((h, w), dtype=alpha.dtype, device=alpha.device), (1, 1, 1, 1))
    sum_w = torch.zeros_like(alpha)
    sum_a = torch.zeros_like(alpha)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            a_n = apad[..., 1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]
            d = gpad[..., 1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w] - g
            range2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
            spatial2 = float(dx * dx + dy * dy)
            wgt = torch.exp(-spatial2 * inv_two_ss2) * torch.exp(-range2 * inv_two_sr2)
            wgt = wgt * vpad[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]
            sum_w = sum_w + wgt
            sum_a = sum_a + wgt * a_n
    return torch.where(sum_w > 0, sum_a / torch.clamp(sum_w, min=1e-30), alpha)
