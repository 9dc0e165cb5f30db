"""Threshold + gamma transfer with the face-prior clamps (port of
``ops/refine.py``)."""

from __future__ import annotations

import torch

FACE_FLOOR = 0.55  # minFaceFloor, frameProcessorTest.ts:281
NEAR_BG_CAP = 0.35  # maxNearBgCap, :282
NEAR_BG_BLEND = 0.15  # nearBgBlend, :283


def refine_alpha(alpha, low, high, gamma, prior, has_prior):
    """alpha ``[S, H, W]``; low/high/gamma/has_prior ``[S]``; prior
    ``[S, H, W]``.  v <= low -> 0, v >= high -> 1, else
    ((v - low) / max(1e-6, high - low)) ** gamma; where a stream has a prior:
    p > 0.25 -> max(v, min(1, 0.55 p + 0.15)), 0 < p <= 0.25 ->
    min(v, 0.35 + 0.15 p)."""
    lo, hi, g = (t.to(alpha.dtype)[:, None, None] for t in (low, high, gamma))
    denom = torch.clamp(hi - lo, min=1e-6)
    t = torch.clamp((alpha - lo) / denom, 0.0, 1.0)
    mid = torch.pow(t, g)
    zero, one = torch.zeros_like(alpha), torch.ones_like(alpha)
    v = torch.where(alpha <= lo, zero, torch.where(alpha >= hi, one, mid))
    p = prior.to(alpha.dtype)
    floor = torch.clamp(FACE_FLOOR * p + 0.15, max=1.0)
    cap = NEAR_BG_CAP + NEAR_BG_BLEND * p
    clamped = torch.where(
        p > 0.25, torch.maximum(v, floor), torch.where(p > 0, torch.minimum(v, cap), v)
    )
    return torch.where(has_prior[:, None, None], clamped, v)
