"""Temporal filters and the affine low-pass (port of ``ops/temporal.py``)."""

from __future__ import annotations

import torch

from video_stream_segmenetation_tpu_torch.runtime.config import (
    EMA_ADAPT_T0,
    EMA_ADAPT_T1,
)


def _per_stream(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.reshape(v.shape + (1,) * (like.ndim - v.ndim))


def temporal_ema(prev, current, ema, initialized, adapt=None):
    """EMA with the reference's first-frame copy, plus the motion-adaptive
    gate: the effective EMA is ``ema * (1 - adapt * m)``, m ramping 0 -> 1
    as ``|current - prev|`` crosses [EMA_ADAPT_T0, EMA_ADAPT_T1].
    ``ema``/``adapt``/``initialized`` are ``[S]``.  Returns (new_prev, out),
    which are the same tensor."""
    k = _per_stream(ema.to(current.dtype), current)
    init = _per_stream(initialized, current)
    if adapt is not None:
        ad = _per_stream(adapt.to(current.dtype), current)
        d = torch.abs(current - prev)
        m = torch.clamp(
            (d - EMA_ADAPT_T0) * (1.0 / (EMA_ADAPT_T1 - EMA_ADAPT_T0)), 0.0, 1.0
        )
        k = k * (1.0 - ad * m)
    blended = k * prev + (1.0 - k) * current
    new_prev = torch.where(init, blended, current)
    return new_prev, new_prev


def hole_filling_ema(prev, current, ema, initialized, hole_threshold: float = 0.1,
                     hole_margin: float = 0.2, decay: float = 0.90):
    """The reference's documented alternative temporal filter
    (frameProcessor_branch.ts:155-180): where the current pixel is a
    sudden hole (``current < hole_threshold`` while ``prev >
    hole_threshold + hole_margin``) the previous value decays by
    ``decay`` instead of the EMA blend.  ``ema``/``initialized`` are
    ``[S]``.  Returns (new_prev, out), which are the same tensor."""
    k = _per_stream(ema.to(current.dtype), current)
    init = _per_stream(initialized, current)
    is_hole = (current < hole_threshold) & (prev > hole_threshold + hole_margin)
    blended = torch.where(is_hole, prev * decay, k * prev + (1 - k) * current)
    new_prev = torch.where(init, blended, current)
    return new_prev, new_prev


def affine_lowpass(last, update, gain, has_last, has_update):
    """lastAffine = lerp(lastAffine, update, gain) when an update arrives,
    the update itself when there was none yet (main.ts:77-94)."""
    g = torch.full((), gain, dtype=last.dtype, device=last.device)
    merged = last * (1.0 - g) + update * g
    taken = torch.where(has_last[:, None], merged, update)
    new_last = torch.where(has_update[:, None], taken, last)
    return new_last, has_last | has_update
