"""3x3 grayscale morphology with the reference's border semantics (port of
``ops/morphology.py``): only interior pixels are written, the 1-px border
of every output is 0.  Inputs are ``[..., H, W]``.  Where autograd records,
every bound is a ``torch.minimum``/``torch.maximum`` in the reference's
order, so that the gradient splits at ties as JAX's does (``torch.clamp``
would not; the pipeline loss differentiates the opening,
train/losses.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _window_reduce(x: torch.Tensor, op: str, pad_value: float) -> torch.Tensor:
    xp = F.pad(x, (1, 1, 1, 1), value=pad_value)
    h, w = x.shape[-2], x.shape[-1]
    acc = None
    for dy in range(3):
        for dx in range(3):
            win = xp[..., dy: dy + h, dx: dx + w]
            if acc is None:
                acc = win
            else:
                acc = torch.minimum(acc, win) if op == "min" else torch.maximum(acc, win)
    return acc


def _min_with(x: torch.Tensor, bound: float) -> torch.Tensor:
    if not x.requires_grad:  # serving: the same values, no bound tensor made
        return torch.clamp(x, max=bound)
    return torch.minimum(x, torch.full((), bound, dtype=x.dtype, device=x.device))


def _max_with(x: torch.Tensor, bound: float) -> torch.Tensor:
    if not x.requires_grad:
        return torch.clamp(x, min=bound)
    return torch.maximum(x, torch.full((), bound, dtype=x.dtype, device=x.device))


def _interior(h: int, w: int, device) -> torch.Tensor:
    m = torch.zeros((h, w), dtype=torch.bool, device=device)
    m[1: h - 1, 1: w - 1] = True
    return m


def erode3x3(alpha: torch.Tensor) -> torch.Tensor:
    h, w = alpha.shape[-2:]
    e = _min_with(_window_reduce(alpha, "min", float("inf")), 1.0)
    return torch.where(_interior(h, w, alpha.device), e, torch.zeros_like(e))


def dilate3x3(alpha: torch.Tensor) -> torch.Tensor:
    h, w = alpha.shape[-2:]
    d = _max_with(_window_reduce(alpha, "max", float("-inf")), 0.0)
    return torch.where(_interior(h, w, alpha.device), d, torch.zeros_like(d))


def morphological_opening(alpha: torch.Tensor) -> torch.Tensor:
    """Erode then dilate; the dilation reads the eroded zero border."""
    return dilate3x3(erode3x3(alpha))


def morphological_closing_in_prior(alpha, prior, has_prior):
    """Dilate then erode where ``prior > 0``, pass-through elsewhere at the
    interior, zero border; streams with ``has_prior [S]`` False return
    ``alpha`` unchanged."""
    h, w = alpha.shape[-2:]
    interior = _interior(h, w, alpha.device)
    in_prior = interior & (prior > 0)
    zero = torch.zeros_like(alpha)
    dil = _max_with(_window_reduce(alpha, "max", float("-inf")), 0.0)
    dilated = torch.where(in_prior, dil, torch.where(interior, alpha, zero))
    ero = _min_with(_window_reduce(dilated, "min", float("inf")), 1.0)
    closed = torch.where(in_prior, ero, torch.where(interior, dilated, zero))
    gate = has_prior.reshape(has_prior.shape + (1, 1))
    return torch.where(gate, closed, alpha)
