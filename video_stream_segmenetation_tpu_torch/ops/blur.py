"""Planar Gaussian blur as two banded matrix products (port of
``ops/blur.py::_gaussian_kernel``, ``_blur_matrix`` and
``gaussian_blur_planar_mxu``), for the multi-class composite's blurred
background class (ops/layout.py::multiclass_composite_s2d).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _gaussian_kernel(sigma: float, radius: int | None = None) -> np.ndarray:
    if radius is None:
        radius = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _blur_matrix(size: int, sigma: float, radius: int | None = None) -> np.ndarray:
    """Dense banded ``[size, size]`` 1-D Gaussian matrix with edge-replicate
    boundary handling (the taps of a 'same' convolution whose padding
    repeats the edge)."""
    k = _gaussian_kernel(sigma, radius)
    r = len(k) // 2
    m = np.zeros((size, size), np.float32)
    for i in range(size):
        for j, kv in enumerate(k):
            m[i, min(max(i + j - r, 0), size - 1)] += kv
    m.flags.writeable = False
    return m


def gaussian_blur_planar_mxu(plane: torch.Tensor, sigma: float,
                             radius: int | None = None) -> torch.Tensor:
    """Gaussian blur of ``[..., H, W]`` (no channel axis; the caller keeps
    channels as a leading axis) as ``B_h @ x`` then ``@ B_w^T``, in f32 (the
    reference's precision on the CPU; on the card it needs TF32 off, which
    the engine pins, runtime/precision.py)."""
    h, w = plane.shape[-2], plane.shape[-1]
    dev = plane.device
    bh = torch.tensor(_blur_matrix(h, float(sigma), radius), device=dev)
    bw = torch.tensor(_blur_matrix(w, float(sigma), radius), device=dev)
    x = plane if plane.is_floating_point() else plane.to(torch.float32)
    x = torch.matmul(bh.to(x.dtype), x)
    return torch.matmul(x, bw.to(x.dtype).t())
