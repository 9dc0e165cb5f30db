"""Separable blurs for the blurred-background composite (port of
``ops/blur.py``): the shifted-slice Gaussian :func:`gaussian_blur` and
:func:`box_blur`, the banded-matrix forms :func:`gaussian_blur_mxu` and
:func:`gaussian_blur_planar_mxu` (the multi-class composite's blurred
class, ops/layout.py::multiclass_composite_s2d), and
:func:`gaussian_blur_auto`, which takes the separable form as the
reference does off a TPU.
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


def _conv_axis(x: torch.Tensor, kernel: np.ndarray, axis: int) -> torch.Tensor:
    """1-D 'same' convolution with edge-replicate padding along ``axis``,
    one tap at a time in the kernel's order (as the reference sums)."""
    r = len(kernel) // 2
    size = x.shape[axis]
    idx = torch.clamp(torch.arange(-r, size + r, device=x.device), 0, size - 1)
    xp = torch.index_select(x, axis, idx)
    out = torch.zeros_like(x)
    for i, kv in enumerate(kernel.tolist()):
        out = out + xp.narrow(axis, i, size) * kv
    return out


def gaussian_blur(img: torch.Tensor, sigma: float, radius: int | None = None) -> torch.Tensor:
    """Separable Gaussian blur of ``[..., H, W, C]`` (channel-last)."""
    k = _gaussian_kernel(float(sigma), radius)
    out = _conv_axis(img, k, img.ndim - 3)
    return _conv_axis(out, k, img.ndim - 2)


@functools.lru_cache(maxsize=None)
def _blur_matrix(size: int, sigma: float, radius: int | None = None) -> np.ndarray:
    """Dense banded ``[size, size]`` 1-D Gaussian matrix with edge-replicate
    boundary handling (the taps of :func:`_conv_axis`)."""
    k = _gaussian_kernel(sigma, radius)
    r = len(k) // 2
    m = np.zeros((size, size), np.float32)
    for i in range(size):
        for j, kv in enumerate(k):
            m[i, min(max(i + j - r, 0), size - 1)] += kv
    m.flags.writeable = False
    return m


def _blur_matrices(h: int, w: int, sigma: float, radius, device, dtype):
    bh = torch.tensor(_blur_matrix(h, float(sigma), radius), device=device, dtype=dtype)
    bw = torch.tensor(_blur_matrix(w, float(sigma), radius), device=device, dtype=dtype)
    return bh, bw


def gaussian_blur_mxu(img: torch.Tensor, sigma: float, radius: int | None = None) -> torch.Tensor:
    """The taps of :func:`gaussian_blur` as two banded matrix products a
    channel plane, in f32 (on the card with TF32 off, which the engine
    pins, runtime/precision.py)."""
    x = img if img.is_floating_point() else img.to(torch.float32)
    bh, bw = _blur_matrices(x.shape[-3], x.shape[-2], sigma, radius, x.device, x.dtype)
    x = torch.einsum("oh,...hwc->...owc", bh, x)
    return torch.einsum("pw,...hwc->...hpc", bw, x)


def gaussian_blur_planar_mxu(plane: torch.Tensor, sigma: float,
                             radius: int | None = None) -> torch.Tensor:
    """Gaussian blur of ``[..., H, W]`` (no channel axis; the caller keeps
    channels as a leading axis) as ``B_h @ x`` then ``@ B_w^T``, in f32 (the
    reference's precision on the CPU; on the card it needs TF32 off, which
    the engine pins, runtime/precision.py)."""
    x = plane if plane.is_floating_point() else plane.to(torch.float32)
    bh, bw = _blur_matrices(x.shape[-2], x.shape[-1], sigma, radius, x.device, x.dtype)
    x = torch.matmul(bh, x)
    return torch.matmul(x, bw.t())


def gaussian_blur_auto(img: torch.Tensor, sigma: float, radius: int | None = None) -> torch.Tensor:
    """:func:`gaussian_blur`: the reference takes the banded products on a
    TPU only, the separable form elsewhere (the dense ``[H, H]`` and ``[W,
    W]`` products do O(H^2 W) work)."""
    return gaussian_blur(img, sigma, radius)


def box_blur(img: torch.Tensor, radius: int) -> torch.Tensor:
    """Separable box blur of ``[..., H, W, C]`` (three passes approximate a
    Gaussian)."""
    k = np.full((2 * radius + 1,), 1.0 / (2 * radius + 1), dtype=np.float32)
    out = _conv_axis(img, k, img.ndim - 3)
    return _conv_axis(out, k, img.ndim - 2)
