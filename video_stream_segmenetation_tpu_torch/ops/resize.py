"""Linear-interpolation matrices with explicit coordinate conventions
(port of the matrix form of ``ops/resize.py``).

``half_pixel``: src = (dst + 0.5) * in/out - 0.5, taps clamped to the edge
and weights clipped into [0, 1] (Canvas2D drawImage / patched ONNX Resize).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _axis_coords(out_size: int, in_size: int, method: str) -> np.ndarray:
    d = np.arange(out_size, dtype=np.float64)
    if method == "asymmetric":
        return d * (in_size / out_size)
    if method == "half_pixel":
        return (d + 0.5) * (in_size / out_size) - 0.5
    raise ValueError(f"unknown resize method: {method}")


def _linear_taps(out_size: int, in_size: int, method: str):
    src = _axis_coords(out_size, in_size, method)
    x0 = np.floor(src)
    w1 = src - x0
    i0 = np.clip(x0, 0, in_size - 1).astype(np.int32)
    i1 = np.clip(x0 + 1, 0, in_size - 1).astype(np.int32)
    w1 = np.clip(w1, 0.0, 1.0).astype(np.float32)
    return i0, i1, w1


def _nearest_taps(out_size: int, in_size: int, method: str) -> np.ndarray:
    """JS Math.round (round-half-up) nearest taps."""
    src = _axis_coords(out_size, in_size, method)
    return np.clip(np.floor(src + 0.5), 0, in_size - 1).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _interp_matrix(out_size: int, in_size: int, method: str) -> np.ndarray:
    """Dense [out, in] f32 linear-interpolation matrix (<= 2 nonzeros a row)."""
    i0, i1, w1 = _linear_taps(out_size, in_size, method)
    m = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    np.add.at(m, (rows, i0), 1.0 - w1)
    np.add.at(m, (rows, i1), w1)
    m.flags.writeable = False
    return m


def interp_matrix(out_size: int, in_size: int, method: str, device="cpu") -> torch.Tensor:
    """:func:`_interp_matrix` as a new f32 tensor on ``device``."""
    return torch.tensor(_interp_matrix(out_size, in_size, method), device=device)
