"""Bilinear and nearest resizes with explicit coordinate conventions (port
of ``ops/resize.py``): interpolation matrices, the gather and matrix forms
of the separable resize, the nearest gathers, and the gather and matrix
forms of the face path's ROI crop.

``asymmetric``: src = dst * in/out (tf.js resizeBilinear's default);
``half_pixel``: src = (dst + 0.5) * in/out - 0.5 (Canvas2D drawImage /
patched ONNX Resize); ``align_corners``: src = dst * (in - 1)/(out - 1), 0
where out is 1 (the reference client's bilinearUpscale).  Taps are clamped
to the edge and weights clipped into [0, 1].
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from video_stream_segmenetation_tpu_torch.ops.consts import device_const


def _axis_coords(out_size: int, in_size: int, method: str) -> np.ndarray:
    d = np.arange(out_size, dtype=np.float64)
    if method == "asymmetric":
        return d * (in_size / out_size)
    if method == "half_pixel":
        return (d + 0.5) * (in_size / out_size) - 0.5
    if method == "align_corners":
        if out_size == 1:
            return np.zeros((1,), dtype=np.float64)
        return d * (in_size - 1) / (out_size - 1)
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
    """:func:`_interp_matrix` as an f32 tensor on ``device``, kept there
    (ops/consts.py: callers must not write to it)."""
    return device_const(("interp", out_size, in_size, method), device,
                        lambda: _interp_matrix(out_size, in_size, method))


def _resize_axis_linear(x: torch.Tensor, axis: int, out_size: int, method: str,
                        convert=None):
    """Two-tap resize along ``axis``; ``convert`` (if given) is applied to
    what the gathers take, before the blend."""
    convert = convert or (lambda t: t)
    in_size = x.shape[axis]
    if in_size == out_size and method != "half_pixel":
        return convert(x)
    key = ("taps", out_size, in_size, method)
    i0, i1, w1 = (device_const(key + (n,), x.device, lambda n=n: np.asarray(
        _linear_taps(out_size, in_size, method)[n], np.int64 if n < 2 else np.float32))
        for n in range(3))
    lo = convert(torch.index_select(x, axis, i0))
    hi = convert(torch.index_select(x, axis, i1))
    shape = [1] * x.ndim
    shape[axis] = out_size
    w = w1.to(lo.dtype).reshape(shape)
    return lo * (1 - w) + hi * w


def resize_bilinear(img: torch.Tensor, out_hw, method: str = "asymmetric",
                    channel_last: bool = True) -> torch.Tensor:
    """Separable bilinear resize of ``[..., H, W, C]`` (or ``[..., H, W]``
    with ``channel_last=False``) as two-tap gathers (port of
    ``resize_bilinear``)."""
    h_axis = img.ndim - (3 if channel_last else 2)
    out = _resize_axis_linear(img, h_axis, out_hw[0], method)
    return _resize_axis_linear(out, h_axis + 1, out_hw[1], method)


def resize_frames_u8(frames_u8: torch.Tensor, out_hw, method: str = "asymmetric"):
    """:func:`resize_bilinear` of ``frames_u8 / 255`` (``[..., H, W, C]`` u8
    -> f32), bit for bit, with the division applied to the rows the first
    pass gathers: the full-resolution f32 frames are never made."""
    h_axis = frames_u8.ndim - 3
    rows = _resize_axis_linear(frames_u8, h_axis, out_hw[0], method,
                               convert=lambda t: t.to(torch.float32) / 255.0)
    return _resize_axis_linear(rows, h_axis + 1, out_hw[1], method)


def resize_nearest(img: torch.Tensor, out_hw, method: str = "asymmetric",
                   channel_last: bool = True) -> torch.Tensor:
    """Nearest-neighbour resize of ``[..., H, W, C]`` (or ``[..., H, W]``)
    with the same coordinate conventions, round half up (port of
    ``resize_nearest``): two gathers, any dtype (the ``fast`` preset's u8
    guide), bit for bit."""
    h_axis = img.ndim - (3 if channel_last else 2)
    for axis, out_size in ((h_axis, out_hw[0]), (h_axis + 1, out_hw[1])):
        in_size = img.shape[axis]
        idx = device_const(("nearest", out_size, in_size, method), img.device,
                           lambda n=out_size, m=in_size: _nearest_taps(n, m, method))
        img = torch.index_select(img, axis, idx)
    return img


def resize_bilinear_mxu(img: torch.Tensor, out_hw, method: str = "asymmetric",
                        channel_last: bool = True, bf16_pass: bool = False) -> torch.Tensor:
    """The same taps as :func:`resize_bilinear`, as two interpolation
    products ``A_h @ img @ A_w^T`` (port of ``resize_bilinear_mxu``): f32,
    the reference's HIGHEST precision (f32 products need TF32 off, which
    the engine pins for its steps, runtime/precision.py); with
    ``bf16_pass`` the TPU's DEFAULT precision, one bf16 pass: each
    product's operands rounded to bf16, its sums and result f32."""
    h_axis = img.ndim - (3 if channel_last else 2)
    in_h, in_w = img.shape[h_axis], img.shape[h_axis + 1]
    dev = img.device
    a_h = interp_matrix(out_hw[0], in_h, method, device=dev)
    a_w = interp_matrix(out_hw[1], in_w, method, device=dev)
    x = img if img.is_floating_point() else img.to(torch.float32)
    a_h, a_w = a_h.to(x.dtype), a_w.to(x.dtype)
    rnd = (lambda t: t.to(torch.bfloat16).to(t.dtype)) if bf16_pass else (lambda t: t)
    if channel_last:
        x = torch.einsum("oh,...hwc->...owc", rnd(a_h), rnd(x))
        return torch.einsum("pw,...hwc->...hpc", rnd(a_w), rnd(x))
    x = torch.einsum("oh,...hw->...ow", rnd(a_h), rnd(x))
    return torch.einsum("pw,...hw->...hp", rnd(a_w), rnd(x))


def crop_and_resize(img: torch.Tensor, box: torch.Tensor, out_hw,
                    fill: float = 0.0) -> torch.Tensor:
    """Crop ``box [K, 4]`` = (x0, y0, x1, y1) float pixels out of ``img
    [K, H, W, C]`` and resample it to ``out_hw`` with half-pixel bilinear
    taps as two-tap gathers (port of ``crop_and_resize``, batched over K as
    the reference's ``vmap``): edge-clamped taps, samples outside the
    frame read ``fill``."""
    k, h, w, _ = img.shape
    out_h, out_w = out_hw
    dev = img.device
    bw = torch.clamp(box[:, 2] - box[:, 0], min=1e-6)[:, None]
    bh = torch.clamp(box[:, 3] - box[:, 1], min=1e-6)[:, None]
    ar_h = torch.arange(out_h, dtype=torch.float32, device=dev)
    ar_w = torch.arange(out_w, dtype=torch.float32, device=dev)
    ys = box[:, 1:2] + (ar_h + 0.5) * (bh / out_h) - 0.5  # [K, out_h]
    xs = box[:, 0:1] + (ar_w + 0.5) * (bw / out_w) - 0.5  # [K, out_w]

    def taps(coords, size):
        c0 = torch.floor(coords)
        frac = (coords - c0).to(img.dtype)
        i0 = torch.clamp(c0, 0, size - 1).long()
        i1 = torch.clamp(c0 + 1, 0, size - 1).long()
        return i0, i1, frac, (coords >= -0.5) & (coords <= size - 0.5)

    yi0, yi1, fy, vy = taps(ys, h)
    xi0, xi1, fx, vx = taps(xs, w)
    kk = torch.arange(k, device=dev)[:, None]
    row = img[kk, yi0] * (1 - fy)[..., None, None] + img[kk, yi1] * fy[..., None, None]
    ku = kk[:, :, None]
    uu = torch.arange(out_h, device=dev)[None, :, None]
    out = (row[ku, uu, xi0[:, None, :]] * (1 - fx)[:, None, :, None]
           + row[ku, uu, xi1[:, None, :]] * fx[:, None, :, None])
    valid = (vy[:, :, None] & vx[:, None, :])[..., None]
    return torch.where(valid, out, torch.full((), fill, dtype=img.dtype, device=dev))


def crop_and_resize_mxu(img: torch.Tensor, box: torch.Tensor, out_hw,
                        fill: float = 0.0) -> torch.Tensor:
    """Crop ``box [K, 4]`` = (x0, y0, x1, y1) float pixels out of ``img
    [K, H, W, C]`` and resample it to ``out_hw`` with half-pixel bilinear
    taps (port of ``crop_and_resize_mxu``): two products with weight
    matrices built from hat functions ``clip(1 - |src - grid|, 0, 1)``;
    samples outside the frame read ``fill``."""
    k, h, w, _ = img.shape
    out_h, out_w = out_hw
    dev = img.device
    bw = torch.clamp(box[:, 2] - box[:, 0], min=1e-6)[:, None]
    bh = torch.clamp(box[:, 3] - box[:, 1], min=1e-6)[:, None]
    ar_h = torch.arange(out_h, dtype=torch.float32, device=dev)
    ar_w = torch.arange(out_w, dtype=torch.float32, device=dev)
    ys = box[:, 1:2] + (ar_h + 0.5) * (bh / out_h) - 0.5
    xs = box[:, 0:1] + (ar_w + 0.5) * (bw / out_w) - 0.5
    vy = (ys >= -0.5) & (ys <= h - 0.5)
    vx = (xs >= -0.5) & (xs <= w - 0.5)

    def hat(coords, size):  # [K, out] -> [K, out, size]
        s = torch.clamp(coords, 0.0, size - 1.0)[..., None]
        grid = torch.arange(size, dtype=torch.float32, device=dev)
        return torch.clamp(1.0 - torch.abs(s - grid), 0.0, 1.0).to(img.dtype)

    row = torch.einsum("kuh,khwc->kuwc", hat(ys, h), img)
    out = torch.einsum("kvw,kuwc->kuvc", hat(xs, w), row)
    mask = (vy[:, :, None] & vx[:, None, :])[..., None]
    return torch.where(mask, out, torch.full((), fill, dtype=img.dtype, device=dev))
