"""The natural layout's fused composite as one CUDA kernel
(``csrc/composite_fused.cu``).

Replaces the Pallas kernel
``video_stream_segmenetation_tpu/kernels/composite_fused.py::
fused_composite`` (pallas_call at line 84): the mask-resolution alpha
upsampled to the frame with the bilinear taps of ``method``
(``upsample_method``: 'half_pixel', 'asymmetric' or 'align_corners';
``V @ alpha``, the rows rounded to bf16, then the bf16 horizontal taps with
f32 sums), clipped to [0, 1], blended ``frame * a + bg * (1 - a)`` in u8
units and rounded half up.  The reference reaches it with
``use_fused_composite=True`` on the natural layout when ``H % ROW_BLOCK ==
0`` (``runtime/pipeline.py:837-843, 897-899``; the port's pipeline keeps
that routing).  The taps come in as tables (:func:`_two_taps`), so one
kernel serves every method: the vertical weights f32 as the reference's
``V`` (not exact in bf16 at 'asymmetric' and 'align_corners'), the
horizontal ones rounded to bf16 as its ``Wc``.

Bound on an H100: bytes (frame, background and output u8 plus the alpha,
about 8.9 MB a 720p stream) -- see the source's header for the design.  One
call is one launch and counts once in ``fused_composite.launches``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from video_stream_segmenetation_tpu_torch.kernels import _build
from video_stream_segmenetation_tpu_torch.ops.resize import _interp_matrix, interp_matrix

# the reference's row block: the fused route needs H % ROW_BLOCK == 0
ROW_BLOCK = 80


def fused_composite_plain(frames_u8, alpha, background_u8, method="half_pixel"):
    """Plain PyTorch version, the matrix form at ``method``'s taps: ``V @
    alpha`` with f64 sums rounded to f32 (the two-tap sums of a row: both
    products of f32 weights and values exact in f64, so no order of
    summation rounds them otherwise), the rows rounded to bf16, then their product with
    the bf16-rounded horizontal matrix in f32 (exact products; on the card
    with TF32 off, runtime/precision.py::pinned), clip, blend in u8 units,
    round half up.  frames_u8 ``[S, H, W, 3]`` u8, alpha ``[S, mh, mw]``,
    background_u8 ``[S or 1, H, W, 3]`` u8 -> ``[S, H, W, 3]`` u8."""
    s, h, w, _ = frames_u8.shape
    mh, mw = alpha.shape[-2:]
    dev = frames_u8.device
    v = interp_matrix(h, mh, method, device=dev).double()
    rows = torch.matmul(v, alpha.double()).float()  # [S, H, mw]
    bf = torch.bfloat16
    wt = interp_matrix(w, mw, method, device=dev).to(bf).float().t()  # [mw, W]
    up = torch.clamp(torch.matmul(rows.to(bf).float(), wt), 0.0, 1.0)[..., None]
    out = frames_u8.float() * up + background_u8.float() * (1.0 - up)
    return torch.clamp(torch.floor(out + 0.5), 0, 255).to(torch.uint8)


@functools.lru_cache(maxsize=None)
def _two_taps(out_size: int, in_size: int, method: str):
    """The (at most two) nonzero columns of each row of the interpolation
    matrix: indices ``[out, 2]`` int32 and weights ``[out, 2]`` f32; a row
    with one tap (a clamped edge; at 'align_corners' and 'asymmetric' a
    source on a whole pixel, weight 1) gets a second of weight 0 at the
    same index."""
    m = _interp_matrix(out_size, in_size, method)
    idx = np.zeros((out_size, 2), np.int32)
    wgt = np.zeros((out_size, 2), np.float32)
    for r in range(out_size):
        (cols,) = np.nonzero(m[r])
        if not 1 <= len(cols) <= 2:
            raise ValueError(f"interpolation row {r} has {len(cols)} taps")
        idx[r] = (cols[0], cols[-1])
        wgt[r, : len(cols)] = m[r, cols]
    return idx, wgt


@functools.lru_cache(maxsize=None)
def _taps(out_size, in_size, method, device, bf16_weights=False):
    """:func:`_two_taps` as tensors on ``device`` (the weights rounded to
    bf16 with ``bf16_weights``), made once a geometry."""
    idx, wgt = _two_taps(out_size, in_size, method)
    w = torch.tensor(wgt, device=device)
    if bf16_weights:
        w = w.to(torch.bfloat16).float()
    return torch.tensor(idx, device=device), w


def fused_composite(frames_u8: torch.Tensor, alpha: torch.Tensor,
                    background_u8: torch.Tensor, method: str = "half_pixel") -> torch.Tensor:
    """frames_u8 ``[S, H, W, 3]`` u8, alpha ``[S, mh, mw]`` (f32; bf16 is
    read as f32), background_u8 ``[S, H, W, 3]`` or ``[1, H, W, 3]`` u8;
    ``method`` the upsample's taps ('half_pixel', 'asymmetric',
    'align_corners').
    Returns the composited ``[S, H, W, 3]`` u8.  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    alpha = alpha.to(torch.float32)
    if frames_u8.device.type == "cpu":
        return fused_composite_plain(frames_u8, alpha, background_u8, method)
    s, h, w, c = frames_u8.shape
    mh, mw = alpha.shape[-2:]
    dev = frames_u8.device
    for name, t, dt, shape in (
        ("frames", frames_u8, torch.uint8, (s, h, w, 3)),
        ("alpha", alpha, torch.float32, (s, mh, mw)),
        ("background", background_u8, torch.uint8, (background_u8.shape[0], h, w, 3)),
    ):
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous() \
                or t.device != dev:
            raise ValueError(f"fused_composite: {name} must be contiguous {dt} {shape} "
                             f"on {dev}")
    if background_u8.shape[0] not in (1, s):
        raise ValueError(f"fused_composite: background has {background_u8.shape[0]} rows "
                         f"for {s} streams")
    vy, vw = _taps(h, mh, method, dev)
    hx, hw = _taps(w, mw, method, dev, bf16_weights=True)
    out = torch.empty_like(frames_u8)
    bg_stride = 0 if background_u8.shape[0] == 1 else h * w * 3
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(lib, lib.vst_composite(
        frames_u8.data_ptr(), background_u8.data_ptr(), bg_stride, alpha.data_ptr(),
        vy.data_ptr(), vw.data_ptr(), hx.data_ptr(), hw.data_ptr(), out.data_ptr(),
        s, h, w, mh, mw, stream), "composite")
    fused_composite.launches += 1
    return out


fused_composite.launches = 0
