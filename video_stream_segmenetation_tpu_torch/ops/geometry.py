"""Procrustes similarity solve, letterboxing and box utilities (port of
``ops/geometry.py``: estimateAffineFromLandmarks, toSquareLetterbox and
cropFaceROI of the reference client)."""

from __future__ import annotations

import torch

from video_stream_segmenetation_tpu_torch.ops.consts import device_const

# the 5 FaceMesh anchor landmarks: eye outer corners, nose tip, inner lips
ANCHOR_IDXS = (33, 263, 1, 13, 14)

# canonical face layout in normalized coordinates
REF_NORM = (
    (0.35, 0.40),  # right eye
    (0.65, 0.40),  # left eye
    (0.50, 0.55),  # nose tip
    (0.58, 0.70),  # mouth right
    (0.42, 0.70),  # mouth left
)


def estimate_similarity_transform(dst_pts: torch.Tensor, ref_pts: torch.Tensor):
    """2-D Procrustes similarity ``dst ~= s R ref + t``: centroids, scale
    ``sqrt(sum|dst_c|^2 / sum|ref_c|^2)``, rotation ``atan2(Sxy, Sxx)``,
    then translation.  ``[..., N, 2]`` -> ``[..., 6]`` = (a11, a12, tx,
    a21, a22, ty)."""
    c_ref = ref_pts.mean(dim=-2)
    c_dst = dst_pts.mean(dim=-2)
    ref_c = ref_pts - c_ref[..., None, :]
    dst_c = dst_pts - c_dst[..., None, :]
    ref_norm = (ref_c * ref_c).sum(dim=(-2, -1))
    dst_norm = (dst_c * dst_c).sum(dim=(-2, -1))
    sxx = (ref_c[..., 0] * dst_c[..., 0] + ref_c[..., 1] * dst_c[..., 1]).sum(-1)
    sxy = (-ref_c[..., 1] * dst_c[..., 0] + ref_c[..., 0] * dst_c[..., 1]).sum(-1)
    theta = torch.atan2(sxy, sxx)
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    s = torch.sqrt(dst_norm / torch.clamp(ref_norm, min=1e-12))
    tx = c_dst[..., 0] - (s * (cos_t * c_ref[..., 0] - sin_t * c_ref[..., 1]))
    ty = c_dst[..., 1] - (s * (sin_t * c_ref[..., 0] + cos_t * c_ref[..., 1]))
    return torch.stack([s * cos_t, -s * sin_t, tx, s * sin_t, s * cos_t, ty], dim=-1)


def affine_video_to_mask(affine_v: torch.Tensor, video_hw, mask_hw,
                         mode: str = "exact") -> torch.Tensor:
    """Video-pixel affine -> mask-pixel affine.  ``mode='exact'``: the
    conjugation by ``S = diag(sx, sy)`` (the intended map);
    ``'reference'``: the reference application's own, which scales only
    tx and ty and keeps the linear part in video units."""
    vh, vw = video_hw
    mh, mw = mask_hw
    sx, sy = mw / vw, mh / vh
    a11, a12, tx, a21, a22, ty = affine_v.unbind(-1)
    if mode == "reference":
        return torch.stack([a11, a12, tx * sx, a21, a22, ty * sy], dim=-1)
    if mode != "exact":
        raise ValueError(f"unknown mode: {mode}")
    return torch.stack([a11, a12 * (sx / sy), tx * sx, a21 * (sy / sx), a22, ty * sy],
                       dim=-1)


def affine_from_landmarks(points_full: torch.Tensor, video_hw, mask_hw,
                          mode: str = "exact") -> torch.Tensor:
    """468 landmark positions in video pixels ``[..., 468, 2]`` -> the
    mask-space affine of the 5 anchors against :data:`REF_NORM` (``mode``:
    :func:`affine_video_to_mask`'s)."""
    vh, vw = video_hw
    dev = points_full.device
    idx = device_const("anchor_idxs", dev, lambda: torch.tensor(ANCHOR_IDXS))
    dst = torch.index_select(points_full, -2, idx)
    ref = device_const(("ref_norm", vw, vh, points_full.dtype), dev, lambda: torch.tensor(
        [(x * vw, y * vh) for x, y in REF_NORM], dtype=points_full.dtype))
    affine_v = estimate_similarity_transform(dst, ref.expand(dst.shape))
    return affine_video_to_mask(affine_v, video_hw, mask_hw, mode)


def letterbox_params(src_hw, target: int):
    """Static letterbox geometry: ``scale = min(t/w, t/h)``, ``draw =
    max(1, round(src*scale))``, ``offset = (t - draw) // 2``.  Returns
    (scale, draw_w, draw_h, off_x, off_y) as Python numbers."""
    src_h, src_w = src_hw
    scale = min(target / src_w, target / src_h)
    draw_w = max(1, round(src_w * scale))
    draw_h = max(1, round(src_h * scale))
    return scale, draw_w, draw_h, (target - draw_w) // 2, (target - draw_h) // 2


def letterbox_inverse_map(pts: torch.Tensor, src_hw, target: int) -> torch.Tensor:
    """Letterboxed square coordinates ``[..., 2]`` (x, y) -> source pixels:
    ``(pt - offset) / scale``."""
    scale, _, _, off_x, off_y = letterbox_params(src_hw, target)
    off = device_const(("letterbox_off", off_x, off_y, pts.dtype), pts.device,
                       lambda: torch.tensor([off_x, off_y], dtype=pts.dtype))
    return (pts - off) / scale


def pad_box(box: torch.Tensor, pad_ratio: float, frame_hw) -> torch.Tensor:
    """Grow ``box [..., 4]`` = (x0, y0, x1, y1) by ``pad_ratio`` a side,
    floor/ceil to whole pixels, clamp to the frame, at least 1 px wide."""
    fh, fw = frame_hw
    x0, y0, x1, y1 = box.unbind(-1)
    px = (x1 - x0) * pad_ratio
    py = (y1 - y0) * pad_ratio
    nx0 = torch.clamp(torch.floor(x0 - px), min=0.0)
    ny0 = torch.clamp(torch.floor(y0 - py), min=0.0)
    nx1 = torch.clamp(torch.ceil(x1 + px), max=float(fw))
    ny1 = torch.clamp(torch.ceil(y1 + py), max=float(fh))
    nx1 = torch.maximum(nx1, nx0 + 1.0)
    ny1 = torch.maximum(ny1, ny0 + 1.0)
    return torch.stack([nx0, ny0, nx1, ny1], dim=-1)
