"""Detector post-processing: anchors, anchor decode, best box (port of
``ops/detect.py``; the reference client's runFaceDetector takes the
argmax-score anchor with no NMS)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from video_stream_segmenetation_tpu_torch.ops.consts import device_const
from video_stream_segmenetation_tpu_torch.ops.geometry import letterbox_inverse_map


@functools.lru_cache(maxsize=None)
def blazeface_anchors(input_size: int = 256) -> np.ndarray:
    """``[A, 2]`` normalized anchor centres: an (in/16)^2 grid with 2
    anchors a cell, then an (in/32)^2 grid with 6 (896 at 256, 224 at
    128)."""
    anchors = []
    for grid, per_cell in ((input_size // 16, 2), (input_size // 32, 6)):
        for gy in range(grid):
            for gx in range(grid):
                anchors.extend([((gx + 0.5) / grid, (gy + 0.5) / grid)] * per_cell)
    a = np.asarray(anchors, dtype=np.float32)
    a.flags.writeable = False
    return a


def decode_anchor_boxes(raw: torch.Tensor, anchors: torch.Tensor,
                        input_size: int = 256) -> torch.Tensor:
    """Raw SSD regressions ``[..., A, 16]`` (dcx, dcy, w, h, 6 keypoints,
    in input pixels from the anchor centre) -> normalized corner boxes and
    keypoints ``[..., A, 16]`` = (x0, y0, x1, y1, kp...)."""
    scale = float(input_size)
    cx = anchors[..., 0] + raw[..., 0] / scale
    cy = anchors[..., 1] + raw[..., 1] / scale
    w = raw[..., 2] / scale
    h = raw[..., 3] / scale
    kps = raw[..., 4:16].reshape(raw.shape[:-1] + (6, 2))
    kpx = anchors[..., None, 0] + kps[..., 0] / scale
    kpy = anchors[..., None, 1] + kps[..., 1] / scale
    kp = torch.stack([kpx, kpy], dim=-1).reshape(raw.shape[:-1] + (12,))
    box = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)
    return torch.cat([box, kp], dim=-1)


def best_box_decode(coords: torch.Tensor, scores: torch.Tensor, video_hw,
                    input_size: int = 256, letterboxed: bool = True):
    """Argmax-over-anchors decode, batched.  coords ``[..., A, 16]``
    normalized, scores ``[..., A]``.  Returns (box ``[..., 4]`` in video
    pixels, score ``[...]``, valid ``[...]`` bool).  Ties go to the first
    anchor; valid means a strictly positive box after clamping."""
    vh, vw = video_hw
    # torch.argmax returns the first maximal index, as jnp.argmax does
    best = torch.argmax(scores, dim=-1)
    score = torch.gather(scores, -1, best[..., None])[..., 0]
    idx = best[..., None, None].expand(best.shape + (1, coords.shape[-1]))
    box_n = torch.gather(coords, -2, idx)[..., 0, :4]
    p = box_n * input_size
    p0, p1 = p[..., 0:2], p[..., 2:4]
    if letterboxed:
        p0 = letterbox_inverse_map(p0, video_hw, input_size)
        p1 = letterbox_inverse_map(p1, video_hw, input_size)
    else:
        s = device_const(("box_scale", vw, vh, input_size, p0.dtype), p0.device,
                         lambda: torch.tensor([vw / input_size, vh / input_size],
                                              dtype=p0.dtype))
        p0, p1 = p0 * s, p1 * s
    x0 = torch.clamp(p0[..., 0], 0, vw)
    y0 = torch.clamp(p0[..., 1], 0, vh)
    x1 = torch.clamp(p1[..., 0], 0, vw)
    y1 = torch.clamp(p1[..., 1], 0, vh)
    valid = (x1 > x0) & (y1 > y0)
    return torch.stack([x0, y0, x1, y1], dim=-1), score, valid
