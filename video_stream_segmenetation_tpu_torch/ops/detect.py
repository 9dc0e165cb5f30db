"""Detector post-processing: anchors, anchor decode, best box, box IoU and
greedy NMS (port of ``ops/detect.py``; the reference client's
runFaceDetector takes the argmax-score anchor with no NMS; the NMS is the
one baked into ``blaze.onnx``, which utils/onnx_exec.py runs as
:func:`nms_padded`).  The NMS loops have a static trip count and read
nothing back to the host: no ``nonzero``, no ``.item()``, no boolean-mask
indexing."""

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


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU between ``[..., N, 4]`` and ``[..., M, 4]`` corner boxes ->
    ``[..., N, M]`` (0 where the union is empty)."""
    ax0, ay0, ax1, ay1 = (a[..., :, None, i] for i in range(4))
    bx0, by0, bx1, by1 = (b[..., None, :, i] for i in range(4))
    iw = torch.clamp(torch.minimum(ax1, bx1) - torch.maximum(ax0, bx0), min=0)
    ih = torch.clamp(torch.minimum(ay1, by1) - torch.maximum(ay0, by0), min=0)
    inter = iw * ih
    area_a = torch.clamp(ax1 - ax0, min=0) * torch.clamp(ay1 - ay0, min=0)
    area_b = torch.clamp(bx1 - bx0, min=0) * torch.clamp(by1 - by0, min=0)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, torch.zeros((), dtype=inter.dtype,
                                                             device=inter.device))


def _greedy(boxes: torch.Tensor, scores: torch.Tensor, alive: torch.Tensor, n_out: int,
            iou_threshold):
    """``n_out`` rounds of greedy NMS from the ``alive [N]`` candidates:
    each takes the highest-scoring one left (the first on a tie, as
    ``jnp.argmax``), drops it and the boxes overlapping it by more than
    ``iou_threshold``.  Returns the picks ``[n_out]`` and whether each
    found a candidate ``[n_out]``; a round that finds none changes
    nothing."""
    n = boxes.shape[0]
    pos = torch.arange(n, device=boxes.device)
    ninf = torch.full((1,), float("-inf"), dtype=scores.dtype, device=scores.device)
    idxs, oks = [], []
    for _ in range(n_out):
        masked = torch.where(alive, scores, ninf)
        idx = torch.argmax(masked, dim=0, keepdim=True)  # [1]: no 0-d index
        ok = masked.gather(0, idx) > ninf
        suppress = box_iou(boxes.index_select(0, idx), boxes)[0] > iou_threshold
        alive = torch.where(ok, alive & ~suppress & (pos != idx), alive)
        idxs.append(idx)
        oks.append(ok)
    return torch.cat(idxs), torch.cat(oks)


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.3,
        score_threshold: float = 0.5, max_detections: int = 5):
    """Greedy NMS with a static output size (the NMS of ``blaze.onnx``:
    conf_threshold, iou_threshold, max_detections).  boxes ``[N, 4]``,
    scores ``[N]``; a candidate needs ``score >= score_threshold``.
    Returns (boxes ``[K, 4]``, scores ``[K]``, valid ``[K]``), K =
    ``max_detections``, by descending score; invalid slots are zero."""
    idx, ok = _greedy(boxes, scores, scores >= score_threshold, max_detections,
                      iou_threshold)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    return (torch.where(ok[:, None], boxes.index_select(0, idx), zero),
            torch.where(ok, scores.index_select(0, idx), zero), ok)


def nms_padded(boxes: torch.Tensor, scores: torch.Tensor, capacity: int,
               iou_threshold: float, score_threshold: float):
    """Greedy NMS returning padded indices: the static-shape form of ONNX
    NonMaxSuppression.  boxes ``[N, 4]`` corner format (either axis order:
    the IoU is symmetric in it), scores ``[N]``; a candidate needs ``score >
    score_threshold``.  Returns (idx ``[capacity]`` int32, valid
    ``[capacity]`` bool) in descending score order of the kept boxes (an
    invalid slot holds the argmax over no candidate: index 0)."""
    idx, ok = _greedy(boxes, scores, scores > score_threshold, capacity, iou_threshold)
    return idx.to(torch.int32), ok
