"""Matting training objectives (port of ``train/losses.py``).

The MODNet decomposition: semantic L2 at the context grid, detail L1 near
boundaries, a foreground-weighted alpha L1 and a composition loss at the
model's output grid; and the serving-chain-aware objective, which scores the
alpha after the refine chain (opening, joint bilateral, threshold/gamma)
with autograd through it.  Every bound is a ``torch.minimum`` /
``torch.maximum`` in the reference's order (``jnp.clip`` is a min of a max),
so that the gradient splits at ties as JAX's does.
"""

from __future__ import annotations

import torch

from video_stream_segmenetation_tpu_torch.ops.bilateral import joint_bilateral3x3
from video_stream_segmenetation_tpu_torch.ops.morphology import morphological_opening
from video_stream_segmenetation_tpu_torch.ops.resize import resize_bilinear
from video_stream_segmenetation_tpu_torch.runtime import config as cfg


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: the maximum with ``lo``, then the minimum with ``hi``."""
    lo_t = torch.full((), lo, dtype=x.dtype, device=x.device)
    hi_t = torch.full((), hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def _boundary_mask(alpha_gt: torch.Tensor, lo: float = 0.05, hi: float = 0.95):
    """Transition region: where the ground truth is neither bg nor fg."""
    return ((alpha_gt > lo) & (alpha_gt < hi)).to(torch.float32)


def matting_loss(outputs: dict, alpha_gt: torch.Tensor, frame: torch.Tensor,
                 fg: torch.Tensor | None = None, bg: torch.Tensor | None = None,
                 w_semantic: float = 1.0, w_detail: float = 10.0, w_alpha: float = 1.0,
                 w_comp: float = 1.0) -> tuple[torch.Tensor, dict]:
    """outputs: a MatteNetHD dict; alpha_gt ``[S, H, W]``; frame ``[S, H, W,
    3]`` in [0, 1].  Returns (scalar loss, metrics dict)."""
    alpha = outputs["alpha"].to(torch.float32)
    # compare at the model's output geometry
    if alpha.shape[-2:] != alpha_gt.shape[-2:]:
        hw = tuple(alpha.shape[-2:])
        alpha_gt = resize_bilinear(alpha_gt, hw, method="half_pixel", channel_last=False)
        frame = resize_bilinear(frame, hw, method="half_pixel")
        if fg is not None:
            fg = resize_bilinear(fg, hw, method="half_pixel")
        if bg is not None:
            bg = resize_bilinear(bg, hw, method="half_pixel")
    h16 = tuple(outputs["semantic"].shape[-2:])
    h4 = tuple(outputs["detail"].shape[-2:])

    sem_gt = resize_bilinear(alpha_gt, h16, method="half_pixel", channel_last=False)
    sem_loss = torch.mean((outputs["semantic"] - sem_gt) ** 2)

    det_gt = resize_bilinear(alpha_gt, h4, method="half_pixel", channel_last=False)
    det_pred = torch.sigmoid(outputs["detail"])
    bmask = _boundary_mask(det_gt)
    det_loss = torch.sum(torch.abs(det_pred - det_gt) * bmask) / (torch.sum(bmask) + 1.0)

    # foreground-weighted L1: persons cover a minority of pixels
    wmap = 1.0 + 4.0 * alpha_gt
    alpha_loss = torch.sum(torch.abs(alpha - alpha_gt) * wmap) / torch.sum(wmap)

    if fg is not None and bg is not None:
        comp_pred = fg * alpha[..., None] + bg * (1 - alpha[..., None])
        comp_loss = torch.mean(torch.abs(comp_pred - frame))
    else:
        # self-composition: predicted vs gt alpha over the frame itself
        comp_loss = torch.mean(torch.abs(frame * alpha[..., None]
                                         - frame * alpha_gt[..., None]))

    total = (w_semantic * sem_loss + w_detail * det_loss + w_alpha * alpha_loss
             + w_comp * comp_loss)
    return total, {"loss": total, "semantic": sem_loss, "detail": det_loss,
                   "alpha": alpha_loss, "composition": comp_loss}


def iou_metric(pred: torch.Tensor, gt: torch.Tensor, thresh: float = 0.5) -> torch.Tensor:
    """Binary mask IoU over the last two axes (1 where both are empty)."""
    p, g = pred > thresh, gt > thresh
    inter = torch.sum(p & g, dim=(-2, -1)).to(torch.float32)
    union = torch.sum(p | g, dim=(-2, -1)).to(torch.float32)
    return torch.where(union > 0, inter / torch.clamp(union, min=1.0),
                       torch.ones_like(union))


def make_pipeline_loss(model, base_weight: float = 0.3, w_l1: float = 1.0,
                       w_iou: float = 1.0):
    """``loss_fn(frames, alpha_gt) -> (loss, metrics)`` that scores
    ``model``'s alpha after the serving refine chain at default knobs, on
    top of ``base_weight`` x :func:`matting_loss` (reference
    ``make_pipeline_loss``: a single-frame approximation, warp and EMA the
    identity on a fresh stream, no face prior).  The stage-9 power takes a
    floor of 1e-6, as the reference's does, so that its gradient stays
    finite at 0."""

    def loss_fn(frames: torch.Tensor, alpha_gt: torch.Tensor):
        out = model(frames)
        base, metrics = matting_loss(out, alpha_gt, frames)
        a = out["alpha"].to(torch.float32)
        mh, mw = a.shape[-2:]
        gt = alpha_gt
        if gt.shape[-2:] != (mh, mw):
            gt = resize_bilinear(gt, (mh, mw), method="half_pixel", channel_last=False)
        guide = torch.floor(resize_bilinear(frames, (mh, mw), method="asymmetric") * 255.0
                            + 0.5).permute(0, 3, 1, 2)
        s = a.shape[0]
        r = morphological_opening(a)
        r = joint_bilateral3x3(
            r, guide, torch.full((s,), cfg.DEFAULT_BILATERAL_SIGMA_SPATIAL, device=a.device),
            torch.full((s,), cfg.DEFAULT_BILATERAL_SIGMA_RANGE, device=a.device))
        low, high = cfg.DEFAULT_NOISE_CUTOFF, cfg.DEFAULT_HIGH_THRESHOLD
        norm = clip((r - low) / (high - low), 0.0, 1.0)
        floor = torch.full((), 1e-6, device=a.device)
        r = torch.pow(torch.maximum(norm, floor), cfg.DEFAULT_GAMMA)
        l1 = torch.abs(r - gt).mean()
        inter = torch.sum(torch.minimum(r, gt), dim=(-2, -1))
        union = torch.sum(torch.maximum(r, gt), dim=(-2, -1))
        soft_iou = (inter / torch.maximum(union, torch.ones_like(union))).mean()
        pipe = w_l1 * l1 + w_iou * (1.0 - soft_iou)
        return base_weight * base + pipe, dict(metrics, pipe_l1=l1, pipe_soft_iou=soft_iou)

    return loss_fn
