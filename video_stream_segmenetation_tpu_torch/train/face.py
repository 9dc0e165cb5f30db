"""Face-model training data and losses (port of ``train/face.py``).

The synthetic matting scenes (train/loop.py) carry a head ellipse; the face
batch draws dark facial features (eyes, mouth, nose) on it at canonical
template positions and returns their geometry, the exact ground truth of
the detector (the head box) and of the 468-landmark regressor (a fixed
canonical template mapped onto the head ellipse; the pipeline reads 5 of
its points for its Procrustes fit).  As train/loop.py's batch, it is split
into draws (:func:`face_draws`, on a ``torch.Generator``) and a render of
them (:func:`render_face_batch`), so that a test can render the
reference's own draws.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from video_stream_segmenetation_tpu_torch.models.facemesh import NUM_LANDMARKS
from video_stream_segmenetation_tpu_torch.train.loop import person_parts, synthetic_draws
from video_stream_segmenetation_tpu_torch.train.losses import clip

# the 5 Procrustes anchor ids and their positions in head-ellipse units
# (u = (x - cx) / hr, v = (y - hy) / (1.25 hr)): eyes, nose tip, lips
ANCHOR_IDS = (33, 263, 1, 13, 14)
ANCHOR_UV = (
    (-0.42, -0.22),  # 33  left eye
    (0.42, -0.22),   # 263 right eye
    (0.0, 0.12),     # 1   nose tip
    (0.0, 0.42),     # 13  upper inner lip
    (0.0, 0.52),     # 14  lower inner lip
)


@functools.lru_cache(maxsize=1)
def face_template_468() -> np.ndarray:
    """[468, 2] canonical landmark layout in head-ellipse units: concentric
    rings filling the face disc, with the 5 Procrustes anchors pinned (the
    reference's template, drawn from the same numpy seed)."""
    rng = np.random.default_rng(468)
    pts = []
    n_rings = 9
    per_ring = NUM_LANDMARKS // n_rings
    for r in range(n_rings):
        rad = 0.15 + 0.8 * (r + 1) / n_rings
        for k in range(per_ring):
            th = 2 * np.pi * (k + 0.5 * (r % 2)) / per_ring
            pts.append((rad * np.cos(th), rad * np.sin(th)))
    while len(pts) < NUM_LANDMARKS:
        pts.append(tuple(rng.uniform(-0.5, 0.5, 2)))
    tpl = np.asarray(pts[:NUM_LANDMARKS], np.float32)
    for i, uv in zip(ANCHOR_IDS, ANCHOR_UV):
        tpl[i] = uv
    return tpl


def face_draws(gen: torch.Generator, batch: int, hw: tuple[int, int]) -> dict:
    """The draws of one face batch: train/loop.py::synthetic_draws and the
    features' darkening ``feat_strength`` ``[B, 1, 1]`` in [0.45, 0.75)."""
    d = synthetic_draws(gen, batch, hw)
    d["feat_strength"] = (torch.rand((batch, 1, 1), generator=gen, device=gen.device) * 0.3
                          + 0.45)
    return d


def render_face_batch(d: dict, hw: tuple[int, int], return_parts: bool = False):
    """``(frame [B, H, W, 3] in [0, 1], box [B, 4] px = the head ellipse's
    bounding box, landmarks [B, 468, 2] px)`` from :func:`face_draws`; with
    ``return_parts`` also the scene's parts ``{a_body, a_head, feat}`` (each
    ``[B, H, W]``), the ground truth of the multi-class trainers."""
    batch = d["cx"].shape[0]
    p = person_parts(d, hw)
    yy, xx, hy, hr, cx = p["yy"], p["xx"], p["hy"], p["hr"], d["cx"]
    alpha = torch.maximum(p["a_body"], p["a_head"])
    fg = d["fg_color"] + d["fg_tex"]

    # facial features: dark ellipses at the anchor template positions
    def feature(u, v, fr_u, fr_v):
        fx = cx + u * hr
        fy = hy + v * (1.25 * hr)
        dist = torch.sqrt(((xx - fx) / (fr_u * hr)) ** 2 + ((yy - fy) / (fr_v * hr)) ** 2)
        return torch.clamp(1.2 - dist, 0.0, 1.0)

    eyes = feature(-0.42, -0.22, 0.16, 0.10) + feature(0.42, -0.22, 0.16, 0.10)
    mouth = feature(0.0, 0.47, 0.34, 0.12)
    nose = feature(0.0, 0.12, 0.09, 0.14)
    dark = torch.clamp(eyes + mouth + 0.6 * nose, 0.0, 1.0)
    fg = fg * (1.0 - (dark * d["feat_strength"])[..., None])

    bg = d["bg_base"] + d["bg_tex"] * d["bg_gain"]
    frame = torch.clamp(fg * alpha[..., None] + bg * (1 - alpha[..., None]) + d["noise"] * 0.02,
                        0, 1)
    box = torch.cat([cx - hr, hy - 1.25 * hr, cx + hr, hy + 1.25 * hr], dim=-1).reshape(batch, 4)
    tpl = torch.as_tensor(face_template_468(), device=cx.device)
    lm_x = cx.reshape(batch, 1) + tpl[None, :, 0] * hr.reshape(batch, 1)
    lm_y = hy.reshape(batch, 1) + tpl[None, :, 1] * (1.25 * hr).reshape(batch, 1)
    landmarks = torch.stack([lm_x, lm_y], dim=-1)
    if return_parts:
        return frame, box, landmarks, {"a_body": p["a_body"], "a_head": p["a_head"],
                                       "feat": dark}
    return frame, box, landmarks


def synthetic_face_batch(gen: torch.Generator, batch: int, hw: tuple[int, int],
                         return_parts: bool = False):
    """:func:`render_face_batch` of fresh draws on ``gen``'s device."""
    return render_face_batch(face_draws(gen, batch, hw), hw, return_parts)


# ---- losses ---------------------------------------------------------------


def _bce(p: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy of probabilities clipped to [1e-6, 1 - 1e-6]
    (``jnp.clip``'s gradient, losses.py::clip)."""
    p = clip(p, 1e-6, 1 - 1e-6)
    return -(target * torch.log(p) + (1 - target) * torch.log(1 - p))


def detector_loss(out: dict, gt_box_norm: torch.Tensor, anchors: torch.Tensor):
    """Anchor classification BCE + corner L1 on the positive anchors.

    ``out``: a FaceFinder dict (decoded normalized corners, sigmoid
    scores); ``gt_box_norm`` ``[B, 4]`` normalized corners; ``anchors``
    ``[A, 2]`` normalized centres.  Positives: anchors whose centre lies
    inside the box; the positive and negative means are balanced."""
    scores = out["box_scores"]
    coords = out["box_coords"][..., :4]
    ax, ay = anchors[:, 0], anchors[:, 1]
    inside = ((ax[None] >= gt_box_norm[:, None, 0]) & (ax[None] <= gt_box_norm[:, None, 2])
              & (ay[None] >= gt_box_norm[:, None, 1]) & (ay[None] <= gt_box_norm[:, None, 3]))
    pos = inside.to(torch.float32)
    bce = _bce(scores, pos)
    n_pos = torch.clamp(pos.sum(), min=1.0)
    n_neg = torch.clamp((1 - pos).sum(), min=1.0)
    cls_loss = (bce * pos).sum() / n_pos + (bce * (1 - pos)).sum() / n_neg
    box_l1 = torch.abs(coords - gt_box_norm[:, None, :])
    box_loss = (box_l1.mean(-1) * pos).sum() / n_pos
    return cls_loss + 5.0 * box_loss, {"cls": cls_loss, "box": box_loss, "pos_frac": pos.mean()}


def landmark_loss(out: dict, gt_lm_roi: torch.Tensor, is_face: torch.Tensor):
    """L1 on the ROI-normalized x, y (faces only) + the presence score's
    BCE."""
    lm = out["landmarks"][..., :2]
    l1 = torch.abs(lm - gt_lm_roi).mean(dim=(-2, -1))
    facef = is_face.to(torch.float32)
    lm_loss = (l1 * facef).sum() / torch.clamp(facef.sum(), min=1.0)
    s_loss = _bce(out["scores"], facef).mean()
    return 10.0 * lm_loss + s_loss, {"lm_l1": lm_loss, "score_bce": s_loss}
