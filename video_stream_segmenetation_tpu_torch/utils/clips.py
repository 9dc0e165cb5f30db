"""Clip harness: synthetic webcam clips + mask-parity metrics (port of the
reference's ``utils/clips.py``; ``articulated_clip`` waits for
``train/person.py``, ROADMAP Queue 1 item 7).

SURVEY.md §4: the reference has no tests and no oracles; the rebuild's
quality harness is (a) golden op tests (tests/), and (b) a recorded-clip
IoU-parity harness -- run a clip through the pipeline and compare masks
against a reference (BASELINE.json metric "mask IoU parity >= 0.99").

Since the reference's matting weights are not in its repo (SURVEY.md
§2.7), the parity harness accepts ANY reference masks (e.g. exported from
the original MODNet elsewhere) as an .npz; until such masks exist, the
synthetic-clip generator provides ground truth for end-to-end regression
tests (temporal stability, IoU vs the clip's own alpha).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticClip:
    frames: np.ndarray  # [T, H, W, 3] uint8
    alpha: np.ndarray  # [T, H, W] float32 ground truth
    head_box: np.ndarray | None = None  # [T, 4] px (the reference's articulated_clip)


def synthetic_clip(
    n_frames: int = 30,
    hw: tuple[int, int] = (144, 256),
    seed: int = 0,
    motion: float = 1.5,
) -> SyntheticClip:
    """A 'webcam' clip: textured moving person-ellipse over a static
    noisy background, with soft matte edges."""
    h, w = hw
    rng = np.random.default_rng(seed)
    bg = (rng.random((h, w, 3)) * 60 + 20).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)

    frames = np.zeros((n_frames, h, w, 3), np.uint8)
    alphas = np.zeros((n_frames, h, w), np.float32)
    cx0, cy0 = w * 0.5, h * 0.62
    rx, ry = w * 0.18, h * 0.42
    tex = (rng.random((h, w, 3)) * 40).astype(np.float32)
    for t in range(n_frames):
        cx = cx0 + motion * 6.0 * np.sin(t * 0.21)
        cy = cy0 + motion * 3.0 * np.cos(t * 0.17)
        d = np.sqrt(((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2)
        a = np.clip((1.05 - d) / 0.1, 0.0, 1.0)  # soft edge
        person = np.array([165.0, 125.0, 105.0]) + tex
        frame = person * a[..., None] + bg * (1 - a[..., None])
        noise = rng.normal(0, 4.0, (h, w, 3))
        frames[t] = np.clip(frame + noise, 0, 255).astype(np.uint8)
        alphas[t] = a
    return SyntheticClip(frames=frames, alpha=alphas)


def mask_iou(pred: np.ndarray, ref: np.ndarray, thresh: float = 0.5) -> np.ndarray:
    """Per-frame binary IoU, [T]."""
    p = pred > thresh
    r = ref > thresh
    inter = (p & r).sum(axis=(-2, -1)).astype(np.float64)
    union = (p | r).sum(axis=(-2, -1)).astype(np.float64)
    return np.where(union > 0, inter / union, 1.0)


def temporal_stability(masks: np.ndarray, thresh: float = 0.5) -> float:
    """Mean fraction of pixels whose binary label is stable frame-to-frame
    (1.0 = perfectly stable) -- the quality the temporal EMA chain buys."""
    b = masks > thresh
    if len(b) < 2:
        return 1.0
    flips = np.logical_xor(b[1:], b[:-1]).mean(axis=(-2, -1))
    return float(1.0 - flips.mean())


def run_clip_through_engine(engine, clip: SyntheticClip, stream: int = 0) -> np.ndarray:
    """Feed a clip through one engine stream; returns masks [T, h, w] at
    mask resolution (upscaled comparisons are the caller's choice)."""
    s = engine.num_streams
    fh, fw = engine.statics.frame_hw
    assert clip.frames.shape[1:3] == (fh, fw), "clip/frame geometry mismatch"
    masks = []
    batch = np.zeros((s, fh, fw, 3), np.uint8)
    for t in range(len(clip.frames)):
        batch[stream] = clip.frames[t]
        out = engine.process(batch)
        masks.append(out["alpha"][stream].float().cpu().numpy())
    return np.stack(masks)


def parity_report(pred_masks: np.ndarray, ref_masks: np.ndarray) -> dict:
    """The BASELINE.json parity metric surface."""
    ious = mask_iou(pred_masks, ref_masks)
    return {
        "iou_mean": float(ious.mean()),
        "iou_min": float(ious.min()),
        "iou_p05": float(np.percentile(ious, 5)),
        "temporal_stability": temporal_stability(pred_masks),
        "frames": int(len(ious)),
    }


def load_reference_masks(path: str) -> np.ndarray:
    """Load reference masks from an .npz with key 'masks' ([T, H, W]) --
    the import side of the parity harness."""
    with np.load(path) as z:
        return z["masks"]
