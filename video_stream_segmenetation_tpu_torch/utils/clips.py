"""Clip harness: synthetic webcam clips + mask-parity metrics (port of the
reference's ``utils/clips.py``).

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
import torch


@dataclasses.dataclass
class SyntheticClip:
    frames: np.ndarray  # [T, H, W, 3] uint8
    alpha: np.ndarray  # [T, H, W] float32 ground truth
    head_box: np.ndarray | None = None  # [T, 4] px (articulated_clip)


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


def _on(draws: dict, device) -> dict:
    """Draws (tensors or arrays) as f32 tensors on ``device``."""
    return {k: torch.as_tensor(v, dtype=torch.float32).to(device) for k, v in draws.items()}


def articulated_clip(
    n_frames: int = 32,
    hw: tuple[int, int] = (720, 1280),
    seed: int = 0,
    bank: np.ndarray | None = None,
    features: bool = False,
    occluder_p: float = 1.0,
    wave: bool = False,
    shake_px: float = 2.0,
    motion: float = 1.0,
    device="cuda",
    draws: dict | None = None,
) -> SyntheticClip:
    """A webcam clip of an articulated procedural person (train/person.py:
    head and hair fringe, torso, two-segment arms, clothing texture) with
    smooth pose trajectories, camera shake and an optional occluder in
    front: the eval side of the shared train/eval person distribution.

    * ``bank``: a real-photo background bank (train/realdata.py::
      load_background_bank, float ``[N, bh, bw, 3]``); None = a procedural
      background.
    * ``features=True`` paints the face-template features the trained
      FaceFinder fires on and fills ``head_box`` a frame.
    * ``wave=True`` raises the right arm and waves it (fast limb motion).
    * camera shake: a smooth global pan of person, background and occluder.

    The person and the occluder of each frame are rendered on ``device``
    and composited on the host over the panning background; ``draws``
    (``{"ident", "pose", "occ"}`` of batch 1, person.py's draws) replaces
    the draws from a generator seeded ``seed`` on ``device``.  The host's
    part (the trajectories' phases, the background, the shake, the sensor
    noise) comes from ``numpy.random.default_rng(seed)``, as the
    reference's."""
    from video_stream_segmenetation_tpu_torch.train import person

    h, w = hw
    if draws is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        draws = {"ident": person.sample_identity(gen, 1), "pose": person.sample_pose(gen, 1, hw),
                 "occ": person.occluder_draws(gen, 1, hw)}
    ident, occ_d = _on(draws["ident"], device), _on(draws["occ"], device)
    base = {k: v.cpu().numpy() for k, v in _on(draws["pose"], device).items()}
    rng = np.random.default_rng(seed)
    phases = rng.uniform(0, 6.283, size=8)

    # background: a real photo crop or a procedural texture
    if bank is not None:
        img = bank[seed % len(bank)]
        bh, bw = img.shape[:2]
        by0 = rng.integers(8, max(9, bh - h - 8))
        bx0 = rng.integers(8, max(9, bw - w - 8))
    else:
        img = (rng.random((h + 32, w + 32, 3)) * 0.35 + 0.08).astype(np.float32)
        img += rng.random((h + 32, w + 32, 1)) * 0.2
        bh, bw = img.shape[:2]
        by0, bx0 = 16, 16

    frames = np.zeros((n_frames, h, w, 3), np.uint8)
    alphas = np.zeros((n_frames, h, w), np.float32)
    boxes = np.zeros((n_frames, 4), np.float32)
    for t in range(n_frames):
        # smooth pose trajectory
        p = {k: v.copy() for k, v in base.items()}
        p["cx"] = p["cx"] + motion * 0.020 * w * np.sin(0.21 * t + phases[0])
        p["cy_s"] = p["cy_s"] + motion * 0.010 * h * np.cos(0.17 * t + phases[1])
        p["s"] = p["s"] * (1.0 + 0.04 * np.sin(0.07 * t + phases[2]))
        p["lean"] = p["lean"] + 0.05 * np.sin(0.13 * t + phases[3])
        p["head_dx"] = p["head_dx"] + 0.06 * np.sin(0.29 * t + phases[4])
        p["head_bob"] = p["head_bob"] + 0.03 * np.sin(0.37 * t + phases[5])
        p["armL_u"] = p["armL_u"] + 0.08 * np.sin(0.11 * t + phases[6])
        if wave:
            p["armR_u"] = np.full_like(p["armR_u"], 2.25)
            p["armR_u"] += 0.15 * np.sin(0.5 * t + phases[7])
            p["armR_d"] = np.full_like(p["armR_d"], 0.5 + 0.45 * np.sin(0.9 * t))
        # camera shake: an integer global pan
        ox = int(round(shake_px * np.sin(0.9 * t + phases[0])
                       + 0.5 * shake_px * np.sin(2.3 * t + phases[1])))
        oy = int(round(shake_px * np.sin(1.1 * t + phases[2])
                       + 0.5 * shake_px * np.sin(2.9 * t + phases[3])))
        p["cx"] = p["cx"] + ox
        p["cy_s"] = p["cy_s"] + oy
        with torch.no_grad():
            r = person.render(ident, _on(p, device), hw, features=features)
            occ = person.render_occluder(occ_d, hw, p=occluder_p, shift=(float(oy), float(ox)))
        fg_rgb, a_np, occ_np, occ_rgb = (x[0].cpu().numpy() for x in (
            r["rgb"], r["alpha"], occ["alpha"], occ["rgb"]))
        # the background crop pans opposite the camera
        y0 = int(np.clip(by0 - oy, 0, bh - h))
        x0 = int(np.clip(bx0 - ox, 0, bw - w))
        bg = img[y0: y0 + h, x0: x0 + w]
        frame = fg_rgb * a_np[..., None] + bg * (1.0 - a_np[..., None])
        frame = occ_rgb * occ_np[..., None] + frame * (1.0 - occ_np[..., None])
        frame += rng.normal(0, 0.016, frame.shape)
        frames[t] = np.clip(frame * 255.0, 0, 255).astype(np.uint8)
        alphas[t] = a_np * (1.0 - occ_np)
        boxes[t] = r["head_box"][0].cpu().numpy()
    return SyntheticClip(frames=frames, alpha=alphas, head_box=boxes if features else None)


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
