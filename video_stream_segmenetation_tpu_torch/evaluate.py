"""The variant quality gates (port of ``tools/eval_variants.py`` and
``tools/eval_variants_realistic.py``): each variant preset served through
the Engine, one stream, on trained weights, against ground truth.

    python -m video_stream_segmenetation_tpu_torch.evaluate variants \\
        [--frames 24] [--only CASE] [--tree CASE=PATH ...] [--report FILE] [--device cuda]
    python -m video_stream_segmenetation_tpu_torch.evaluate realistic --photos DIR \\
        [--frames 24] [--only CASE] [--tree CASE=PATH ...] [--report FILE] [--device cuda]

* ``variants`` (the synthetic gate): every case of :data:`CASES` on the
  clip of :func:`device_clip` (a textured person ellipse over a noisy
  static background), moving then static: IoU against the ground truth
  after the :data:`WARM`-frame warm-up, and on the static clip the share
  of pixels whose mask flips from frame to frame (``flicker``);
* ``realistic``: the cases of :data:`REALISTIC` on two articulated clips
  over the photos under ``--photos`` (utils/clips.py::articulated_clip,
  seeds 1 and 2: waving, then occluded and fast): IoU (mean, least, 5th
  percentile) and temporal stability (utils/clips.py::mask_iou,
  temporal_stability).

Both compare at :data:`EVAL_HW` (the masks and the ground truth resized
half-pixel there), so that presets serving other mask geometries compare.
The matting weights are the committed exports (bridge.py::trained_weights),
the face models the Engine's seeded ones (the reference's gates load the
matting checkpoint alone);
``--tree CASE=PATH`` serves a candidate instead (a utils/checkpoint.py
directory or an ``.npz`` export, such as the trees train/realbg.py saves;
a float MatteNetHD tree is quantized for the int8 presets).  A trainer's
candidate is promoted only where both gates pass.  Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.ops.resize import resize_bilinear
from video_stream_segmenetation_tpu_torch.runtime.presets import preset
from video_stream_segmenetation_tpu_torch.service.engine import Engine
from video_stream_segmenetation_tpu_torch.utils.checkpoint import restore_params
from video_stream_segmenetation_tpu_torch.utils.clips import (
    articulated_clip,
    mask_iou,
    temporal_stability,
)

# (case, preset, overrides): the reference's cases, in its order
CASES = (
    ("flagship_fast_int8", "fast_int8", {}),
    ("flagship_fast_int8_lite", "fast_int8_lite", {}),
    ("flagship_fast_int8_micro", "fast_int8_micro", {}),
    ("flagship_fast_int8_nano", "fast_int8_nano", {}),
    ("flagship_fast_int8_pico", "fast_int8_pico", {}),
    ("flagship_fast_int8_femto", "fast_int8_femto", {}),
    ("active", "active", {}),
    ("rvm", "rvm", {}),
    ("u2", "u2", {}),
    ("multiclass", "multiclass", {}),
    ("multiclass_fast", "multiclass_fast", {}),
    ("multiclass_fast_pico", "multiclass_fast_pico", {}),
)
REALISTIC = ("flagship_fast_int8_pico", "active", "rvm", "u2", "multiclass_fast_pico")
EVAL_HW = (288, 512)  # the comparison grid (the reference's historical mask_hw)
WARM = 5  # frames of EMA warm-up left out of the metrics
CLIP_SEED = 11
MOTIONS = (("moving", 1.5), ("static", 0.0))


def say(msg: str) -> None:
    print(msg, flush=True)


# ---- the synthetic clip ---------------------------------------------------


def clip_draws(gen: torch.Generator, hw, n_frames: int) -> dict:
    """The synthetic clip's random draws on ``gen``'s device: the
    background ``bg`` and the person's texture ``tex`` ``[H, W, 3]``
    (uniform), each frame's sensor noise ``noise`` ``[T, H, W, 3]``
    (standard normal; the moving and the static clip share them)."""
    h, w = hw
    dev = gen.device
    return {"bg": torch.rand((h, w, 3), generator=gen, device=dev),
            "tex": torch.rand((h, w, 3), generator=gen, device=dev),
            "noise": torch.randn((n_frames, h, w, 3), generator=gen, device=dev)}


def device_clip(t: int, hw, motion: float, bg: torch.Tensor, tex: torch.Tensor,
                noise: torch.Tensor):
    """Frame ``t`` of the synthetic clip and its alpha, on the draws'
    device: a textured person ellipse whose centre moves ``motion`` times
    a slow Lissajous path, soft edges, over the static noisy background
    (the reference's arithmetic, in its order, f32) -> ``(frame [H, W, 3]
    u8, alpha [H, W] f32)``."""
    h, w = hw
    dev = bg.device
    f32 = torch.float32
    t = torch.tensor(t, dtype=f32, device=dev)
    motion = torch.tensor(motion, dtype=f32, device=dev)
    yy = torch.arange(h, dtype=f32, device=dev)[:, None]
    xx = torch.arange(w, dtype=f32, device=dev)[None, :]
    bg = bg * 60 + 20
    tex = tex * 40
    cx = w * 0.5 + motion * 6.0 * torch.sin(t * 0.21)
    cy = h * 0.62 + motion * 3.0 * torch.cos(t * 0.17)
    # a division by a constant as XLA compiles the reference's: times the
    # constant's f32 reciprocal
    def inv(c):
        return 1.0 / torch.tensor(c, dtype=f32, device=dev)

    d = torch.sqrt(((xx - cx) / (w * 0.18)) ** 2 + ((yy - cy) / (h * 0.42)) ** 2)
    a = torch.clamp((1.05 - d) * inv(0.1), 0.0, 1.0)
    person = torch.tensor([165.0, 125.0, 105.0], device=dev) + tex
    frame = person * a[..., None] + bg * (1 - a[..., None])
    return torch.clamp(frame + noise * 4.0, 0, 255).to(torch.uint8), a


def to_eval(a: torch.Tensor) -> torch.Tensor:
    """A mask ``[h, w]`` resized half-pixel to :data:`EVAL_HW` (as it is
    there)."""
    if tuple(a.shape) == EVAL_HW:
        return a
    return resize_bilinear(a[None], EVAL_HW, method="half_pixel", channel_last=False)[0]


def person_mask(out: dict) -> torch.Tensor:
    """Stream 0's person mask of a step's outputs, f32: the alpha, or for
    K classes one less the background class."""
    if "class_alpha" in out:
        return 1.0 - out["class_alpha"][0][..., 0].float()
    return out["alpha"][0].float()


# ---- the engines ----------------------------------------------------------


def case_engine(preset_name: str, overrides: dict, tree: dict | None = None,
                device="cuda") -> Engine:
    """``Engine(1)`` of the preset on its committed trained matting tree
    (bridge.py::matting_weights), or on the candidate ``tree`` (a float
    MatteNetHD tree quantized for an int8 preset, bridge.params_from_jax);
    the face models the Engine's seeded ones, as the reference's gates
    leave them (they load the matting checkpoint alone)."""
    statics = preset(preset_name, **overrides)
    if tree is None:
        params = bridge.matting_weights(statics)
    elif (statics.matting_input == "native" and statics.matting_precision == "int8"
          and "params" in tree):
        params = bridge.params_from_jax(tree, statics.s2d_block, statics.matting_decoder)
    else:
        params = tree
    return Engine(1, statics, params=params, device=device)


def eval_case(eng: Engine, n_frames: int, draws: dict) -> dict:
    """The synthetic gate on one engine: the moving then the static clip of
    ``draws`` (:func:`clip_draws`), each from a cold stream, every frame's
    face gate open (the reference steps the engine with its gate set):
    ``{"moving": {"iou_mean"}, "static": {"iou_mean", "flicker"}}``."""
    fh, fw = eng.statics.frame_hw
    eng.face_min_interval_s = 0.0
    if not eng.active[0]:
        eng.admit()
    res = {}
    for mode, motion in MOTIONS:
        prev = torch.zeros(EVAL_HW, device=eng.device)
        ious, flicks = [], []
        for t in range(n_frames):
            frame, gt = device_clip(t, (fh, fw), motion, draws["bg"], draws["tex"],
                                    draws["noise"][t])
            gt_small = to_eval(gt)
            a = to_eval(person_mask(eng.process(frame[None])).to(gt.device))
            p, r = a > 0.5, gt_small > 0.5
            inter, union = (p & r).sum().float(), (p | r).sum().float()
            iou = torch.where(union > 0, inter / union.clamp(min=1.0), torch.ones_like(union))
            flick = ((a > 0.5) != (prev > 0.5)).float().mean()
            prev = a
            if t >= WARM:
                ious.append(iou)
                flicks.append(flick)
        ious = torch.stack(ious).cpu().numpy()
        res[mode] = {"iou_mean": float(ious.mean())}
        if mode == "static":
            res[mode]["flicker"] = float(torch.stack(flicks[1:]).mean())
        eng.evict(0)
        eng.admit()
    return res


def realistic_clips(photos, hw, n_frames: int, device="cuda") -> tuple[list, list]:
    """The realistic gate's two clips at frame geometry ``hw`` over the
    photos (at most 8, twice ``hw``): seed 1 waving with a 3 px shake and
    no occluder, seed 2 occluded at 1.5x motion; and each clip's ground
    truth at :data:`EVAL_HW` ``[T, 288, 512]`` (numpy)."""
    from video_stream_segmenetation_tpu_torch.train.realdata import load_background_bank

    bank = load_background_bank(hw, photos, max_images=8, oversample=2)
    clips = [articulated_clip(n_frames, hw, seed=1, bank=bank, wave=True, shake_px=3.0,
                              occluder_p=0.0, device=device),
             articulated_clip(n_frames, hw, seed=2, bank=bank, occluder_p=1.0, motion=1.5,
                              device=device)]
    gts = [resize_bilinear(torch.as_tensor(c.alpha), EVAL_HW, method="half_pixel",
                           channel_last=False).numpy() for c in clips]
    return clips, gts


def realistic_case(eng: Engine, clips: list, gts: list) -> dict:
    """The realistic gate on one engine: each clip from a cold stream
    through ``process``, the masks at :data:`EVAL_HW` after the warm-up
    against the ground truth: ``{"iou_mean", "iou_min", "iou_p05",
    "temporal_stability", "frames"}``."""
    fh, fw = eng.statics.frame_hw
    masks_all, gt_all, stabs = [], [], []
    for clip, gt in zip(clips, gts):
        if eng.active[0]:
            eng.evict(0)
        eng.admit()
        batch = np.zeros((1, fh, fw, 3), np.uint8)
        masks = []
        for t in range(len(clip.frames)):
            batch[0] = clip.frames[t]
            masks.append(to_eval(person_mask(eng.process(batch))).cpu().numpy())
        m = np.stack(masks)[WARM:]
        masks_all.append(m)
        gt_all.append(gt[WARM:])
        stabs.append(temporal_stability(m))
    ious = mask_iou(np.concatenate(masks_all), np.concatenate(gt_all))
    return {"iou_mean": float(ious.mean()), "iou_min": float(ious.min()),
            "iou_p05": float(np.percentile(ious, 5)),
            "temporal_stability": float(np.mean(stabs)), "frames": int(len(ious))}


# ---- the gates ------------------------------------------------------------


def _cases(only, names=None) -> list:
    out = [c for c in CASES if (names is None or c[0] in names)
           and (only is None or c[0] == only)]
    if only is not None and not out:
        raise ValueError(f"no case {only!r}")
    return out


def variants(n_frames: int = 24, only: str | None = None, trees: dict | None = None,
             device="cuda") -> dict:
    """The synthetic gate over :data:`CASES` (``only``: one case;
    ``trees``: candidate trees by case) -> ``{case: result}``."""
    trees = trees or {}
    results = {"n_frames": n_frames}
    for name, pname, overrides in _cases(only):
        eng = case_engine(pname, overrides, trees.get(name), device)
        gen = torch.Generator(device=eng.device).manual_seed(CLIP_SEED)
        draws = clip_draws(gen, eng.statics.frame_hw, n_frames)
        results[name] = eval_case(eng, n_frames, draws)
        say(f"{name} {json.dumps(results[name])}")
    return results


def realistic(photos, n_frames: int = 24, only: str | None = None,
              trees: dict | None = None, device="cuda") -> dict:
    """The realistic gate over :data:`REALISTIC` on the photos under
    ``photos`` -> ``{case: result}``."""
    trees = trees or {}
    results, clips = {"n_frames": n_frames}, {}
    for name, pname, overrides in _cases(only, REALISTIC):
        eng = case_engine(pname, overrides, trees.get(name), device)
        hw = eng.statics.frame_hw
        if hw not in clips:
            clips[hw] = realistic_clips(photos, hw, n_frames, device)
        results[name] = realistic_case(eng, *clips[hw])
        say(f"{name} {json.dumps(results[name])}")
    return results


def load_tree(path) -> dict:
    """A candidate tree: a utils/checkpoint.py directory or an ``.npz``
    export."""
    path = Path(path)
    return restore_params(str(path)) if path.is_dir() else bridge.load_export(path)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("gate", choices=("variants", "realistic"))
    ap.add_argument("--photos", default=None, help="realistic: directory of photographs")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--only", default=None, help="one case")
    ap.add_argument("--tree", action="append", default=[], metavar="CASE=PATH",
                    help="serve a candidate tree for a case")
    ap.add_argument("--report", default=None, help="JSON report (default: stdout only)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    if a.gate == "realistic" and a.photos is None:
        ap.error("realistic needs --photos")
    names = {c[0] for c in CASES}
    for spec in a.tree:
        case, sep, _ = spec.partition("=")
        if not sep or case not in names:
            ap.error(f"--tree {spec!r}: CASE=PATH with a case of {sorted(names)}")
    return a


def main(argv=None) -> dict:
    a = parse_args(argv)
    trees = {case: load_tree(path) for case, _, path in (s.partition("=") for s in a.tree)}
    if a.gate == "variants":
        results = variants(a.frames, a.only, trees, a.device)
    else:
        results = realistic(a.photos, a.frames, a.only, trees, a.device)
    report = {"gate": a.gate, "device": str(a.device), "trees": {s.partition("=")[0]:
              s.partition("=")[2] for s in a.tree}, **results}
    if a.report:
        Path(a.report).write_text(json.dumps(report, indent=2))
        say(f"wrote {a.report}")
    return report


if __name__ == "__main__":
    main()
