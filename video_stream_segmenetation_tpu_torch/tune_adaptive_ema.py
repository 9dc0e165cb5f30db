"""The motion-adaptive EMA tuned on realistic clips (port of
``tools/tune_adaptive_ema.py``).

    python -m video_stream_segmenetation_tpu_torch.tune_adaptive_ema --photos DIR \\
        [--adapts 0,0.5,0.75,1.0] [--t0 T0] [--t1 T1] [--small] [--ckpt NAME] \\
        [--frames 32] [--report FILE] [--device cpu]

Sweeps the per-stream live knob ``ema_adapt`` over the four articulated
clips of parity_matting.py on the photographs under ``--photos``, all from
one engine (the knob is a live row write, no rebuild), and reports for
each value the IoU against the ground truth (mean, least, 5th
percentile), the temporal stability and the :func:`flicker`, after a
warm-up of :data:`WARM` frames a clip.  ``--t0``/``--t1`` move the gate
that the knob scales (runtime/config.py ``EMA_ADAPT_T0/T1``) for the
sweep, so that every step it serves, the refine kernel's included, reads
the moved gate.  The engine is ``fast_int8_pico`` with a
colour background and no face path, on the committed export.  Geometry,
``--small`` and ``--ckpt`` as parity_matting.py's; runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from video_stream_segmenetation_tpu_torch import parity_matting as pm
from video_stream_segmenetation_tpu_torch.runtime import config as cfg
from video_stream_segmenetation_tpu_torch.utils.clips import (
    mask_iou,
    run_clip_through_engine,
    temporal_stability,
)

WARM = 5  # frames of EMA warm-up left out a clip (parity_matting.py's *_vs_gt rows)


def flicker(masks: np.ndarray, thresh: float = 0.5) -> float:
    """Mean share of pixels whose binary label flips from one frame to the
    next (lower is calmer): the "flicker within 2x" guard of the tuning."""
    b = masks > thresh
    if len(b) < 2:
        return 0.0
    return float(np.logical_xor(b[1:], b[:-1]).mean())


def sweep(photos, adapts=(0.0, 0.5, 0.75, 1.0), small: bool = False,
          ckpt: str = pm.DEFAULT_CKPT, n_frames=None, device="cuda") -> dict:
    """``{"adapt=<v>": {iou_mean, iou_min, iou_p05, temporal_stability,
    flicker, per_clip}}`` for each value of ``adapts``, on one engine built
    at runtime/config.py's gate as it stands."""
    frame_hw, mask_hw, t_default, _ = pm.GEOMETRY[small]
    clips, face_clip = pm.clips_of(photos, frame_hw, n_frames or t_default, device)
    clips = clips + [face_clip]
    eng = pm.build_engine(frame_hw=frame_hw, mask_hw=mask_hw, ckpt=ckpt, device=device)
    gts = [pm.ground_truth(c, mask_hw) for c in clips]
    results = {}
    for ad in adapts:
        per_clip, masks_all, gt_all = [], [], []
        for c, gt in zip(clips, gts):
            pm.fresh(eng).set_knobs(0, ema_adapt=ad)
            m = run_clip_through_engine(eng, c)[WARM:]
            ious = mask_iou(m, gt[WARM:])
            per_clip.append({"iou": float(ious.mean()), "min": float(ious.min()),
                             "stab": temporal_stability(m), "flicker": flicker(m)})
            masks_all.append(m)
            gt_all.append(gt[WARM:])
        ious = mask_iou(np.concatenate(masks_all), np.concatenate(gt_all))
        r = results[f"adapt={ad}"] = {
            "iou_mean": float(ious.mean()), "iou_min": float(ious.min()),
            "iou_p05": float(np.percentile(ious, 5)),
            "temporal_stability": float(np.mean([p["stab"] for p in per_clip])),
            "flicker": float(np.mean([p["flicker"] for p in per_clip])),
            "per_clip": per_clip}
        pm.say(f"adapt={ad}: iou {r['iou_mean']:.4f} min {r['iou_min']:.4f} stab "
               f"{r['temporal_stability']:.4f} flicker {r['flicker']:.5f}")
    return results


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--photos", required=True, help="directory of photographs")
    ap.add_argument("--adapts", default="0,0.5,0.75,1.0", help="ema_adapt values, commas")
    ap.add_argument("--t0", type=float, default=None, help="the gate's EMA_ADAPT_T0")
    ap.add_argument("--t1", type=float, default=None, help="the gate's EMA_ADAPT_T1")
    ap.add_argument("--small", action="store_true", help="240x320 / 96x128, 8 frames")
    ap.add_argument("--ckpt", default=pm.DEFAULT_CKPT, help="a committed int8 export's name")
    ap.add_argument("--frames", type=int, default=None, help="frames a clip (32; --small 8)")
    ap.add_argument("--report", default=None, help="write the report as JSON")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """The sweep of the parsed flags; runtime/config.py's gate is moved for
    the sweep and put back after it (a caller in the same process keeps
    its own)."""
    a = parse_args(argv)
    with cfg.ema_gate_at(a.t0, a.t1):
        if a.t0 is not None or a.t1 is not None:
            pm.say(f"gate T0={cfg.EMA_ADAPT_T0} T1={cfg.EMA_ADAPT_T1}")
        adapts = [float(x) for x in a.adapts.split(",")]
        results = sweep(a.photos, adapts, a.small, a.ckpt, a.frames, a.device)
    pm.say(json.dumps(results, indent=1))
    if a.report:
        Path(a.report).write_text(json.dumps(results, indent=1))
    return results


if __name__ == "__main__":
    main()
