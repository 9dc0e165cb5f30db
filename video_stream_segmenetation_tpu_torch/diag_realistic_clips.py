"""Per-clip quality diagnosis on the realistic clips (port of
``tools/diag_realistic_clips.py``).

    python -m video_stream_segmenetation_tpu_torch.diag_realistic_clips --photos DIR \\
        [--small] [--ckpt NAME] [--frames 32] [--report FILE] [--device cpu]

The float pipeline (``fast_int8_pico`` with ``matting_precision='bf16'``)
and its model alone (``debug_stage='model_only'``) on each of the four
articulated clips of parity_matting.py over the photographs under
``--photos``: IoU against the ground truth a clip, whole pipeline and model
only (mean and least over the frames), so that "the model cannot segment
this" parts from "the refine stages hurt here"; then the worst clip and its
worst frame.  As in the reference, the clips run back to back on one
stream of each engine: a clip starts from the EMA state the one before it
left.  Geometry, ``--small`` and ``--ckpt`` as parity_matting.py's;
runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from video_stream_segmenetation_tpu_torch import parity_matting as pm
from video_stream_segmenetation_tpu_torch.utils.clips import mask_iou, run_clip_through_engine

CLIP_NAMES = ("c0_desk", "c1_wave_shake", "c2_desk_fastmotion", "c3_face")


def diagnose(photos, small: bool = False, ckpt: str = pm.DEFAULT_CKPT, n_frames=None,
             device="cuda") -> dict:
    """``{clip: {full_mean, full_min, model_mean, model_min}, ...,
    "worst": {worst_clip, mean, worst_frame}}``."""
    frame_hw, mask_hw, t_default, _ = pm.GEOMETRY[small]
    clips, face_clip = pm.clips_of(photos, frame_hw, n_frames or t_default, device)
    geo = dict(frame_hw=frame_hw, mask_hw=mask_hw, ckpt=ckpt, device=device)
    eng_f = pm.build_engine(matting_precision="bf16", **geo)
    eng_m = pm.build_engine(matting_precision="bf16", debug_stage="model_only", **geo)
    out, worst = {}, (None, 1.0, 0)
    for name, c in zip(CLIP_NAMES, clips + [face_clip]):
        gt = pm.ground_truth(c, mask_hw)
        i_f = mask_iou(run_clip_through_engine(eng_f, c), gt)
        i_m = mask_iou(run_clip_through_engine(eng_m, c), gt)
        out[name] = {"full_mean": round(float(i_f.mean()), 3),
                     "full_min": round(float(i_f.min()), 3),
                     "model_mean": round(float(i_m.mean()), 3),
                     "model_min": round(float(i_m.min()), 3)}
        pm.say(f"{name} {json.dumps(out[name])}")
        if i_f.mean() < worst[1]:
            worst = (name, float(i_f.mean()), int(np.argmin(i_f)))
    out["worst"] = {"worst_clip": worst[0], "mean": round(worst[1], 3),
                    "worst_frame": worst[2]}
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--photos", required=True, help="directory of photographs")
    ap.add_argument("--small", action="store_true", help="240x320 / 96x128, 8 frames")
    ap.add_argument("--ckpt", default=pm.DEFAULT_CKPT, help="a committed int8 export's name")
    ap.add_argument("--frames", type=int, default=None, help="frames a clip (32; --small 8)")
    ap.add_argument("--report", default=None, help="write the report as JSON")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    a = parse_args(argv)
    rep = diagnose(a.photos, a.small, a.ckpt, a.frames, a.device)
    pm.say(json.dumps(rep["worst"]))
    if a.report:
        Path(a.report).write_text(json.dumps(rep, indent=2))
    return rep


if __name__ == "__main__":
    main()
