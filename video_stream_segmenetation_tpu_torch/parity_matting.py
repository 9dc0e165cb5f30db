"""Matting parity on realistic clips (port of ``tools/parity_matting.py``).

    python -m video_stream_segmenetation_tpu_torch.parity_matting --photos DIR \\
        [--small] [--ckpt NAME] [--frames T] [--oracle-frames N] [--report FILE] \\
        [--device cpu]

The reference application's matting ONNX (``model_q4f16.onnx``) is not in
the repository, so parity against it is measured by ``parity_check.py
--onnx-ref`` where the file is at hand.  This tool measures what stands in
for it, on articulated procedural people (train/person.py, utils/clips.py::
articulated_clip; their draws from a CPU generator, so that the card and
the CPU serve the same clips) over the photographs under ``--photos``:

1. ``int8_vs_float_pipeline``: the int8 pico serving pipeline against the
   same trained flagship served in float (``matting_precision='bf16'``),
   the whole production pipeline on both sides (the quantized-serving
   relationship the reference's ONNX has to its model);
2. ``engine_vs_reference_semantics_oracle``: the engine's temporal and
   refine stages against the literal per-pixel numpy port of the reference
   application's formulas (utils/oracles.py), fed the same model alpha,
   without the face path, and ``engine_vs_oracle_face_path`` with it, the
   engine's captured face evidence (the pre-step affine, the analytic prior)
   driving the oracle's warp and prior stages; both at ``ema_adapt=0``, the
   reference's fixed EMA;
3. each pipeline against the clips' ground truth (after a warm-up of
   :data:`WARM` frames a clip), and the float pipeline with the EMA knob at 0.

Serving geometry (720p, 288x512, 32 frames a clip, 12 oracle frames) unless
``--small`` (240x320, 96x128, 8 frames, 4 oracle frames: a check of the
harness, not quality evidence).  ``--ckpt NAME`` serves another committed
int8 export (bridge.EXPORTS, e.g. ``mattenet_hd10_micro``); its float form
comes from bridge.py::matting_weights, which raises a KeyError naming the
checkpoint where no float export is committed.  The report is printed, and
written only where ``--report`` says.  Runs on the card unless ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.ops.resize import resize_bilinear
from video_stream_segmenetation_tpu_torch.runtime import config as cfg
from video_stream_segmenetation_tpu_torch.runtime.presets import preset
from video_stream_segmenetation_tpu_torch.service.engine import Engine
from video_stream_segmenetation_tpu_torch.utils import oracles
from video_stream_segmenetation_tpu_torch.utils.clips import (
    articulated_clip,
    parity_report,
    run_clip_through_engine,
)

# (frame_hw, mask_hw, frames a clip, oracle frames): the serving geometry the
# flagship checkpoints were fine-tuned at, and --small's
GEOMETRY = {False: ((720, 1280), (288, 512), 32, 12), True: ((240, 320), (96, 128), 8, 4)}
DEFAULT_CKPT = "mattenet_hd10_pico"
WARM = 5  # frames of EMA warm-up left out of the *_vs_gt rows (tools/eval_variants.py)


def say(msg: str) -> None:
    print(msg, flush=True)


def plan_of(ckpt: str) -> str:
    """The int8 plan of a committed export's name (bridge.EXPORTS)."""
    plans = {name: plan for plan, name in bridge.EXPORTS.items()}
    if ckpt not in plans:
        raise KeyError(f"no committed int8 export {ckpt!r}; have {sorted(plans)}")
    return plans[ckpt]


def build_engine(face: bool = False, frame_hw=(720, 1280), mask_hw=(288, 512),
                 ckpt: str = DEFAULT_CKPT, device="cuda", **overrides) -> Engine:
    """``Engine(1)`` of ``fast_int8_pico`` with a colour background, the
    face path on or off (off: the face models shrunk to fd 64 / lmk 48,
    which nothing runs), on ``ckpt``'s committed trees (the int8 export, or
    the float one with ``matting_precision='bf16'``; the face pair of the
    preset's fd/lmk sizes), every frame's face gate open; one stream
    admitted."""
    base = preset("fast_int8_pico")
    statics = dataclasses.replace(
        base, frame_hw=tuple(frame_hw), mask_hw=tuple(mask_hw), background="color",
        face_path=face, fd_size=base.fd_size if face else 64,
        lmk_size=base.lmk_size if face else 48, matting_decoder=plan_of(ckpt), **overrides)
    eng = Engine(1, statics, params=bridge.matting_weights(statics),
                 face_params=bridge.face_weights(statics) if face else None, device=device)
    # the reference steps its engines with the face gate open
    eng.face_min_interval_s = 0.0
    eng.admit()
    return eng


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def run_with_capture(eng: Engine, clip) -> tuple[np.ndarray, list]:
    """Feed a clip through stream 0, capturing a frame at a time the face
    evidence the refine stages consumed: the pre-step ``affine`` (f64) and
    ``has_affine`` (an affine and an initialized stream: what the warp
    reads), the step's analytic prior ``prior`` and ``has_prior`` (or its
    plane ``prior_plane``), ``face_applied`` (the post-step state: any
    detection ever applied) and ``det_score``.  Returns (masks ``[T, h,
    w]`` f32, the captures)."""
    fh, fw = eng.statics.frame_hw
    batch = np.zeros((eng.num_streams, fh, fw, 3), np.uint8)
    masks, caps = [], []
    for t in range(len(clip.frames)):
        st = eng.state
        pre = {"affine": _host(st.affine)[0].astype(np.float64),
               "has_affine": bool(_host(st.has_affine)[0]) and bool(_host(st.initialized)[0])}
        batch[0] = clip.frames[t]
        out = eng.process(batch)
        masks.append(_host(out["alpha"][0].float()))
        if "face_prior_params" in out:
            pre["prior"] = _host(out["face_prior_params"])[0]
            pre["has_prior"] = bool(_host(out["face_has_prior"])[0])
        elif "face_prior_plane" in out:
            pre["prior_plane"] = _host(out["face_prior_plane"])[0]
            pre["has_prior"] = bool(_host(out["face_has_prior"])[0])
        pre["face_applied"] = bool(_host(eng.state.has_affine)[0])
        pre["det_score"] = float(_host(out["det_score"])[0])
        caps.append(pre)
    return np.stack(masks), caps


def prior_mask_oracle(params4, mask_hw) -> np.ndarray:
    """The reference's prior from the engine's analytic params: the box
    inverted from ops/prior.py::face_prior_params (face coordinates are
    mask coordinates for ``face_input='guide'``) through the literal
    oracle."""
    cx, cy, rx, ry = (float(v) for v in params4)
    box = (cx - rx / 1.12, cy - ry / 1.4, cx + rx / 1.12, cy + ry / 1.4)
    mh, mw = mask_hw
    return oracles.face_prior_oracle(box, mw, mh, mw, mh)


def oracle_chain(model_masks: np.ndarray, frames: np.ndarray, mask_hw, caps=None,
                 warp_w: float = 0.5) -> np.ndarray:
    """The reference's refine chain as the literal per-pixel oracles, at
    the default knobs, on ``model_masks [T, h, w]`` over ``frames [T, H, W,
    3]`` u8.  With ``caps`` (:func:`run_with_capture`) the warp and blend
    and the prior's closing and clamps run too (stages 3-9); without, the
    chain of a face_path=False engine (no warp, no prior)."""
    out = np.zeros_like(model_masks)
    prev = None
    for t in range(len(model_masks)):
        a = model_masks[t].astype(np.float64)
        prior = None
        if caps is not None:
            c = caps[t]
            # stage 3 (:102-112): prev warped by the pre-step affine, blended
            if c["has_affine"] and prev is not None:
                warped = oracles.warp_affine_nearest_oracle(prev, tuple(c["affine"]))
                a = warped * warp_w + a * (1.0 - warp_w)
            if c.get("has_prior"):
                prior = (prior_mask_oracle(c["prior"], mask_hw) if "prior" in c
                         else c["prior_plane"].astype(np.float64))
        prev, a = oracles.ema_oracle(prev, a, cfg.DEFAULT_EMA)
        a = oracles.opening_oracle(a)
        a = oracles.closing_in_prior_oracle(a, prior)
        guide = np.floor(oracles.resize_bilinear_tfjs_oracle(frames[t].astype(np.float64),
                                                             *mask_hw) + 0.5)
        a = oracles.bilateral_oracle(a, guide, cfg.DEFAULT_BILATERAL_SIGMA_SPATIAL,
                                     cfg.DEFAULT_BILATERAL_SIGMA_RANGE)
        a = oracles.refine_oracle(a, cfg.DEFAULT_NOISE_CUTOFF, cfg.DEFAULT_HIGH_THRESHOLD,
                                  cfg.DEFAULT_GAMMA, prior)
        out[t] = a
    return out


def clip_draws(seed: int, frame_hw) -> dict:
    """A clip's person and occluder draws (train/person.py) from a CPU
    generator seeded ``seed``, so that a clip is the same whichever device
    renders it."""
    from video_stream_segmenetation_tpu_torch.train import person

    gen = torch.Generator().manual_seed(seed)
    return {"ident": person.sample_identity(gen, 1),
            "pose": person.sample_pose(gen, 1, frame_hw),
            "occ": person.occluder_draws(gen, 1, frame_hw)}


def clips_of(photos, frame_hw, n_frames: int, device="cuda") -> tuple[list, object]:
    """The reference's clips over the photos (at most 8, twice the frame):
    a desk-occluded clip, a waving one with a 3 px shake, a fast occluded
    one, and the face clip (painted features, waving); rendered on
    ``device`` from :func:`clip_draws`."""
    from video_stream_segmenetation_tpu_torch.train.realdata import load_background_bank

    bank = load_background_bank(frame_hw, photos, max_images=8, oversample=2)

    def clip(seed, **kw):
        return articulated_clip(n_frames, frame_hw, seed=seed, bank=bank, device=device,
                                draws=clip_draws(seed, frame_hw), **kw)

    clips = [clip(0, occluder_p=1.0), clip(1, wave=True, shake_px=3.0, occluder_p=0.0),
             clip(2, occluder_p=1.0, motion=1.5)]
    return clips, clip(3, features=True, wave=True, occluder_p=0.0, shake_px=1.5)


def ground_truth(clip, mask_hw) -> np.ndarray:
    """A clip's alpha at the mask geometry (asymmetric bilinear)."""
    a = torch.as_tensor(clip.alpha)[..., None]
    return resize_bilinear(a, tuple(mask_hw), method="asymmetric")[..., 0].numpy()


def fresh(eng: Engine) -> Engine:
    """Stream 0 cold: no temporal state carried across clips."""
    eng.evict(0)
    eng.admit()
    return eng


def int8_vs_float(photos, frame_hw, mask_hw, n_frames: int, ckpt: str = DEFAULT_CKPT,
                  device="cuda") -> dict:
    """Section 1 alone: the int8 pipeline against the float one on the
    four clips (the face clip through the face-path engines)."""
    clips, face_clip = clips_of(photos, frame_hw, n_frames, device)
    geo = dict(frame_hw=frame_hw, mask_hw=mask_hw, ckpt=ckpt, device=device)
    eng_i8, eng_f = build_engine(**geo), build_engine(matting_precision="bf16", **geo)
    m_i8 = [run_clip_through_engine(fresh(eng_i8), c) for c in clips]
    m_f = [run_clip_through_engine(fresh(eng_f), c) for c in clips]
    m_i8.append(run_with_capture(build_engine(face=True, **geo), face_clip)[0])
    m_f.append(run_with_capture(build_engine(face=True, matting_precision="bf16", **geo),
                                face_clip)[0])
    return parity_report(np.concatenate(m_i8), np.concatenate(m_f))


def report(photos, small: bool = False, ckpt: str = DEFAULT_CKPT, n_frames=None,
           n_oracle=None, device="cuda") -> dict:
    """The report's sections, in the reference's keys and order."""
    frame_hw, mask_hw, t_default, t_oracle_default = GEOMETRY[small]
    n_frames = n_frames or t_default
    n_oracle = min(n_oracle or t_oracle_default, n_frames)
    clips, face_clip = clips_of(photos, frame_hw, n_frames, device)
    geo = dict(frame_hw=frame_hw, mask_hw=mask_hw, ckpt=ckpt, device=device)

    say("serving pipelines...")
    eng_i8 = build_engine(**geo)
    eng_f = build_engine(matting_precision="bf16", **geo)
    eng_model = build_engine(matting_precision="bf16", debug_stage="model_only", **geo)
    m_i8, m_f, gt = [], [], []
    for ci, c in enumerate(clips):
        say(f"clip {ci}...")
        m_i8.append(run_clip_through_engine(fresh(eng_i8), c))
        m_f.append(run_clip_through_engine(fresh(eng_f), c))
        gt.append(ground_truth(c, mask_hw))
        if ci == 0:
            # the per-pixel oracle is the reference's fixed EMA: the engine
            # side runs ema_adapt=0 there (the *_vs_gt rows keep the default)
            mm = run_clip_through_engine(fresh(eng_model), c)
            fresh(eng_f).set_knobs(0, ema_adapt=0.0)
            mf_compat = run_clip_through_engine(eng_f, c)
            fresh(eng_f).reset_knobs(0)
            say("oracle chain (no face)...")
            m_oracle = oracle_chain(mm[:n_oracle], c.frames[:n_oracle], mask_hw)
            m_f_or = mf_compat[:n_oracle]

    # the EMA knob at 0: the quality bound without the smoothing lag
    m_f0 = []
    for c in clips:
        fresh(eng_f).set_knobs(0, ema=0.0)
        m_f0.append(run_clip_through_engine(eng_f, c))
    fresh(eng_f).reset_knobs(0)

    say("face-path engines...")
    eng_face = build_engine(face=True, matting_precision="bf16", **geo)
    eng_face_model = build_engine(face=True, matting_precision="bf16",
                                  debug_stage="model_only", **geo)
    eng_face_i8 = build_engine(face=True, **geo)
    mfc, _ = run_with_capture(eng_face, face_clip)
    mfc_i8, _ = run_with_capture(eng_face_i8, face_clip)
    mmc, _ = run_with_capture(eng_face_model, face_clip)
    fresh(eng_face).set_knobs(0, ema_adapt=0.0)
    mfc_compat, caps_c = run_with_capture(eng_face, face_clip)
    fired = sum(1 for c in caps_c if c.get("has_prior"))
    applied = sum(1 for c in caps_c if c["face_applied"])
    say(f"face clip: prior fired {fired}/{len(caps_c)} frames, affine applied {applied}")
    say("oracle chain (face)...")
    m_oracle_face = oracle_chain(mmc[:n_oracle], face_clip.frames[:n_oracle], mask_hw,
                                 caps=caps_c[:n_oracle],
                                 warp_w=eng_face.statics.warp_blend_weight)
    gt_face = ground_truth(face_clip, mask_hw)

    def catw(xs):
        return np.concatenate([x[WARM:] for x in xs], axis=0)

    compat = "ema_adapt=0 (the reference's fixed EMA, both sides)"
    shipped = "the preset's defaults (motion-adaptive EMA)"
    return {
        "_acquisition_record": (
            "the reference application's matting ONNX (model_q4f16.onnx) is not in the "
            "repository: parity against it is parity_check.py --onnx-ref's, where the file is "
            "at hand; these sections are what stands in for it"),
        "_method": (
            "articulated procedural people over the photographs under --photos; the int8 "
            "pico pipeline against the same flagship served in float; the engine's chain "
            "against the literal per-pixel oracles of the reference's formulas "
            "(utils/oracles.py) fed the same model alpha, without the face path and with "
            "it (the captured affine and analytic prior drive the oracle's warp and prior)"),
        "checkpoint": ckpt,
        "device": str(eng_i8.device) + (f" ({torch.cuda.get_device_name(eng_i8.device)})"
                                        if eng_i8.device.type == "cuda" else ""),
        "clips": {"n": len(clips) + 1, "frames_per_clip": n_frames,
                  "frame_hw": list(frame_hw), "mask_hw": list(mask_hw),
                  "oracle_frames": n_oracle},
        "int8_vs_float_pipeline": parity_report(np.concatenate(m_i8 + [mfc_i8]),
                                                np.concatenate(m_f + [mfc])),
        "engine_vs_reference_semantics_oracle": {**parity_report(m_f_or, m_oracle),
                                                 "_knobs": compat},
        "engine_vs_oracle_face_path": {**parity_report(mfc_compat[:n_oracle], m_oracle_face),
                                       "_knobs": compat, "prior_fired_frames": fired,
                                       "affine_applied_frames": applied},
        "int8_pipeline_vs_gt": {**parity_report(catw(m_i8 + [mfc_i8]), catw(gt + [gt_face])),
                                "warmup_frames_skipped_per_clip": WARM, "_knobs": shipped},
        "float_pipeline_vs_gt": {**parity_report(catw(m_f + [mfc]), catw(gt + [gt_face])),
                                 "warmup_frames_skipped_per_clip": WARM, "_knobs": shipped},
        "float_pipeline_vs_gt_ema0": {
            **parity_report(catw(m_f0), catw(gt)), "warmup_frames_skipped_per_clip": WARM,
            "_note": ("the EMA knob at 0 (no temporal smoothing): the segmentation quality "
                      "bound; the default-knob row also pays the reference's own EMA lag on "
                      "fast motion (EMA 0.55)")},
    }


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--photos", required=True, help="directory of photographs")
    ap.add_argument("--small", action="store_true", help="240x320 / 96x128, 8 frames")
    ap.add_argument("--ckpt", default=DEFAULT_CKPT, help="a committed int8 export's name")
    ap.add_argument("--frames", type=int, default=None, help="frames a clip")
    ap.add_argument("--oracle-frames", type=int, default=None)
    ap.add_argument("--report", default=None, help="write the report as JSON")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    a = parse_args(argv)
    rep = report(a.photos, a.small, a.ckpt, a.frames, a.oracle_frames, a.device)
    say(json.dumps(rep, indent=2))
    if a.report:
        Path(a.report).write_text(json.dumps(rep, indent=2))
    return rep


if __name__ == "__main__":
    main()
