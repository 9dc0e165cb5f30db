"""The mask-IoU parity CLI (port of ``tools/parity_check.py``): a clip
through the Engine, its masks against reference masks, the BASELINE's
"mask IoU >= 0.99" bar.

    python -m video_stream_segmenetation_tpu_torch.parity_check --clip CLIP --ref REF
    python -m video_stream_segmenetation_tpu_torch.parity_check --clip CLIP \\
        --onnx-ref model.onnx [--onnx-input-hw 288,512]
    python -m video_stream_segmenetation_tpu_torch.parity_check --synthetic [--frames 30]

Each takes ``--device cpu`` to run on the CPU (the card by default: the
tool fails where there is none), ``--checkpoint PATH`` (a matting tree: an
``.npz`` export or a utils/checkpoint.py directory), ``--frames N`` (the
synthetic clip's length), ``--report FILE`` (the report as JSON) and
``--save-masks FILE`` (the served masks as an npz with ``masks``, a
``--ref`` of a later run).

* ``--clip``: an npz with ``frames`` ``[T, H, W, 3]`` u8 (and ``masks``
  ``[T, H, W]`` to compare against), or a directory of frame images in
  name order;
* ``--ref``: an npz with ``masks`` or a directory of grayscale mask
  images;
* ``--onnx-ref``: a matting ONNX run over the clip to make the reference
  masks (:func:`onnx_reference_masks`: the reference application's
  preprocess, asymmetric bilinear resize to the model's input, /255, NCHW);
* ``--synthetic``: utils/clips.py::synthetic_clip at 240x320, seed 1, its
  ground-truth alpha the reference.

A 720p clip is served by the production ``fast_int8_pico`` (colour
background, no face path, fd 64 / lmk 48) on the committed pico export,
other geometries by the default statics (``active``) at a mask of about
2/5 of the frame, on seeded weights unless ``--checkpoint``.  The masks are
compared at the mask geometry, the reference masks resized there
half-pixel (utils/clips.py::parity_report, with ``target_iou`` 0.99 and
``passes_target``); the exit code is 0 where the mean IoU reaches the
target, else 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.ops.resize import resize_bilinear
from video_stream_segmenetation_tpu_torch.parallel.mesh import resolve_device
from video_stream_segmenetation_tpu_torch.runtime.config import PipelineStatics
from video_stream_segmenetation_tpu_torch.runtime.precision import pinned
from video_stream_segmenetation_tpu_torch.runtime.presets import preset
from video_stream_segmenetation_tpu_torch.service.engine import Engine
from video_stream_segmenetation_tpu_torch.utils import onnx_exec, onnx_lite
from video_stream_segmenetation_tpu_torch.utils.checkpoint import restore_params
from video_stream_segmenetation_tpu_torch.utils.clips import (
    SyntheticClip,
    load_reference_masks,
    parity_report,
    run_clip_through_engine,
    synthetic_clip,
)

TARGET_IOU = 0.99
SERVING_HW, SERVING_MASK_HW = (720, 1280), (288, 512)
IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg", ".bmp")


def onnx_reference_masks(model, frames: np.ndarray, in_hw, device="cuda") -> np.ndarray:
    """The reference masks ``[T, h, w]`` f32 of a matting graph ``model``
    (a utils/onnx_lite.py Model) over ``frames`` ``[T, H, W, 3]`` u8: each
    frame resized to ``in_hw`` (asymmetric bilinear), /255, NCHW, through
    utils/onnx_exec.py::build_torch_fn on ``device`` (f32, TF32 off); the
    mask is the first ``[1, 1, h, w]`` output, else the last ``[1, h, w]``
    (the reference application's pickMaskOutput)."""
    dev = resolve_device(device)
    fn, params = onnx_exec.build_torch_fn(model, device=dev)
    in_name = model.graph.inputs[0][0]
    masks = []
    for fr in frames:
        x = resize_bilinear(torch.as_tensor(fr, dtype=torch.float32, device=dev)[None] / 255.0,
                            tuple(in_hw), method="asymmetric")
        with pinned():
            out = fn(params, **{in_name: x.permute(0, 3, 1, 2).contiguous()})
        m = None
        for v in out.values():
            a = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            if a.ndim == 4 and a.shape[:2] == (1, 1):
                m = a[0, 0]
                break
            if a.ndim == 3 and a.shape[0] == 1:
                m = a[0]
        if m is None:
            raise ValueError("the graph has no [1, 1, h, w] mask-like output")
        masks.append(m.astype(np.float32))
    return np.stack(masks)


def load_image_dir(path, as_mask: bool = False) -> np.ndarray:
    """A directory of images in name order -> ``[T, H, W, 3]`` u8 frames,
    or ``[T, H, W]`` f32 grayscale masks in 0..1."""
    from PIL import Image

    names = sorted(n for n in os.listdir(path) if n.lower().endswith(IMAGE_SUFFIXES))
    if not names:
        raise ValueError(f"{path}: no image files")
    out = []
    for n in names:
        img = Image.open(os.path.join(path, n))
        out.append(np.asarray(img.convert("L"), np.float32) / 255.0 if as_mask
                   else np.asarray(img.convert("RGB"), np.uint8))
    return np.stack(out)


def load_frames(path) -> tuple[np.ndarray, np.ndarray | None]:
    """``--clip``: an npz (``frames``, and ``masks`` where present) or an
    image directory -> (frames, masks or None)."""
    if os.path.isdir(path):
        return load_image_dir(path), None
    with np.load(path) as z:
        return z["frames"], (z["masks"] if "masks" in z else None)


def load_tree(path) -> dict:
    """A matting tree: an ``.npz`` export or a utils/checkpoint.py directory."""
    path = Path(path)
    return restore_params(str(path)) if path.is_dir() else bridge.load_export(path)


def mask_hw_of(frame_hw) -> tuple[int, int]:
    """The mask geometry the tool serves a clip at: 288x512 at 720p, else
    about 2/5 of the frame (height a multiple of 8, width of 16)."""
    if tuple(frame_hw) == SERVING_HW:
        return SERVING_MASK_HW
    fh, fw = frame_hw
    return max(32, (fh * 2 // 5) // 8 * 8), max(64, (fw * 2 // 5) // 16 * 16)


def statics_of(frame_hw, synthetic: bool = False) -> PipelineStatics:
    """The statics a clip is served by: ``fast_int8_pico`` at 720p (not for
    ``--synthetic``), the default statics elsewhere; a colour background,
    no face path."""
    if tuple(frame_hw) == SERVING_HW and not synthetic:
        return dataclasses.replace(preset("fast_int8_pico"), background="color",
                                   face_path=False, fd_size=64, lmk_size=48)
    return PipelineStatics(frame_hw=tuple(frame_hw), mask_hw=mask_hw_of(frame_hw),
                           fd_size=128, lmk_size=96, background="color", face_path=False)


def build_engine(statics: PipelineStatics, checkpoint=None, device="cuda") -> Engine:
    """``Engine(1)`` of ``statics`` on ``checkpoint``'s tree; without one,
    the committed pico export for ``fast_int8_pico``, seeded weights for
    the others (as the reference serves them)."""
    if checkpoint is not None:
        params = load_tree(checkpoint)
    elif statics.frame_layout == "s2d":
        params = bridge.matting_weights(statics)
    else:
        params = None
    eng = Engine(1, statics, params=params, device=device)
    eng.admit()
    return eng


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clip", help="npz with 'frames' [T,H,W,3] u8, or a directory of frames")
    ap.add_argument("--ref", help="npz with 'masks' [T,h,w], or a directory of mask images")
    ap.add_argument("--onnx-ref", help="a matting ONNX run over --clip to make the reference "
                    "masks")
    ap.add_argument("--onnx-input-hw", default="288,512", help="H,W the ONNX model takes")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--report", default=None, help="write the report as JSON")
    ap.add_argument("--save-masks", default=None, help="write the served masks as an npz")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    a = parser().parse_args(argv)
    if not a.synthetic and not a.clip:
        parser().error("--clip required without --synthetic")
    return a


def run(a: argparse.Namespace) -> dict:
    """The parity report of parsed arguments (:func:`parse_args`)."""
    if a.synthetic:
        clip = synthetic_clip(n_frames=a.frames, hw=(240, 320), seed=1)
        frames, ref_masks = clip.frames, clip.alpha
    else:
        frames, ref_masks = load_frames(a.clip)
        if a.ref:
            ref_masks = (load_image_dir(a.ref, as_mask=True) if os.path.isdir(a.ref)
                         else load_reference_masks(a.ref))
        if a.onnx_ref:
            ref_masks = onnx_reference_masks(
                onnx_lite.load(a.onnx_ref), frames,
                tuple(int(v) for v in a.onnx_input_hw.split(",")), a.device)
        if ref_masks is None:
            parser().error("no reference masks: pass --ref / --onnx-ref or include 'masks' in the clip")
    t, fh, fw, _ = frames.shape
    eng = build_engine(statics_of((fh, fw), a.synthetic), a.checkpoint, a.device)
    masks = run_clip_through_engine(
        eng, SyntheticClip(frames=frames, alpha=np.zeros((t, fh, fw), np.float32)))
    if a.save_masks:
        np.savez(a.save_masks, masks=masks)
    mh, mw = eng.statics.mask_hw
    ref_small = resize_bilinear(torch.as_tensor(np.asarray(ref_masks, np.float32)), (mh, mw),
                                method="half_pixel", channel_last=False).numpy()
    report = parity_report(masks, ref_small)
    report["target_iou"] = TARGET_IOU
    report["passes_target"] = bool(report["iou_mean"] >= TARGET_IOU)
    return report


def main(argv=None) -> int:
    a = parse_args(argv)
    report = run(a)
    print(json.dumps(report, indent=2))
    if a.report:
        Path(a.report).write_text(json.dumps(report, indent=2))
    return 0 if report["passes_target"] else 1


if __name__ == "__main__":
    sys.exit(main())
