"""Train the FaceFinder and the LandmarkNet on synthetic face scenes and
save them as numpy exports (port of ``tools/train_face.py``).

    python -m video_stream_segmenetation_tpu_torch.train.face_trainer --out DIR \\
        [--steps 2000] [--batch 32] [--fd 256] [--lmk 192] [--skip-fd] [--skip-lmk] \\
        [--device cuda]

Training runs at the serving distribution (runtime/pipeline.py's face
subpath): the detector on letterboxed guide-resolution scenes
(:func:`letterbox_batch`), the landmark net on padded, jittered ROI crops,
a quarter of them shifted off the face as negatives (:func:`lmk_batch`).
The exports are named as the reference's checkpoints: ``facefinder.npz``
at FD 256, else ``facefinder_<FD>.npz``; ``landmarknet.npz`` at LMK 192,
else ``landmarknet_<LMK>.npz`` (bridge.py::face_weights reads them).
``--skip-fd`` / ``--skip-lmk`` reuse the export already in ``DIR`` (with
both, the committed ``weights/`` directory is evaluated as it is).  Each
model's line after training gives its ms a step and the card's peak
memory.  Then
:func:`evaluate` scores both on 64 held-out scenes (generator seed 777):
the detector's box IoU, score and valid fraction, the landmarks' anchor x
error in pixels and score.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.models.blazeface import (
    FaceFinder,
    init_face_finder_params,
)
from video_stream_segmenetation_tpu_torch.models.facemesh import (
    LandmarkNet,
    init_landmark_net_params,
)
from video_stream_segmenetation_tpu_torch.ops.detect import best_box_decode
from video_stream_segmenetation_tpu_torch.ops.geometry import letterbox_params, pad_box
from video_stream_segmenetation_tpu_torch.ops.resize import (
    crop_and_resize_mxu,
    resize_bilinear_mxu,
)
from video_stream_segmenetation_tpu_torch.runtime.precision import pinned
from video_stream_segmenetation_tpu_torch.train.face import (
    ANCHOR_IDS,
    detector_loss,
    landmark_loss,
    synthetic_face_batch,
)
from video_stream_segmenetation_tpu_torch.train.step import peak_mib, reset_peak, train_steps

SCENE_HW = (288, 512)  # the guide resolution (the face_input='guide' source)
FD, LMK = 256, 192  # the serving defaults: exports without a suffix
CHUNK = 200  # the reference logs at the end of each chunk of steps
LR = 1e-3
EVAL_SCENES, EVAL_SEED = 64, 777


def say(msg: str) -> None:
    print(msg, flush=True)


def letterbox_batch(frames: torch.Tensor, box: torch.Tensor, fd: int = FD,
                    scene_hw=SCENE_HW):
    """Scenes ``[B, H, W, 3]`` and head boxes ``[B, 4]`` px -> the
    detector's letterboxed input ``[B, fd, fd, 3]`` (a half-pixel resize as
    two f32 products, the CPU reference's precision, zero padding) and the
    boxes' normalized corners."""
    h, w = scene_hw
    _, dw, dh, off_x, off_y = letterbox_params(scene_hw, fd)
    small = resize_bilinear_mxu(frames, (dh, dw), method="half_pixel")
    fd_in = F.pad(small, (0, 0, off_x, fd - dw - off_x, off_y, fd - dh - off_y))
    sx, sy = dw / w, dh / h
    gt = torch.stack([(box[:, 0] * sx + off_x) / fd, (box[:, 1] * sy + off_y) / fd,
                      (box[:, 2] * sx + off_x) / fd, (box[:, 3] * sy + off_y) / fd], dim=-1)
    return fd_in, gt


def lmk_draws(gen: torch.Generator, batch: int) -> dict:
    """The crops' jitter: ``scale`` ``[B]`` in [0.9, 1.15), ``shift`` ``[B,
    2]`` in [-0.1, 0.1) of the ROI's size, ``face_u`` ``[B]`` in [0, 1) (a
    face where it is above 0.25)."""
    dev = gen.device
    return {"scale": torch.rand((batch,), generator=gen, device=dev) * 0.25 + 0.9,
            "shift": torch.rand((batch, 2), generator=gen, device=dev) * 0.2 - 0.1,
            "face_u": torch.rand((batch,), generator=gen, device=dev)}


def lmk_batch(draws: dict, frames: torch.Tensor, box: torch.Tensor, landmarks: torch.Tensor,
              lmk: int = LMK, scene_hw=SCENE_HW):
    """Padded, jittered ROI crops ``[B, lmk, lmk, 3]`` (f32 products), the
    landmarks normalized to them ``[B, 468, 2]`` and ``is_face`` ``[B]``:
    the crops of :func:`lmk_draws`' negatives slide 1.6 widths sideways."""
    roi = pad_box(box, 0.25, scene_hw)
    jw = roi[:, 2] - roi[:, 0]
    jh = roi[:, 3] - roi[:, 1]
    sc, shift = draws["scale"], draws["shift"]
    cx = (roi[:, 0] + roi[:, 2]) / 2 + shift[:, 0] * jw
    cy = (roi[:, 1] + roi[:, 3]) / 2 + shift[:, 1] * jh
    is_face = draws["face_u"] > 0.25
    cx = torch.where(is_face, cx, cx + 1.6 * jw * torch.sign(shift[:, 0] + 1e-3))
    half_w = jw * sc / 2
    half_h = jh * sc / 2
    roi_j = torch.stack([cx - half_w, cy - half_h, cx + half_w, cy + half_h], dim=-1)
    crop = crop_and_resize_mxu(frames, roi_j, (lmk, lmk))
    gt = torch.stack([(landmarks[..., 0] - roi_j[:, None, 0]) / (2 * half_w[:, None]),
                      (landmarks[..., 1] - roi_j[:, None, 1]) / (2 * half_h[:, None])], dim=-1)
    return crop, gt, is_face


def detector_loss_fn(model: FaceFinder, batch: int, scene_hw=SCENE_HW):
    """``loss_fn(generator)``: a fresh face batch, letterboxed, through the
    detector and :func:`detector_loss`."""

    def loss_fn(gen):
        frames, box, _ = synthetic_face_batch(gen, batch, scene_hw)
        fd_in, gt = letterbox_batch(frames, box, model.input_size, scene_hw)
        return detector_loss(model(fd_in), gt, model.anchors)

    return loss_fn


def landmark_loss_fn(model: LandmarkNet, batch: int, lmk: int, scene_hw=SCENE_HW):
    """``loss_fn(generator)``: a fresh face batch, its jittered crops,
    through the landmark net and :func:`landmark_loss`."""

    def loss_fn(gen):
        frames, box, landmarks = synthetic_face_batch(gen, batch, scene_hw)
        crop, gt, is_face = lmk_batch(lmk_draws(gen, batch), frames, box, landmarks, lmk,
                                      scene_hw)
        return landmark_loss(model(crop), gt, is_face)

    return loss_fn


def train_model(name: str, model: torch.nn.Module, loss_fn, steps: int, lr: float = LR,
                seed: int = 1, on_step=None) -> tuple[dict, list]:
    """Train ``model`` in place (train/step.py::train_steps) -> (its
    flax-named numpy tree, history): ``{"step", "loss", "elapsed_s"}`` at
    the end of each chunk of :data:`CHUNK` steps and at the last (reading
    the loss waits for the step), printed as the reference does.
    ``on_step(i, metrics)`` sees every step's metrics."""
    history = []
    t0 = time.perf_counter()
    for i, metrics in train_steps(model, loss_fn, steps, lr, seed):
        if on_step is not None:
            on_step(i, metrics)
        if (i + 1) % CHUNK == 0 or i + 1 == steps:
            loss = float(metrics["loss"])
            history.append({"step": i + 1, "loss": loss,
                            "elapsed_s": time.perf_counter() - t0})
            say(f"[{name}] {json.dumps({'step': i + 1, 'loss': round(loss, 4)})}")
    return model.tree(), history


def _train_and_save(name: str, model, loss_fn, steps: int, path, device) -> None:
    """:func:`train_model`, the export written to ``path``, and a line with
    the run's ms a step (host clock over the whole run) and the card's
    peak memory."""
    reset_peak(device)
    tree, hist = train_model(name, model, loss_fn, steps)
    bridge.save_export(path, tree)
    say(f"[{name}] saved to {path}; " + json.dumps(
        {"steps": steps, "ms_per_step": 1e3 * hist[-1]["elapsed_s"] / steps,
         "peak_mib": peak_mib(device)}))


def export_names(fd: int, lmk: int) -> tuple[str, str]:
    """The exports' names: the reference's checkpoint names, suffixed with
    the input size where it is not the serving default."""
    return ("facefinder" + ("" if fd == FD else f"_{fd}"),
            "landmarknet" + ("" if lmk == LMK else f"_{lmk}"))


@torch.no_grad()
def evaluate(fd_model: FaceFinder, lmk_model: LandmarkNet, lmk: int, n: int = EVAL_SCENES,
             seed: int = EVAL_SEED, scene_hw=SCENE_HW) -> dict:
    """Both models on ``n`` held-out scenes (a generator seeded ``seed`` on
    the models' device): the detector's mean box IoU against the head box,
    mean best score and valid fraction; the landmark net on the padded
    head ROI, its mean anchor x error in pixels and its mean score."""
    dev = fd_model.anchors.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    with pinned():
        frames, box, landmarks = synthetic_face_batch(gen, n, scene_hw)
        fd_in, _ = letterbox_batch(frames, box, fd_model.input_size, scene_hw)
        det = fd_model(fd_in)
        pbox, score, valid = best_box_decode(det["box_coords"], det["box_scores"], scene_hw,
                                             fd_model.input_size, letterboxed=True)
        roi = pad_box(box, 0.25, scene_hw)
        lout = lmk_model(crop_and_resize_mxu(frames, roi, (lmk, lmk)))
    pb, gt = pbox.double().cpu().numpy(), box.double().cpu().numpy()
    inter = (np.clip(np.minimum(pb[:, 2], gt[:, 2]) - np.maximum(pb[:, 0], gt[:, 0]), 0, None)
             * np.clip(np.minimum(pb[:, 3], gt[:, 3]) - np.maximum(pb[:, 1], gt[:, 1]), 0, None))
    area = lambda b: (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])  # noqa: E731
    ious = inter / np.maximum(area(pb) + area(gt) - inter, 1e-6)
    roi = roi.cpu().numpy()
    lm_px = lout["landmarks"][..., 0].cpu().numpy() * (roi[:, 2:3] - roi[:, 0:1]) + roi[:, 0:1]
    gt_x = landmarks[..., 0].cpu().numpy()
    ids = list(ANCHOR_IDS)
    return {"det_mean_iou": float(ious.mean()), "det_mean_score": float(score.mean()),
            "det_valid_frac": float(valid.float().mean()),
            "lmk_anchor_x_err_px": float(np.abs(lm_px[:, ids] - gt_x[:, ids]).mean()),
            "lmk_mean_score": float(lout["scores"].mean())}


def main(out_dir, steps: int = 2000, batch: int = 32, fd: int = FD, lmk: int = LMK,
         skip_fd: bool = False, skip_lmk: bool = False, device="cuda",
         scene_hw=SCENE_HW) -> dict:
    """Train (or reuse) both models, write their exports, evaluate them ->
    the evaluation dict."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    fd_name, lmk_name = export_names(fd, lmk)

    fd_path = out_dir / f"{fd_name}.npz"
    if skip_fd:
        fd_model = FaceFinder(bridge.load_export(fd_path), fd, device=device)
        say("[facefinder] reusing the existing export")
    else:
        fd_model = FaceFinder(init_face_finder_params(0), fd, device=device)
        _train_and_save("facefinder", fd_model, detector_loss_fn(fd_model, batch, scene_hw),
                        steps, fd_path, device)

    lmk_path = out_dir / f"{lmk_name}.npz"
    if skip_lmk:
        lmk_model = LandmarkNet(bridge.load_export(lmk_path), device=device)
        say("[landmarknet] reusing the existing export")
    else:
        lmk_model = LandmarkNet(init_landmark_net_params(0), device=device)
        _train_and_save("landmarknet", lmk_model,
                        landmark_loss_fn(lmk_model, batch, lmk, scene_hw), steps, lmk_path,
                        device)

    result = evaluate(fd_model, lmk_model, lmk, scene_hw=scene_hw)
    say(json.dumps(result))
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="directory for the .npz exports")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--fd", type=int, default=FD, help="the detector's input size")
    ap.add_argument("--lmk", type=int, default=LMK, help="the landmark net's input size")
    ap.add_argument("--skip-fd", action="store_true", help="reuse OUT's detector export")
    ap.add_argument("--skip-lmk", action="store_true", help="reuse OUT's landmark export")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.out, a.steps, a.batch, a.fd, a.lmk, a.skip_fd, a.skip_lmk, a.device)
