"""The face path against the reference application's own face graphs (port
of ``tools/face_parity.py``).

    python -m video_stream_segmenetation_tpu_torch.face_parity [--report FILE] [--device cpu]

The reference application ships its face models as ONNX graphs; copies are
under ``weights/face_ref/``.  With those weights as the oracle, four
sections:

1. ``port_fidelity``: utils/onnx_exec.py::build_torch_fn on the device
   against the numpy executor (utils/onnx_numpy.py::run) of the same
   graphs, on a random and a face-like input: each output's largest
   absolute and relative difference;
2. ``decode_consistency``: the served detector (models/reference_face.py
   and ops/detect.py::best_box_decode on the letterboxed scene) against a
   numpy decode of the numpy executor's outputs over the 896 anchors: the
   best anchor's agreement and the boxes' IoU;
3. ``blaze_nms``: ``blaze.onnx``'s in-graph NonMaxSuppression, the numpy
   executor's true ONNX NMS against build_torch_fn's fixed-capacity one
   (``nms_capacity=8``): the selected count and boxes, row by row;
4. ``student_vs_reference``: the fast face models on their committed
   trees (``weights/facefinder.npz``, ``landmarknet.npz``) against the
   MediaPipe teacher on held-out synthetic scenes (train/face.py): box IoU
   student/teacher and each against the scene's truth, landmark distance in
   pixels on the teacher's ROI.

Sections 2 and 4 take the scenes as inputs (:func:`scenes` renders them
on the device from a seeded CPU generator's draws).  The report is printed, and
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
import torch.nn.functional as F

from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.models import reference_face as rf
from video_stream_segmenetation_tpu_torch.models.blazeface import FaceFinder
from video_stream_segmenetation_tpu_torch.models.facemesh import LandmarkNet
from video_stream_segmenetation_tpu_torch.ops.detect import best_box_decode, blazeface_anchors
from video_stream_segmenetation_tpu_torch.ops.geometry import letterbox_params, pad_box
from video_stream_segmenetation_tpu_torch.ops.resize import crop_and_resize_mxu, resize_bilinear
from video_stream_segmenetation_tpu_torch.parallel.mesh import resolve_device
from video_stream_segmenetation_tpu_torch.runtime.precision import pinned
from video_stream_segmenetation_tpu_torch.train.face import face_draws, render_face_batch
from video_stream_segmenetation_tpu_torch.utils import onnx_exec

SCENE_HW = (288, 512)
FD, LMK = 256, 192
BLAZE_ONNX = "blaze.onnx"
ANCHOR5 = [33, 263, 1, 13, 14]  # the landmarks the affine fit reads (frameProcessorTest.ts:518)


def face_like(size: int, rng) -> np.ndarray:
    """A face-like ``[1, 3, size, size]`` f32 input (a skin ellipse with
    eyes and a mouth, a little noise)."""
    img = np.full((size, size, 3), 0.25, np.float32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    cx, cy, r = size / 2, size * 0.47, size * 0.14
    img[((yy - cy) / (r * 1.25)) ** 2 + ((xx - cx) / r) ** 2 < 1] = (0.85, 0.68, 0.55)
    for ex in (cx - r * 0.4, cx + r * 0.4):
        eye = ((yy - (cy - r * 0.25)) / (r * 0.12)) ** 2 + ((xx - ex) / (r * 0.18)) ** 2 < 1
        img[eye] = (0.1, 0.1, 0.12)
    mouth = ((yy - (cy + r * 0.55)) / (r * 0.1)) ** 2 + ((xx - cx) / (r * 0.35)) ** 2 < 1
    img[mouth] = (0.55, 0.2, 0.2)
    img += rng.normal(0, 0.02, img.shape).astype(np.float32)
    return np.clip(img, 0, 1).transpose(2, 0, 1)[None]


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def port_fidelity(device="cuda") -> dict:
    """``{detector|landmarks: {output: {max_abs, max_rel}}}``: the worst of
    a random and a face-like image."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    out = {}
    for kind, name, size in (("detector", rf.DETECTOR_ONNX, FD),
                             ("landmarks", rf.LANDMARK_ONNX, LMK)):
        model = rf.load_graph(name)
        fn, params = onnx_exec.build_torch_fn(model, device=dev)
        worst = {}
        for img in (rng.random((1, 3, size, size), np.float32), face_like(size, rng)):
            ref = onnx_exec.run(model, {"image": img})
            with pinned():
                got = {k: _host(v) for k, v in fn(params, image=torch.as_tensor(
                    img, device=dev)).items()}
            for k in ref:
                d = float(np.abs(got[k] - ref[k]).max())
                rel = d / (float(np.abs(ref[k]).max()) + 1e-12)
                cur = worst.get(k, (0.0, 0.0))
                worst[k] = (max(cur[0], d), max(cur[1], rel))
        out[kind] = {k: {"max_abs": v[0], "max_rel": v[1]} for k, v in worst.items()}
    return out


def scenes(n: int, seed: int, device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """``n`` held-out synthetic face scenes at :data:`SCENE_HW` (train/face.py:
    the draws from a CPU generator seeded ``seed``, rendered on ``device``):
    (frames ``[n, H, W, 3]`` f32 in 0..1, head boxes ``[n, 4]`` px)."""
    dev = resolve_device(device)
    draws = face_draws(torch.Generator().manual_seed(seed), n, SCENE_HW)
    frames, box, _ = render_face_batch({k: v.to(dev) for k, v in draws.items()}, SCENE_HW)
    return frames, box


def letterboxed(frames: torch.Tensor) -> torch.Tensor:
    """The scenes resized (half-pixel) into the detector's square and
    padded with zeros around, ``[n, FD, FD, 3]``."""
    _, dw, dh, off_x, off_y = letterbox_params(SCENE_HW, FD)
    small = resize_bilinear(frames, (dh, dw), method="half_pixel")
    return F.pad(small, (0, 0, off_x, FD - dw - off_x, off_y, FD - dh - off_y))


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise IoU of corner boxes ``[n, 4]``."""
    inter = (np.maximum(0, np.minimum(a[:, 2], b[:, 2]) - np.maximum(a[:, 0], b[:, 0]))
             * np.maximum(0, np.minimum(a[:, 3], b[:, 3]) - np.maximum(a[:, 1], b[:, 1])))
    aa = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    ab = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (aa + ab - inter + 1e-9)


def served_boxes(model, frames: torch.Tensor) -> tuple[torch.Tensor, np.ndarray]:
    """A detector as the face path serves it on ``frames [n, H, W, 3]``:
    the letterboxed scenes through ``model``, then ops/detect.py::
    best_box_decode -> (boxes ``[n, 4]`` scene px on the frames' device,
    the best anchor of each scene)."""
    with pinned():
        det = model(letterboxed(frames))
    box, _, _ = best_box_decode(det["box_coords"], det["box_scores"], SCENE_HW, FD,
                                letterboxed=True)
    return box, _host(torch.argmax(det["box_scores"], dim=-1))


def numpy_decode(fd_in: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The MediaPipe detector's best box on each letterboxed scene ``fd_in
    [n, FD, FD, 3]`` by the numpy executor and a numpy anchor decode, back
    through the letterbox to scene pixels -> (boxes ``[n, 4]``, best
    anchors ``[n]``)."""
    h, w = SCENE_HW
    _, dw, dh, off_x, off_y = letterbox_params(SCENE_HW, FD)
    model = rf.load_graph(rf.DETECTOR_ONNX)
    anchors = blazeface_anchors(FD)
    boxes, bests = [], []
    for img in fd_in:
        o = onnx_exec.run(model, {"image": img.transpose(2, 0, 1)[None]})
        best = int(np.argmax(o["box_scores"][0, :, 0]))
        dcx, dcy, bw, bh = o["box_coords"][0][best][:4]
        cx, cy = anchors[best, 0] + dcx / FD, anchors[best, 1] + dcy / FD
        x0, x1 = cx - bw / FD / 2, cx + bw / FD / 2
        y0, y1 = cy - bh / FD / 2, cy + bh / FD / 2
        sx, sy = dw / w, dh / h
        bx = np.array([(x0 * FD - off_x) / sx, (y0 * FD - off_y) / sy,
                       (x1 * FD - off_x) / sx, (y1 * FD - off_y) / sy])
        boxes.append(np.clip(bx, [0, 0, 0, 0], [w, h, w, h]))
        bests.append(best)
    return np.stack(boxes), np.asarray(bests)


def decode_consistency(frames: torch.Tensor, gt_box) -> dict:
    """The served MediaPipe detector's decode against :func:`numpy_decode`
    on ``frames [n, H, W, 3]`` (their device)."""
    box_t, best_t = served_boxes(rf.ReferenceFaceFinder(frames.device), frames)
    boxes, best = numpy_decode(_host(letterboxed(frames)))
    ious = _iou(boxes, _host(box_t))
    return {"n_scenes": int(frames.shape[0]),
            "best_anchor_agreement": float(np.mean(best_t == best)),
            "box_iou_torch_vs_numpy_mean": float(ious.mean()),
            "box_iou_torch_vs_numpy_min": float(ious.min()),
            "teacher_box_vs_gt_iou_mean": float(_iou(boxes, np.asarray(
                _host(torch.as_tensor(gt_box)), np.float64)).mean())}


def blaze_nms(n: int = 4, device="cuda") -> dict:
    """``blaze.onnx`` end to end: the numpy executor's ONNX NMS against
    build_torch_fn's (capacity 8) on face-like and random images, with
    thresholds loose enough that many anchors reach the suppression."""
    dev = resolve_device(device)
    model = rf.load_graph(BLAZE_ONNX)
    # the NMS node's output made a graph output too, so that the executor
    # returns its valid mask (the count kept) beside the selected boxes
    nms = [n.outputs[0] for n in model.graph.nodes if n.op_type == "NonMaxSuppression"]
    fn, params = onnx_exec.build_torch_fn(
        dataclasses.replace(model, graph=dataclasses.replace(
            model.graph, outputs=[*model.graph.outputs, *nms])),
        nms_capacity=8, device=dev)
    rng = np.random.default_rng(3)
    rows, max_abs, count_match = 0, 0.0, True
    for i in range(n):
        img = face_like(128, rng) if i % 2 == 0 else rng.random((1, 3, 128, 128), np.float32)
        feeds = {"image": img.astype(np.float32),
                 "conf_threshold": np.asarray([0.05], np.float32),
                 "max_detections": np.asarray([8], np.int64),
                 "iou_threshold": np.asarray([0.5], np.float32)}
        # [1, k, 16], or [1, 16] where one box is kept (the single-box
        # collapse the application handles)
        ref = onnx_exec.run(model, feeds)["selectedBoxes"].reshape(1, -1, 16)
        with pinned():
            got = fn(params, **{k: torch.as_tensor(v, device=dev) for k, v in feeds.items()})
        sel = _host(got["selectedBoxes"])
        n_ref = ref.shape[1]
        count_match &= int(_host(got[nms[0] + "__valid"]).sum()) == n_ref
        take = min(n_ref, sel.shape[1])
        if take:
            max_abs = max(max_abs, float(np.abs(sel[0, :take] - ref[0, :take]).max()))
        rows += take
    return {"rows_checked": rows, "selected_count_match": bool(count_match),
            "max_abs_diff": max_abs}


def student_vs_reference(frames: torch.Tensor, gt_box) -> dict:
    """The fast face models on their committed trees against the MediaPipe
    teacher on ``frames [n, H, W, 3]`` (their device): detector box IoUs;
    landmarks, both on the teacher's ROI, in scene pixels."""
    dev = frames.device
    n = frames.shape[0]
    t_box, _ = served_boxes(rf.ReferenceFaceFinder(dev), frames)
    s_box, _ = served_boxes(FaceFinder(bridge.load_export(bridge.WEIGHTS_DIR / "facefinder.npz"),
                                       FD, device=dev), frames)
    g = np.asarray(_host(torch.as_tensor(gt_box)), np.float64)
    tb, sb = _host(t_box), _host(s_box)
    st_iou = _iou(sb, tb)
    res = {"n_scenes": n, "detector": {
        "student_vs_teacher_iou_mean": float(st_iou.mean()),
        "student_vs_teacher_iou_median": float(np.median(st_iou)),
        "teacher_vs_gt_iou_mean": float(_iou(tb, g).mean()),
        "student_vs_gt_iou_mean": float(_iou(sb, g).mean())}}

    roi = pad_box(t_box, 0.25, SCENE_HW)
    with pinned():
        crop = crop_and_resize_mxu(frames, roi, (LMK, LMK))
        teacher = rf.ReferenceLandmarkNet(dev)(crop)
        student = LandmarkNet(bridge.load_export(bridge.WEIGHTS_DIR / "landmarknet.npz"),
                              device=dev)(crop)
    t_lmk, s_lmk = _host(teacher["landmarks"]), _host(student["landmarks"])
    roi = _host(roi)
    rw, rh = (roi[:, 2] - roi[:, 0])[:, None], (roi[:, 3] - roi[:, 1])[:, None]
    d = np.sqrt(((t_lmk[..., 0] - s_lmk[..., 0]) * rw) ** 2
                + ((t_lmk[..., 1] - s_lmk[..., 1]) * rh) ** 2)
    res["landmarks"] = {"student_vs_teacher_px_mean": float(d.mean()),
                        "student_vs_teacher_px_median": float(np.median(d)),
                        "anchor5_px_mean": float(d[:, ANCHOR5].mean()),
                        "teacher_score_mean": float(_host(teacher["scores"]).mean())}
    return res


def report(device="cuda", n_decode: int = 16, n_student: int = 32) -> dict:
    """The four sections (scenes seeded 7 for the decode, 1234 for the
    students, as the reference seeds its keys)."""
    dev = resolve_device(device)
    return {
        "oracle": "the reference application's face graphs (weights/face_ref/*.onnx), parsed "
                  "and executed directly",
        "notes": {
            "port_fidelity": "build_torch_fn on the device against the numpy executor of "
                             "the same graphs",
            "student_vs_reference": "the teacher was trained on real people; on these "
                                    "synthetic scenes its own box-vs-truth IoU bounds what "
                                    "student-vs-teacher can reach (student_vs_gt_iou_mean)"},
        "device": str(dev) + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda"
                              else ""),
        "port_fidelity": port_fidelity(dev),
        "decode_consistency": decode_consistency(*scenes(n_decode, 7, dev)),
        "blaze_nms": blaze_nms(device=dev),
        "student_vs_reference": student_vs_reference(*scenes(n_student, 1234, dev)),
    }


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--report", default=None, help="write the report as JSON")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    a = parse_args(argv)
    rep = report(a.device)
    print(json.dumps(rep, indent=2), flush=True)
    if a.report:
        Path(a.report).write_text(json.dumps(rep, indent=2))
    return rep


if __name__ == "__main__":
    main()
