"""face_parity.py's four sections on the CPU against the same computation in
JAX (the steps of the reference's tools/face_parity.py, written out here
with the JAX package's functions, the graphs read from checkpoints/face_ref/),
on the reference's own scenes (train/face.py::synthetic_face_batch of its
keys 7 and 1234), four of them.

Bars, with their reasons:
* ``port_fidelity``: each output's largest difference within 1e-4 of its
  largest value (the reference's record: 1e-6 to 4e-6, PARITY.json);
* the served detector: the same best anchor in every scene, the boxes'
  IoU at least 0.9999 (f32 graphs on both sides; the reference's own
  jitted-vs-numpy record is 0.999999);
* ``blaze.onnx``: the rows the numpy executor keeps, equal to the JAX
  port's within 1e-6 (one f32 rounding), the same count;
* the students against the teacher: every mean within 0.01 of the JAX
  side's (bf16 students on both sides, knife edges).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu import models as JM
from video_stream_segmenetation_tpu import ops as JO
from video_stream_segmenetation_tpu.models import reference_face as jrf
from video_stream_segmenetation_tpu.ops.geometry import letterbox_params as j_letterbox
from video_stream_segmenetation_tpu.ops.geometry import pad_box as j_pad_box
from video_stream_segmenetation_tpu.train.face import synthetic_face_batch as j_scenes
from video_stream_segmenetation_tpu.utils import onnx_exec as JE
from video_stream_segmenetation_tpu.utils import onnx_lite as JL
from video_stream_segmenetation_tpu.utils.checkpoint import restore_params
from video_stream_segmenetation_tpu_torch import face_parity as FP
from video_stream_segmenetation_tpu_torch.models import reference_face as trf

N = 4
FD, LMK, SCENE_HW = FP.FD, FP.LMK, FP.SCENE_HW


@functools.lru_cache(maxsize=2)
def reference_scenes(seed: int):
    frames, box, _ = j_scenes(jax.random.PRNGKey(seed), N, SCENE_HW)
    return np.asarray(frames), np.asarray(box)


def jax_fd_in(frames):
    _, dw, dh, off_x, off_y = j_letterbox(SCENE_HW, FD)
    small = JO.resize_bilinear(jnp.asarray(frames), (dh, dw), method="half_pixel")
    return jnp.pad(small, [(0, 0), (off_y, FD - dh - off_y), (off_x, FD - dw - off_x), (0, 0)])


def jax_boxes(model, params, frames):
    det = model.apply(params, jax_fd_in(frames))
    box, _, _ = JO.best_box_decode(det["box_coords"], det["box_scores"], SCENE_HW, FD,
                                   letterboxed=True)
    return np.asarray(box), np.asarray(jnp.argmax(det["box_scores"], axis=-1))


def test_port_fidelity_on_the_cpu():
    res = FP.port_fidelity("cpu")
    assert set(res) == {"detector", "landmarks"}
    assert set(res["detector"]) == {"box_coords", "box_scores"}
    assert set(res["landmarks"]) == {"landmarks", "scores"}
    for outs in res.values():
        for v in outs.values():
            assert v["max_rel"] <= 1e-4


def test_decode_consistency_on_reference_scenes():
    frames, gt_box = reference_scenes(7)
    teacher = jrf.ReferenceFaceFinder()
    want_box, want_best = jax_boxes(teacher, jax.device_put(teacher.init_params()), frames)
    got_box, got_best = FP.served_boxes(trf.ReferenceFaceFinder("cpu"), torch.tensor(frames))
    np.testing.assert_array_equal(got_best, want_best)
    assert FP._iou(got_box.numpy(), want_box).min() >= 0.9999
    res = FP.decode_consistency(torch.tensor(frames), gt_box)
    assert res["n_scenes"] == N and res["best_anchor_agreement"] == 1.0
    assert res["box_iou_torch_vs_numpy_min"] >= 0.9999
    assert abs(res["teacher_box_vs_gt_iou_mean"]
               - float(FP._iou(want_box, gt_box.astype(np.float64)).mean())) <= 1e-3


def test_blaze_rows_match_the_jax_port():
    model = JL.load(f"{jrf.CKPT_DIR}/{FP.BLAZE_ONNX}")
    jfn, jparams = JE.build_jax_fn(model, nms_capacity=8)
    # the count kept, as face_parity.blaze_nms reads it: the NMS output a graph output too
    graph = trf.load_graph(FP.BLAZE_ONNX)
    nms = [n.outputs[0] for n in graph.graph.nodes if n.op_type == "NonMaxSuppression"]
    graph.graph.outputs.extend(nms)
    tfn, tparams = FP.onnx_exec.build_torch_fn(graph, nms_capacity=8)
    rng = np.random.default_rng(3)
    for i in range(N):
        img = FP.face_like(128, rng) if i % 2 == 0 else rng.random((1, 3, 128, 128), np.float32)
        feeds = {"image": img, "conf_threshold": np.asarray([0.05], np.float32),
                 "max_detections": np.asarray([8], np.int64),
                 "iou_threshold": np.asarray([0.5], np.float32)}
        # [1, 16] where one box is kept (the single-box collapse)
        n_ref = JE.run(model, feeds)["selectedBoxes"].reshape(1, -1, 16).shape[1]
        want = np.asarray(jax.jit(jfn)(jparams, **feeds)["selectedBoxes"])
        got = tfn(tparams, **{k: torch.as_tensor(v) for k, v in feeds.items()})
        assert int(got[nms[0] + "__valid"].sum()) == n_ref
        np.testing.assert_allclose(got["selectedBoxes"].numpy()[0, :n_ref], want[0, :n_ref],
                                   rtol=0, atol=1e-6)


def test_student_vs_reference_on_reference_scenes():
    frames, gt_box = reference_scenes(1234)
    teacher = jrf.ReferenceFaceFinder()
    t_box, _ = jax_boxes(teacher, jax.device_put(teacher.init_params()), frames)
    s_box, _ = jax_boxes(JM.FaceFinder(input_size=FD), restore_params("checkpoints/facefinder"),
                         frames)
    g = gt_box.astype(np.float64)
    roi = j_pad_box(jnp.asarray(t_box), 0.25, SCENE_HW)
    crop = JO.crop_and_resize_mxu(jnp.asarray(frames), roi, (LMK, LMK))
    t_lm_model = jrf.ReferenceLandmarkNet()
    t_lmk = np.asarray(t_lm_model.apply(jax.device_put(t_lm_model.init_params()),
                                        crop)["landmarks"])
    s_lmk = np.asarray(JM.LandmarkNet().apply(restore_params("checkpoints/landmarknet"),
                                              crop)["landmarks"])
    roi = np.asarray(roi)
    rw, rh = (roi[:, 2] - roi[:, 0])[:, None], (roi[:, 3] - roi[:, 1])[:, None]
    d = np.sqrt(((t_lmk[..., 0] - s_lmk[..., 0]) * rw) ** 2
                + ((t_lmk[..., 1] - s_lmk[..., 1]) * rh) ** 2)
    want = {"student_vs_teacher_iou_mean": float(FP._iou(s_box, t_box).mean()),
            "teacher_vs_gt_iou_mean": float(FP._iou(t_box, g).mean()),
            "student_vs_gt_iou_mean": float(FP._iou(s_box, g).mean())}
    got = FP.student_vs_reference(torch.tensor(frames), gt_box)
    assert got["n_scenes"] == N
    for k, v in want.items():
        assert abs(got["detector"][k] - v) <= 0.01, (k, got["detector"][k], v)
    # landmark distances in pixels: within 1 % of the JAX side's
    for k, v in (("student_vs_teacher_px_mean", d.mean()),
                 ("anchor5_px_mean", d[:, FP.ANCHOR5].mean())):
        assert abs(got["landmarks"][k] - v) <= 0.01 * v, (k, got["landmarks"][k], v)

