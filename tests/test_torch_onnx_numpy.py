"""The port's numpy ONNX executor (utils/onnx_numpy.py::run, re-exported as
utils/onnx_exec.py::run) against the JAX package's (utils/onnx_exec.py::run)
on the three committed graphs and on one-node graphs of every op the
executors cover; then the port's torch executor (build_torch_fn) on the CPU
against the port's numpy one.

Tolerances, with their reasons:
* the two numpy executors: equal, bit for bit (the same numpy operations
  in the same order);
* build_torch_fn against ``run``: each output's largest difference within
  1e-4 of its largest value, the measure of the reference's record of its
  own executors (PARITY.json ``port_fidelity``, ``max_rel``: 1e-6 to 4e-6)
  and of face_parity.py (element by element, rtol 1e-4 / atol 1e-5 as
  tests/test_onnx_port.py holds the landmark graph, 3 of the detector's
  14336 box coordinates near 0 depart by 2.5e-5); the blaze graph's NMS:
  the same count kept, the selected rows within 1e-6.
"""

import filecmp

import numpy as np
import pytest
import torch

from tests.test_torch_onnx import OP_CASES, _op_case
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu.models import reference_face as jrf
from video_stream_segmenetation_tpu.utils import onnx_exec as JE
from video_stream_segmenetation_tpu.utils import onnx_lite as JL
from video_stream_segmenetation_tpu_torch import face_parity
from video_stream_segmenetation_tpu_torch.models import reference_face as trf
from video_stream_segmenetation_tpu_torch.utils import onnx_exec as TE
from video_stream_segmenetation_tpu_torch.utils import onnx_numpy as TN

# (graph, its image input's size)
GRAPHS = ((trf.DETECTOR_ONNX, 256), (trf.LANDMARK_ONNX, 192), (face_parity.BLAZE_ONNX, 128))


def test_blaze_graph_is_the_committed_one():
    """weights/face_ref/blaze.onnx is checkpoints/face_ref/blaze.onnx byte
    for byte."""
    assert filecmp.cmp(trf.FACE_REF_DIR / face_parity.BLAZE_ONNX,
                       f"{jrf.CKPT_DIR}/{face_parity.BLAZE_ONNX}", shallow=False)


def test_run_is_the_numpy_executor():
    assert TE.run is TN.run


def _feeds(name, size, kind, rng):
    img = (face_parity.face_like(size, rng) if kind == "face"
           else rng.random((1, 3, size, size), np.float32))
    feeds = {"image": img}
    if name == face_parity.BLAZE_ONNX:
        feeds.update(conf_threshold=np.asarray([0.05], np.float32),
                     max_detections=np.asarray([8], np.int64),
                     iou_threshold=np.asarray([0.5], np.float32))
    return feeds


def _equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("kind", ["random", "face"])
@pytest.mark.parametrize("name,size", GRAPHS)
def test_run_matches_reference_run_on_the_graphs(name, size, kind, rng):
    feeds = _feeds(name, size, kind, rng)
    got = TN.run(trf.load_graph(name), feeds)
    want = JE.run(JL.load(f"{jrf.CKPT_DIR}/{name}"), feeds)
    _equal(got, want)


@pytest.mark.parametrize("op,attrs,extra,shape", OP_CASES)
def test_run_matches_reference_run_one_op(op, attrs, extra, shape, rng):
    model, x, _ = _op_case(op, attrs, extra, shape, rng)
    _equal(TN.run(model, {"x": x}), JE.run(model, {"x": x}))


@pytest.mark.parametrize("center_box", [0, 1])
def test_nms_matches_reference_nms(center_box, rng):
    """The true ONNX greedy NMS, corner and centre boxes, several classes
    and batches, thresholds that suppress."""
    boxes = rng.random((2, 40, 4)).astype(np.float32)
    scores = rng.random((2, 3, 40)).astype(np.float32)
    for args in ((10, 0.4, 0.3), (40, 0.2, -np.inf), (5, 0.7, 0.9)):
        got = TN._np_nms(boxes, scores, *args, center_box=center_box)
        want = JE._np_nms(boxes, scores, *args, center_box=center_box)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("name,size", GRAPHS[:2])
def test_build_torch_fn_matches_run(name, size, rng):
    model = trf.load_graph(name)
    fn, params = TE.build_torch_fn(model)
    for kind in ("random", "face"):
        feeds = _feeds(name, size, kind, rng)
        want = TN.run(model, feeds)
        got = fn(params, image=torch.as_tensor(feeds["image"]))
        for k in want:
            d = np.abs(got[k].numpy() - want[k])
            assert d.max() / np.abs(want[k]).max() <= 1e-4, (k, d.max())


def test_blaze_nms_matches_run(rng):
    """blaze.onnx whole: the fixed-capacity NMS keeps the numpy executor's
    count (the ``__valid`` mask of its output, made a graph output) and
    its rows."""
    res = face_parity.blaze_nms(n=4, device="cpu")
    assert res["selected_count_match"] and res["rows_checked"] > 4
    assert res["max_abs_diff"] <= 1e-6
