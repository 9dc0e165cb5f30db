"""The port's ONNX reader and torch graph executor against the JAX
package's (utils/onnx_lite.py, utils/onnx_exec.py::build_jax_fn), the
MediaPipe graphs whole against the reference's ReferenceFaceFinder and
ReferenceLandmarkNet, and the NMS of ops/detect.py.

Tolerances, with their reasons:
* the parser and the committed initializers: equal, bit for bit;
* one op at a time: rtol/atol 2e-5, tests/test_onnx_port.py's bar for the
  reference's own executor against its numpy oracle (float32 operations in
  another order);
* the graphs whole: rtol 1e-4, atol 1e-5, the bar the reference holds its
  own jitted graph to (tests/test_onnx_port.py::
  test_jax_port_matches_numpy_oracle); 69 or 45 f32 convolutions deep;
* box_iou, nms and nms_padded: exact (the same float32 operations, and
  the picks are indices).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_onnx_port import MATTING_OPS, _attr, _mk_model
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu.models import reference_face as jrf
from video_stream_segmenetation_tpu.ops import detect as JD
from video_stream_segmenetation_tpu.runtime.pipeline import _letterbox_to_square
from video_stream_segmenetation_tpu.utils import onnx_exec as JE
from video_stream_segmenetation_tpu.utils import onnx_lite as JL
from video_stream_segmenetation_tpu.utils.clips import articulated_clip
from video_stream_segmenetation_tpu_torch.models import reference_face as trf
from video_stream_segmenetation_tpu_torch.ops import detect as TD
from video_stream_segmenetation_tpu_torch.utils import onnx_exec as TE
from video_stream_segmenetation_tpu_torch.utils import onnx_lite as TL

GRAPHS = (("detector", trf.DETECTOR_ONNX), ("landmarks", trf.LANDMARK_ONNX))


# ---- the reader ------------------------------------------------------------


def _node_view(n):
    attrs = {k: (a.name, a.f, a.i, a.s, None if a.t is None else a.t.tolist(), a.floats,
                 a.ints) for k, a in n.attrs.items()}
    return (n.op_type, n.inputs, n.outputs, n.name, attrs)


@pytest.mark.parametrize("kind,name", GRAPHS)
def test_reader_matches_reference(kind, name):
    """The port's parse of the committed copy equals the reference's parse
    of its own: nodes, attributes, graph inputs and outputs, opset,
    producer, and every initializer bit for bit."""
    mine = trf.load_graph(name)
    ref = JL.load(f"{jrf.CKPT_DIR}/{name}")
    assert (mine.opset, mine.producer) == (ref.opset, ref.producer)
    g, r = mine.graph, ref.graph
    assert (g.inputs, g.outputs, g.name) == (r.inputs, r.outputs, r.name)
    assert [_node_view(n) for n in g.nodes] == [_node_view(n) for n in r.nodes]
    assert g.initializers.keys() == r.initializers.keys()
    for k, v in g.initializers.items():
        assert v.dtype == r.initializers[k].dtype and v.tobytes() == r.initializers[k].tobytes()


@pytest.mark.parametrize("kind,name", GRAPHS)
def test_initializers_equal_committed_npz(kind, name):
    """The initializers parsed from weights/face_ref/ equal
    checkpoints/face_ref/{detector,landmarks}.npz bit for bit."""
    inits = trf.load_graph(name).graph.initializers
    with np.load(f"{jrf.CKPT_DIR}/{kind}.npz") as z:
        assert set(z.files) == set(inits)
        for k in z.files:
            assert z[k].dtype == inits[k].dtype and z[k].shape == inits[k].shape
            assert z[k].tobytes() == inits[k].tobytes(), k


def test_graph_contracts_and_op_sets():
    """The served graphs' inputs, outputs and ops (the detector 148 nodes,
    the landmark net 101)."""
    det = trf.load_graph(trf.DETECTOR_ONNX)
    lmk = trf.load_graph(trf.LANDMARK_ONNX)
    assert det.graph.inputs == [("image", (1, 3, 256, 256))]
    assert lmk.graph.inputs == [("image", (1, 3, 192, 192))]
    assert TL.op_inventory(det) == {"Conv": 69, "Relu": 33, "Add": 31, "Transpose": 4,
                                    "Reshape": 4, "MaxPool": 3, "Pad": 2, "Concat": 2}
    assert set(TL.op_inventory(lmk)) == {"Conv", "PRelu", "Add", "MaxPool", "Pad", "Reshape",
                                         "Div", "Sigmoid"}
    assert (len(det.graph.nodes), len(lmk.graph.nodes)) == (148, 101)


def test_varint_parser_roundtrip():
    msg = bytes([0x08, 0xAC, 0x02, 0x12, 0x03]) + b"abc"
    assert list(TL._iter_fields(msg)) == list(JL._iter_fields(msg)) == [(1, 0, 300),
                                                                         (2, 2, b"abc")]


# ---- one op at a time -------------------------------------------------------

# the face graphs' ops and the rest of the executor's set, beyond
# tests/test_onnx_port.py's matting ops: (op, attributes, initializers as
# (name, maker) pairs fed after x, the input's shape)
_X = (2, 5, 8, 10)
FACE_OPS = [
    ("Conv", _attr(pads=[1, 0, 1, 2], strides=[2, 1]),
     (("w", lambda g: g.random((4, 5, 3, 3), np.float32) - 0.5),
      ("b", lambda g: g.random(4, np.float32))), _X),
    ("Conv", _attr(pads=[2, 2, 2, 2], dilations=[2, 2], group=5),
     (("w", lambda g: g.random((5, 1, 3, 3), np.float32) - 0.5),), _X),
    ("Relu", {}, (), _X),
    ("PRelu", {}, (("slope", lambda g: g.random((5, 1, 1), np.float32)),), _X),
    ("Add", {}, (("y", lambda g: g.random(_X, np.float32)),), _X),
    ("Mul", {}, (("y", lambda g: g.random((1, 5, 1, 1), np.float32)),), _X),
    ("Div", {}, (("y", lambda g: np.asarray(192.0, np.float32)),), _X),
    ("MatMul", {}, (("y", lambda g: g.random((10, 6), np.float32)),), _X),
    ("Sigmoid", {}, (), _X),
    ("Clip", {}, (("lo", lambda g: np.asarray(-0.25, np.float32)),
                  ("hi", lambda g: np.asarray(0.5, np.float32))), _X),
    ("MaxPool", _attr(kernel_shape=[2, 2], strides=[2, 2]), (), _X),
    ("MaxPool", _attr(kernel_shape=[3, 3], strides=[2, 2], pads=[1, 1, 0, 0], ceil_mode=1),
     (), _X),
    ("Pad", _attr(mode=b"constant"),
     (("pads", lambda g: np.asarray([0, 0, 0, 0, 0, 3, 1, 2], np.int64)),
      ("cval", lambda g: np.asarray(0.5, np.float32))), _X),
    ("Pad", _attr(mode=b"reflect"),
     (("pads", lambda g: np.asarray([0, 0, 2, 1, 0, 0, 1, 3], np.int64)),), _X),
    ("Pad", _attr(mode=b"edge"),
     (("pads", lambda g: np.asarray([0, 0, 2, 1, 0, 0, 1, 3], np.int64)),), _X),
    ("Reshape", {}, (("shape", lambda g: np.asarray([0, -1, 10], np.int64)),), _X),
    ("Transpose", _attr(perm=[0, 2, 3, 1]), (), _X),
    ("Concat", _attr(axis=1), (("y", lambda g: g.random((2, 3, 8, 10), np.float32)),), _X),
    ("Gather", _attr(axis=2), (("idx", lambda g: np.asarray([2, 0, 3], np.int64)),), _X),
    ("Squeeze", {}, (("axes", lambda g: np.asarray([1], np.int64)),), (2, 1, 8, 10)),
    ("Unsqueeze", {}, (("axes", lambda g: np.asarray([0, 3], np.int64)),), _X),
    ("Cast", _attr(to=6), (), _X),
    ("Flatten", _attr(axis=2), (), _X),
    ("Slice", {}, (("starts", lambda g: np.asarray([1, 2], np.int64)),
                   ("ends", lambda g: np.asarray([4, 100], np.int64)),
                   ("axes", lambda g: np.asarray([1, 3], np.int64)),
                   ("steps", lambda g: np.asarray([1, 2], np.int64))), _X),
]


def _op_case(op, attrs, extra, shape, rng):
    """One-node model of a FACE_OPS or tests/test_onnx_port.py MATTING_OPS
    case (the latter's initializers made as that test makes them)."""
    x = rng.random(shape).astype(np.float32) * 2 - 1
    if op == "Cast":
        x = x * 10
    inputs, inits = ["x"], {}
    if isinstance(extra, tuple):
        for name, make in extra:
            inits[name] = make(rng)
            inputs.append(name)
    elif extra == "binary":
        inits = {"y2nd": rng.random(_X).astype(np.float32)}
        inputs = ["x", "y2nd"]
    elif extra == "bn":
        inits = {"sc": rng.random(5).astype(np.float32) + 0.5,
                 "b": rng.random(5).astype(np.float32),
                 "mu": rng.random(5).astype(np.float32),
                 "va": rng.random(5).astype(np.float32) + 0.1}
        inputs = ["x", "sc", "b", "mu", "va"]
    elif extra == "resize":
        inits = {"roi": np.zeros(0, np.float32), "scales": np.zeros(0, np.float32),
                 "sizes": np.asarray([2, 5, 13, 7], np.int64)}
        inputs = ["x", "roi", "scales", "sizes"]
    outs = [f"y{k}" for k in range(2 if op == "Split" else 1)]
    node = JL.Node(op_type=op, inputs=inputs, outputs=outs, attrs=attrs, name=op)
    return _mk_model([node], inits, [("x", x.shape)], outs), x, outs


OP_CASES = ([pytest.param(op, a, e, _X, id=f"matting-{k}-{op}")
             for k, (op, a, e) in enumerate(MATTING_OPS)]
            + [pytest.param(op, a, e, s, id=f"face-{k}-{op}")
               for k, (op, a, e, s) in enumerate(FACE_OPS)])


@pytest.mark.parametrize("op,attrs,extra,shape", OP_CASES)
def test_op_matches_build_jax_fn(op, attrs, extra, shape, rng):
    """build_torch_fn against build_jax_fn, one op, the reference's own
    cases (tests/test_onnx_port.py::MATTING_OPS) and the face graphs' ops."""
    model, x, outs = _op_case(op, attrs, extra, shape, rng)
    jfn, jparams = JE.build_jax_fn(model)
    want = jax.jit(lambda p, x: jfn(p, x=x))(
        {k: jnp.asarray(v) for k, v in jparams.items()}, jnp.asarray(x))
    tfn, tparams = TE.build_torch_fn(model)
    got = tfn(tparams, x=torch.tensor(x))
    for o in outs:
        w = np.asarray(want[o])
        g = got[o].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape, g.dtype, w.dtype)
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5)


def test_op_outside_the_set_raises_at_build():
    node = JL.Node(op_type="Erf", inputs=["x"], outputs=["y"], attrs={}, name="erf")
    with pytest.raises(NotImplementedError, match="Erf"):
        TE.build_torch_fn(_mk_model([node], {}, [("x", _X)], ["y"]))


def test_reshape_keeps_the_batch_of_a_batch_one_export(rng):
    """A target starting with a constant 1 keeps the input's leading axis:
    K images through the batch-1 reshape give each image's own result."""
    node = JL.Node(op_type="Reshape", inputs=["x", "shape"], outputs=["y"], attrs={},
                   name="r")
    model = _mk_model([node], {"shape": np.asarray([1, -1, 16], np.int64)},
                      [("x", (1, 4, 8, 8))], ["y"])
    x = rng.random((3, 4, 8, 8), dtype=np.float32)
    fn, p = TE.build_torch_fn(model)
    got = fn(p, x=torch.tensor(x))["y"].numpy()
    assert got.shape == (3, 16, 16)
    for k in range(3):
        np.testing.assert_array_equal(got[k], x[k].reshape(16, 16))


def test_blaze_graph_matches_build_jax_fn():
    """blaze.onnx (its in-graph NMS, MatMul, Clip, Gather, Squeeze) on a
    rendered person at batch 1, against build_jax_fn."""
    model = JL.load(f"{jrf.CKPT_DIR}/{jrf.BLAZE_ONNX}")
    frame = articulated_clip(n_frames=1, hw=(128, 128), seed=2, features=True).frames
    img = np.transpose(frame.astype(np.float32) / 255.0, (0, 3, 1, 2))
    feeds = {"image": img, "conf_threshold": np.asarray([0.3], np.float32),
             "max_detections": np.asarray([5], np.int64),
             "iou_threshold": np.asarray([0.3], np.float32)}
    jfn, jp = JE.build_jax_fn(model)
    want = jfn({k: jnp.asarray(v) for k, v in jp.items()},
               **{k: jnp.asarray(v) for k, v in feeds.items()})
    tfn, tp = TE.build_torch_fn(model)
    got = tfn(tp, **{k: torch.tensor(v) for k, v in feeds.items()})
    assert set(got) == set(want) == {"selectedBoxes"}
    np.testing.assert_allclose(got["selectedBoxes"].numpy(), np.asarray(want["selectedBoxes"]),
                               rtol=1e-4, atol=1e-5)


# ---- the graphs whole -------------------------------------------------------


def _faces(size: int) -> np.ndarray:
    """K=2 different images: a letterboxed rendered person, and noise."""
    frames = articulated_clip(n_frames=1, hw=(160, 320), seed=2, features=True).frames
    face = _letterbox_to_square(jnp.asarray(frames, jnp.float32) / 255.0, (160, 320), size,
                                impl="mxu")
    noise = np.random.default_rng(5).random((1, size, size, 3), dtype=np.float32)
    return np.concatenate([np.asarray(face), noise])


def test_reference_face_finder_matches():
    x = _faces(256)
    ref = jrf.ReferenceFaceFinder()
    want = ref.apply(ref.init_params(), jnp.asarray(x))
    got = trf.ReferenceFaceFinder("cpu")(torch.tensor(x))
    for k in ("box_coords", "box_scores"):
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-5)
    # the two streams differ: a mix-up would fail
    assert np.abs(np.asarray(want["box_coords"][0] - want["box_coords"][1])).max() > 1e-2


def test_reference_landmark_net_matches():
    x = _faces(192)
    ref = jrf.ReferenceLandmarkNet()
    want = ref.apply(ref.init_params(), jnp.asarray(x))
    got = trf.ReferenceLandmarkNet("cpu")(torch.tensor(x))
    assert tuple(got["landmarks"].shape) == (2, 468, 3) and tuple(got["scores"].shape) == (2,)
    for k in ("landmarks", "scores"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-5)
    assert np.abs(np.asarray(want["landmarks"][0] - want["landmarks"][1])).max() > 1e-2


# ---- NMS ----------------------------------------------------------------------


def _boxes(rng, n=40):
    centers = rng.random((n, 2)).astype(np.float32)
    sizes = (rng.random((n, 2)) * 0.3 + 0.05).astype(np.float32)
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], axis=1)
    scores = rng.random(n).astype(np.float32)
    scores[[3, n - 3]] = scores[7]  # ties: the first index wins
    boxes[5, 2:] = boxes[5, :2]  # an empty box
    return boxes.astype(np.float32), scores


def test_box_iou_matches(rng):
    a, _ = _boxes(rng, 12)
    b, _ = _boxes(rng, 9)
    np.testing.assert_array_equal(TD.box_iou(torch.tensor(a), torch.tensor(b)).numpy(),
                                  np.asarray(JD.box_iou(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("iou_thr,score_thr,k", [(0.4, 0.3, 10), (0.2, 0.0, 40),
                                                  (0.5, 0.95, 6)])
def test_nms_padded_matches(rng, iou_thr, score_thr, k):
    boxes, scores = _boxes(rng)
    want = jax.jit(lambda b, s: JD.nms_padded(b, s, k, iou_thr, score_thr))(
        jnp.asarray(boxes), jnp.asarray(scores))
    got = TD.nms_padded(torch.tensor(boxes), torch.tensor(scores), k, iou_thr, score_thr)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[0].dtype == torch.int32
    # and the ONNX greedy oracle
    sel = JE._np_nms(boxes[None], scores[None, None], k, iou_thr, score_thr)
    np.testing.assert_array_equal(got[0].numpy()[got[1].numpy()], sel[:, 2])


@pytest.mark.parametrize("iou_thr,score_thr,k", [(0.3, 0.5, 5), (0.2, 0.9, 8)])
def test_nms_matches(rng, iou_thr, score_thr, k):
    boxes, scores = _boxes(rng)
    want = JD.nms(jnp.asarray(boxes), jnp.asarray(scores), iou_thr, score_thr, k)
    got = TD.nms(torch.tensor(boxes), torch.tensor(scores), iou_thr, score_thr, k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(got[2].any())
