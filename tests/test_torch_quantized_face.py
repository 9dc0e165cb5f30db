"""The port's int8 face models (models/quantized_face.py) against the JAX
package's: the quantizers on the trained FaceFinder and LandmarkNet trees,
the int8 activations layer by layer, and the served outputs, at both face
geometries the presets use (128/128 and 256/192).

Tolerances, with their reasons:
* the quantizers: bit for bit (the same float64 fold and rounding);
* every s8 activation, the input lattice included: exact (integer sums of
  int8 products, then the same f32 epilogue and round-half-even);
* the heads' f32 outputs: 1e-6 relative plus 1e-6 absolute (``acc * mult
  + bias`` in f32, which XLA may contract into one fused multiply-add);
  the decoded boxes then within 1e-6 of a normalized coordinate;
* LandmarkNet's pooled float head: landmarks and score within 1e-5 (the
  mean over the pooled grid sums in another order, then a 256 x 1405 f32
  product).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu import models as jm
from video_stream_segmenetation_tpu.models import quantized as JQ
from video_stream_segmenetation_tpu.models import quantized_face as JQF
from video_stream_segmenetation_tpu.utils.checkpoint import restore_params
from video_stream_segmenetation_tpu.utils.clips import articulated_clip
from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.models import quantized as TQ
from video_stream_segmenetation_tpu_torch.models import quantized_face as TQF

T = torch.tensor
GEOMS = (("facefinder_128", "landmarknet_128", 128, 128),
         ("facefinder", "landmarknet", 256, 192))


@pytest.fixture(scope="module")
def trees():
    names = {n for g in GEOMS for n in g[:2]}
    return {n: jax.tree_util.tree_map(np.asarray, restore_params(f"checkpoints/{n}"))
            for n in names}


def _images(size: int) -> np.ndarray:
    """K=3 different images: two rendered people resized, one of noise."""
    frames = np.concatenate([articulated_clip(n_frames=1, hw=(size, size), seed=sd,
                                              features=True).frames for sd in (2, 4)])
    noise = np.random.default_rng(3).random((1, size, size, 3), dtype=np.float32)
    return np.concatenate([frames.astype(np.float32) / 255.0, noise])


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def _assert_same_dict(got: dict, want: dict):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for k in g:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        assert g[k].tobytes() == w[k].tobytes(), k


@pytest.mark.parametrize("fd,lm,fd_size,lmk_size", GEOMS)
def test_quantizers_match_bit_for_bit(trees, fd, lm, fd_size, lmk_size):
    _assert_same_dict(TQF.quantize_face_finder(bridge.float_tree(trees[fd])),
                      JQF.quantize_face_finder(None, trees[fd]))
    _assert_same_dict(TQF.quantize_landmark_net(bridge.float_tree(trees[lm])),
                      JQF.quantize_landmark_net(None, trees[lm]))


def test_qconvbn_input_scale_leaves_the_trunk_alone(trees):
    """The input-scale argument of the trunk's quantizer defaults to the
    relu6 lattice: the trunk's layers are quantized as before."""
    tree = bridge.float_tree(trees["facefinder"])
    p, st = tree["params"], tree["batch_stats"]
    a = TQ._qconvbn(p, st, "ConvBN_3")
    b = TQ._qconvbn(p, st, "ConvBN_3", TQ.ACT_SCALE)
    c = TQ._qconvbn(p, st, "ConvBN_3", TQF.IN_SCALE)
    _assert_same_dict(a, b)
    np.testing.assert_array_equal(a["wq"], c["wq"])
    assert not np.array_equal(a["mult"], c["mult"])


def _jax_trunk(q, layers, x):
    """The reference's int8 trunk, its s8 activation after every layer."""
    acts = [np.asarray(JQF._quant_input(jnp.asarray(x)))]
    h = jnp.asarray(acts[0])
    for nm, strides in layers:
        h = JQ._requant(JQ._conv_i8(h, q[nm], strides=strides))
        acts.append(np.asarray(h))
    return acts


def _torch_trunk(model, layers, x):
    acts = [TQF._quant_input(T(x))]
    h = acts[0]
    for (_, stride), layer in zip(layers, model.trunk):
        h = TQ._requant(TQ._conv_i8(h, layer, stride=stride))
        acts.append(h)
    return [a.numpy() for a in acts]


@pytest.mark.parametrize("fd,lm,fd_size,lmk_size", GEOMS)
def test_face_finder_int8_matches(trees, fd, lm, fd_size, lmk_size):
    x = _images(fd_size)
    jq = JQF.quantize_face_finder(None, trees[fd])
    tm = TQF.QuantizedFaceFinder(TQF.quantize_face_finder(bridge.float_tree(trees[fd])),
                                 fd_size, device="cpu")
    for k, (g, w) in enumerate(zip(_torch_trunk(tm, TQF._FF_TRUNK, x),
                                   _jax_trunk(jq, JQF._FF_TRUNK, x))):
        assert g.dtype == w.dtype == np.int8
        np.testing.assert_array_equal(g, w, err_msg=f"activation {k}")
    want = JQF.QuantizedFaceFinder(fd_size).apply(jq, jnp.asarray(x))
    got = tm(T(x))
    np.testing.assert_allclose(got["box_coords"].numpy(), np.asarray(want["box_coords"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["box_scores"].numpy(), np.asarray(want["box_scores"]),
                               rtol=1e-6, atol=1e-6)
    # the int8 detector finds the rendered people as the float one does
    fl = jm.FaceFinder(input_size=fd_size).apply(trees[fd], jnp.asarray(x))
    best = np.asarray(want["box_scores"]).argmax(-1)
    assert (got["box_scores"].numpy().argmax(-1)[:2] == best[:2]).all()
    assert (np.asarray(fl["box_scores"]).max(-1)[:2] > 0.6).all()


@pytest.mark.parametrize("fd,lm,fd_size,lmk_size", GEOMS)
def test_landmark_net_int8_matches(trees, fd, lm, fd_size, lmk_size):
    x = _images(lmk_size)
    jq = JQF.quantize_landmark_net(None, trees[lm])
    tm = TQF.QuantizedLandmarkNet(TQF.quantize_landmark_net(bridge.float_tree(trees[lm])),
                                  device="cpu")
    for k, (g, w) in enumerate(zip(_torch_trunk(tm, TQF._LMK_TRUNK, x),
                                   _jax_trunk(jq, JQF._LMK_TRUNK, x))):
        np.testing.assert_array_equal(g, w, err_msg=f"activation {k}")
    want = JQF.QuantizedLandmarkNet().apply(jq, jnp.asarray(x))
    got = tm(T(x))
    assert tuple(got["landmarks"].shape) == (3, 468, 3) and tuple(got["scores"].shape) == (3,)
    for key in ("landmarks", "scores"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("fd,lm,fd_size,lmk_size", GEOMS[:1])
def test_bridge_carries_the_reference_quantized_dicts(trees, fd, lm, fd_size, lmk_size):
    """bridge.load_quantized_face takes the reference's quantized dicts to
    the port's: the same dicts the port's quantizers make, bit for bit,
    and the same served outputs."""
    jq = JQF.quantize_face_finder(None, trees[fd])
    jl = JQF.quantize_landmark_net(None, trees[lm])
    _assert_same_dict(bridge.load_quantized_face(jq),
                      TQF.quantize_face_finder(bridge.float_tree(trees[fd])))
    _assert_same_dict(bridge.load_quantized_face(jl),
                      TQF.quantize_landmark_net(bridge.float_tree(trees[lm])))
    x = T(_images(fd_size))
    a = TQF.QuantizedFaceFinder(bridge.load_quantized_face(jq), fd_size, device="cpu")(x)
    b = TQF.QuantizedFaceFinder(TQF.quantize_face_finder(bridge.float_tree(trees[fd])),
                                fd_size, device="cpu")(x)
    for k in a:
        assert torch.equal(a[k], b[k])
