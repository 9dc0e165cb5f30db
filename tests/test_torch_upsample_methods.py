"""The three upsample methods ('half_pixel', 'asymmetric', 'align_corners')
in the port against the JAX package on the CPU: every resize function of
ops/resize.py, the natural layout's composite kernel's plain version
(kernels/composite_fused.py) against the reference's Pallas
``fused_composite`` in interpret mode, and the packed composite
(ops/layout.py::alpha_composite_s2d) at both precisions against the
reference's.  Inputs are made from seeds with numpy.

Tolerances, with their reasons:
* taps, interpolation matrices, nearest resizes and the identity shortcut:
  equal (the same float64 coordinates in numpy);
* the gather resize: equal (the same two gathers and blend in f32); the
  matrix resize in f32 (the reference's HIGHEST): within 1e-6 (the f32
  product's sums may round apart);
* the composite kernel's plain version: at most one u8 step, at no more
  than 0.1 % of the values (tests/test_torch_composite.py's bar: the port
  rounds each row's two vertical taps once in f64, the interpret-mode f32
  dot may round them apart);
* the packed composite: at most one u8 step, at under 1 % of the values
  with 'fast' (tests/test_torch_ops.py's: bf16 products whose f32 sums may
  round apart before the bf16 rounding) and under 0.1 % with 'exact' (f32
  products, the same sums rounded apart only in the last place).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu.kernels.composite_fused import fused_composite as jfc
from video_stream_segmenetation_tpu.ops import layout as JL
from video_stream_segmenetation_tpu.ops import resize as JR
from video_stream_segmenetation_tpu_torch.kernels import composite_fused as TC
from video_stream_segmenetation_tpu_torch.ops import layout as TL
from video_stream_segmenetation_tpu_torch.ops import resize as TR

METHODS = ("half_pixel", "asymmetric", "align_corners")
# (out, in): up, down, to and from one, and the identity
SIZES = ((32, 8), (720, 288), (13, 40), (1, 5), (7, 1), (16, 16))
T = torch.tensor


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("out_in", SIZES, ids=[f"{o}from{i}" for o, i in SIZES])
def test_taps_and_matrices_equal(method, out_in):
    out_size, in_size = out_in
    np.testing.assert_array_equal(TR._axis_coords(out_size, in_size, method),
                                  JR._axis_coords(out_size, in_size, method))
    for a, b in zip(TR._linear_taps(out_size, in_size, method),
                    JR._linear_taps(out_size, in_size, method)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TR._nearest_taps(out_size, in_size, method),
                                  JR._nearest_taps(out_size, in_size, method))
    np.testing.assert_array_equal(TR.interp_matrix(out_size, in_size, method).numpy(),
                                  JR._interp_matrix(out_size, in_size, method))


def test_align_corners_to_one_reads_the_first_pixel():
    """out == 1: the source coordinate is 0, not 0/0."""
    np.testing.assert_array_equal(TR._axis_coords(1, 9, "align_corners"), [0.0])
    x = T(np.arange(9, dtype=np.float32).reshape(1, 9, 1))
    assert TR.resize_bilinear(x, (1, 1), "align_corners").item() == 0.0


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("in_hw,out_hw", [((8, 16), (32, 64)), ((80, 160), (33, 50)),
                                          ((9, 12), (1, 5)), ((20, 24), (20, 24))],
                         ids=["up", "down", "to-one", "identity"])
def test_resizes_match(rng, method, in_hw, out_hw):
    """resize_bilinear (gathers, channel-last and planar), resize_frames_u8,
    resize_nearest (u8) and resize_bilinear_mxu (f32) at each method; at
    equal sizes with a method other than 'half_pixel' the gathers return
    the input itself, as the reference's shortcut does."""
    x = rng.random((2, *in_hw, 3), dtype=np.float32)
    u8 = rng.integers(0, 256, (2, *in_hw, 3), dtype=np.uint8)
    p = rng.random((2, *in_hw), dtype=np.float32)
    jx = jnp.asarray(x)
    np.testing.assert_array_equal(TR.resize_bilinear(T(x), out_hw, method).numpy(),
                                  np.asarray(JR.resize_bilinear(jx, out_hw, method)))
    np.testing.assert_array_equal(
        TR.resize_bilinear(T(p), out_hw, method, channel_last=False).numpy(),
        np.asarray(JR.resize_bilinear(jnp.asarray(p), out_hw, method, channel_last=False)))
    np.testing.assert_array_equal(
        TR.resize_frames_u8(T(u8), out_hw, method).numpy(),
        np.asarray(JR.resize_bilinear(jnp.asarray(u8).astype(jnp.float32) / 255.0, out_hw,
                                      method)))
    np.testing.assert_array_equal(TR.resize_nearest(T(u8), out_hw, method).numpy(),
                                  np.asarray(JR.resize_nearest(jnp.asarray(u8), out_hw,
                                                               method)))
    np.testing.assert_allclose(
        TR.resize_bilinear_mxu(T(x), out_hw, method).numpy(),
        np.asarray(JR.resize_bilinear_mxu(jx, out_hw, method,
                                          precision=jax.lax.Precision.HIGHEST)),
        rtol=0, atol=1e-6)
    if in_hw == out_hw and method != "half_pixel":
        t = T(x)
        assert TR.resize_bilinear(t, out_hw, method) is t


def _case(rng, s, h, w, mh, mw):
    frames = rng.integers(0, 256, (s, h, w, 3), dtype=np.uint8)
    bg = rng.integers(0, 256, (s, h, w, 3), dtype=np.uint8)
    alpha = rng.random((s, mh, mw), dtype=np.float32)
    alpha[0, : mh // 4] = 0.0
    alpha[-1, -(mh // 4):] = 1.0
    return frames, alpha, bg


def _held(got, want, share):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= share, (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("s,h,w,mh,mw", [(2, 80, 160, 32, 64), (1, 160, 128, 64, 64)],
                         ids=["80x160", "160x128"])
def test_composite_plain_matches_pallas(rng, method, s, h, w, mh, mw):
    """The composite kernel's plain version at each method's taps against
    the reference's kernel (interpret mode) at the same method; the tap
    tables it hands the kernel rebuild the interpolation matrices."""
    frames, alpha, bg = _case(rng, s, h, w, mh, mw)
    want = np.asarray(jfc(jnp.asarray(frames), jnp.asarray(alpha), jnp.asarray(bg),
                          method=method, interpret=True))
    got = TC.fused_composite(T(frames), T(alpha), T(bg), method=method)
    assert got.dtype == torch.uint8 and tuple(got.shape) == frames.shape
    _held(got.numpy(), want, 1e-3)
    for out_size, in_size in ((h, mh), (w, mw)):
        idx, wgt = TC._two_taps(out_size, in_size, method)
        m = np.zeros((out_size, in_size), np.float32)
        for k in range(2):
            np.add.at(m, (np.arange(out_size), idx[:, k]), wgt[:, k])
        np.testing.assert_array_equal(m, JR._interp_matrix(out_size, in_size, method))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("precision", ["fast", "exact"])
@pytest.mark.parametrize("block,geom", [(10, ((80, 160), (32, 64))), (5, ((80, 160), (32, 64))),
                                        (10, ((80, 160), (8, 16)))],
                         ids=["b10-up4", "b5-up2", "b10-identity"])
def test_packed_composite_matches(rng, method, precision, block, geom):
    """alpha_composite_s2d at each method, 'fast' (the reference's DEFAULT:
    bf16 operands and results) and 'exact' (its HIGHEST: f32)."""
    (fh, fw), (mh, mw) = geom
    hp, wp, c = fh // block, fw // block, block * block * 3
    fp = rng.integers(0, 256, (2, hp, wp, c), dtype=np.uint8)
    bg = rng.integers(0, 256, (2, hp, wp, c), dtype=np.uint8)
    a = rng.random((2, mh, mw), dtype=np.float32)
    prec = jax.lax.Precision.DEFAULT if precision == "fast" else jax.lax.Precision.HIGHEST
    want = np.asarray(JL.alpha_composite_s2d(jnp.asarray(fp), jnp.asarray(a), jnp.asarray(bg),
                                             (fh, fw), block, method=method, precision=prec))
    got = TL.alpha_composite_s2d(T(fp), T(a), T(bg), (fh, fw), block, method=method,
                                 precision=precision).numpy()
    _held(got, want, 1e-2 if precision == "fast" else 1e-3)
