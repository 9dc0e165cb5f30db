"""The torch port's plain ops vs the JAX package's ops on the same seeded
numpy inputs (CPU).  Exact where both sides do the same float operations;
otherwise the tolerance is stated at the test."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu import ops as J
from video_stream_segmenetation_tpu.ops.prior import prior_plane_from_params as j_prior
from video_stream_segmenetation_tpu.ops.resize import _interp_matrix as j_interp
from video_stream_segmenetation_tpu_torch.ops import bilateral as TB
from video_stream_segmenetation_tpu_torch.ops import layout as TL
from video_stream_segmenetation_tpu_torch.ops import morphology as TM
from video_stream_segmenetation_tpu_torch.ops import prior as TP
from video_stream_segmenetation_tpu_torch.ops import refine as TRf
from video_stream_segmenetation_tpu_torch.ops import resize as TRs
from video_stream_segmenetation_tpu_torch.ops import temporal as TT
from video_stream_segmenetation_tpu_torch.ops import warp as TW

S, H, W = 3, 24, 40


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_space_to_depth_roundtrip_matches_jax(rng):
    x = rng.integers(0, 256, (2, 40, 60, 3), dtype=np.uint8)
    got = TL.space_to_depth(_t(x), 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(J.space_to_depth(jnp.asarray(x), 10)))
    np.testing.assert_array_equal(TL.depth_to_space(got, 10).numpy(), x)


@pytest.mark.parametrize("geom", [((80, 160), (32, 64)), ((720, 1280), (288, 512)),
                                  ((80, 160), (24, 48))])
def test_planar_guide_matches_jax(rng, geom):
    """Exact u8 selection of the nearest half-pixel taps."""
    (fh, fw), out_hw = geom
    xp = rng.integers(0, 256, (1, fh // 10, fw // 10, 300), dtype=np.uint8)
    want = np.asarray(J.guide_from_s2d(jnp.asarray(xp), (fh, fw), out_hw, 10, planar=True))
    got = TL.guide_from_s2d(_t(xp), (fh, fw), out_hw, 10).numpy()
    np.testing.assert_array_equal(got, want)


def test_packed_composite_within_one_u8_step(rng):
    """Same bf16 roundings as the reference's DEFAULT-precision products;
    a different sum order can move a rounding by one u8 step."""
    fh, fw = 80, 160
    fp = rng.integers(0, 256, (2, 8, 16, 300), dtype=np.uint8)
    bg = rng.integers(0, 256, (2, 8, 16, 300), dtype=np.uint8)
    a = rng.random((2, 32, 64), dtype=np.float32)
    want = np.asarray(J.alpha_composite_s2d(jnp.asarray(fp), jnp.asarray(a), jnp.asarray(bg),
                                            (fh, fw), 10, impl="dot30")).astype(np.int32)
    got = TL.alpha_composite_s2d(_t(fp), _t(a), _t(bg), (fh, fw), 10).numpy().astype(np.int32)
    assert np.abs(got - want).max() <= 1
    assert np.mean(got != want) < 0.01


def test_packed_color_matches_jax():
    c = (20 / 255, 25 / 255, 30 / 255)
    np.testing.assert_array_equal(TL.packed_color(c, 10).numpy(),
                                  np.asarray(J.packed_color(c, 10)))


@pytest.mark.parametrize("out_in", [(288, 72), (512, 128), (32, 8), (720, 288)])
def test_interp_matrix_matches_jax(out_in):
    np.testing.assert_array_equal(TRs._interp_matrix(*out_in, "half_pixel"),
                                  j_interp(*out_in, "half_pixel"))


def test_invert_affine_and_separable_warp_match_jax(rng):
    aff = np.asarray([[1.05, 0.0, 2.5, 0.0, 0.97, -1.5], [0, 0, 0, 0, 0, 0],
                      [1.0, 0.0, 30.0, 0.0, 1.0, 12.0]], np.float32)
    np.testing.assert_array_equal(TW.invert_affine(_t(aff)).numpy(),
                                  np.asarray(J.invert_affine(jnp.asarray(aff))))
    src = rng.random((S, H, W), dtype=np.float32)
    yi, xi = TW.separable_warp_indices(_t(aff), (H, W))
    got = TW.warp_separable_gather(_t(src), yi, xi).numpy()
    want = np.asarray(J.warp_affine_separable(jnp.asarray(src), jnp.asarray(aff)))
    np.testing.assert_array_equal(got, want)


def test_temporal_ema_and_affine_lowpass_match_jax(rng):
    prev, cur = rng.random((2, S, H, W), dtype=np.float32)
    ema = np.asarray([0.55, 0.7, 0.3], np.float32)
    adapt = np.asarray([1.0, 0.0, 0.5], np.float32)
    init = np.asarray([True, False, True])
    got, _ = TT.temporal_ema(_t(prev), _t(cur), _t(ema), _t(init), adapt=_t(adapt))
    want, _ = J.temporal_ema(jnp.asarray(prev), jnp.asarray(cur), jnp.asarray(ema),
                             jnp.asarray(init), adapt=jnp.asarray(adapt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    last, upd = rng.random((2, S, 6), dtype=np.float32)
    hl, hu = np.asarray([True, False, True]), np.asarray([True, True, False])
    got = TT.affine_lowpass(_t(last), _t(upd), 0.7, _t(hl), _t(hu))
    want = J.affine_lowpass(jnp.asarray(last), jnp.asarray(upd), 0.7, jnp.asarray(hl),
                            jnp.asarray(hu))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_morphology_matches_jax_exactly(rng):
    a = rng.random((S, H, W), dtype=np.float32)
    prior = np.asarray(j_prior(12.0, 10.0, 9.0, 7.0, (H, W)))[None].repeat(S, 0)
    has = np.asarray([True, False, True])
    np.testing.assert_array_equal(TM.morphological_opening(_t(a)).numpy(),
                                  np.asarray(J.morphological_opening(jnp.asarray(a))))
    got = TM.morphological_closing_in_prior(_t(a), _t(prior), _t(has)).numpy()
    want = J.morphological_closing_in_prior(jnp.asarray(a), jnp.asarray(prior), jnp.asarray(has))
    np.testing.assert_array_equal(got, np.asarray(want))


def test_bilateral_planar_guide_matches_jax(rng):
    """The port takes the guide planar [S, 3, H, W]; exp() ulps differ."""
    a = rng.random((S, H, W), dtype=np.float32)
    g = rng.integers(0, 256, (S, 3, H, W), dtype=np.uint8)
    ss = np.asarray([1.0, 2.0, 0.7], np.float32)
    sr = np.asarray([12.0, 30.0, 6.0], np.float32)
    got = TB.joint_bilateral3x3(_t(a), _t(g), _t(ss), _t(sr)).numpy()
    want = J.joint_bilateral3x3(jnp.asarray(a), jnp.asarray(g.transpose(0, 2, 3, 1), jnp.float32),
                                jnp.asarray(ss), jnp.asarray(sr))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2e-6)


def test_refine_alpha_matches_jax(rng):
    a = rng.random((S, H, W), dtype=np.float32)
    prior = np.asarray(j_prior(20.0, 12.0, 11.0, 9.0, (H, W)))[None].repeat(S, 0)
    lo = np.asarray([0.06, 0.1, 0.0], np.float32)
    hi = np.asarray([0.95, 0.8, 1.0], np.float32)
    ga = np.asarray([0.4, 1.0, 2.0], np.float32)
    has = np.asarray([True, False, True])
    got = TRf.refine_alpha(_t(a), _t(lo), _t(hi), _t(ga), _t(prior), _t(has)).numpy()
    want = J.refine_alpha(jnp.asarray(a), jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(ga),
                          jnp.asarray(prior), jnp.asarray(has))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2e-6)


def test_prior_plane_matches_jax():
    pp = np.asarray([[20.0, 12.0, 11.0, 9.0], [5.0, 30.0, 1e-6, 4.0]], np.float32)
    got = TP.prior_plane_from_params(_t(pp), (H, W)).numpy()
    for s in range(2):
        want = np.asarray(j_prior(*(jnp.float32(v) for v in pp[s]), (H, W)))
        np.testing.assert_allclose(got[s], want, rtol=0, atol=1e-6)
