"""The reference's default pipeline, ``active``, in the port against the JAX
package on the CPU (80x160 frames, 32x64 mask, fd 64, lmk 48): the float
MatteNet and its blocks, the natural layout's ops, the plain versions of
the fused refine and of the plane-prior temporal refine against the
reference's Pallas bodies in interpret mode, and the Engine over 8 steps
on each of the four routes (as it stands, ``use_fused_composite=True``,
``prior_impl='plane'``, ``warp_impl='exact'``).

Tolerances, with their reasons:
* MatteNet and its blocks run in bf16, and PyTorch and XLA round the
  convolutions' and the SE's partial sums at other places, and XLA keeps
  the SE's gate in f32 where PyTorch rounds it to bf16 (one step of the
  gate is up to two of the product): a block's bf16 output within 4 bf16
  steps of its magnitude (:func:`_bf16_close`; the encoder's /8 and /16
  features, past its first SE blocks, of the tensor's largest magnitude;
  /2 and /4 are equal); the alpha within 2e-3 with seeded weights; with
  the trained weights the net sits on knife edges (the reference's own
  jitted and op-by-op forwards differ by up to 0.3 on these frames), so
  the port's alpha is held against the reference's op-by-op forward to
  twice the distance of the reference's jitted forward (mean and 99th
  percentile) and to its IoU less 0.02;
* the ops: f32 in the same order, held exact (the gathers, the warp, the
  prior) or within float32 rounding;
* the refine bodies: the same f32 stages, new_prev within 2e-5 and the
  refined alpha within 2e-5 (exp/pow ulps), as the ported body is held;
* the Engine, with seeded MatteNet weights (the trained face models, so
  that faces are found): face decisions equal, det_score within 1e-2, the
  affine state within 0.6 mask pixels in translation and 3e-2 in its
  linear part (a one-pixel flip of the ROI's integer box at these sizes
  moves the landmarks that far); teacher-forced (the JAX state and the JAX
  step's prior fed in), the alpha within 5e-3, new_prev within 1e-3 (the
  bf16 model alpha, through the EMA and the threshold/gamma stage), the
  frame within one u8 step (the composite's bf16 pass, as the TPU runs
  it, against the CPU reference's f32; exact-precision and kernel routes
  too).
"""

import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu import models, ops
from video_stream_segmenetation_tpu.kernels import refine_fused as JR
from video_stream_segmenetation_tpu.models import backbones as JB
from video_stream_segmenetation_tpu.runtime.pipeline import ModelBundle
from video_stream_segmenetation_tpu.runtime.presets import preset as jax_preset
from video_stream_segmenetation_tpu.service import Engine as JaxEngine
from video_stream_segmenetation_tpu.utils.checkpoint import restore_params
from video_stream_segmenetation_tpu.utils.clips import articulated_clip
from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.kernels import refine_fused as TR
from video_stream_segmenetation_tpu_torch.models import backbones as TB
from video_stream_segmenetation_tpu_torch.models.modnet import MatteNet, init_mattenet_params
from video_stream_segmenetation_tpu_torch.ops import composite as TC
from video_stream_segmenetation_tpu_torch.ops import prior as TP
from video_stream_segmenetation_tpu_torch.ops import resize as TRS
from video_stream_segmenetation_tpu_torch.ops import warp as TW
from video_stream_segmenetation_tpu_torch.runtime import pipeline as TPL
from video_stream_segmenetation_tpu_torch.runtime.config import PipelineStatics, default_knobs
from video_stream_segmenetation_tpu_torch.runtime.presets import preset
from video_stream_segmenetation_tpu_torch.runtime.state import StreamState
from video_stream_segmenetation_tpu_torch.service.engine import Engine

T = torch.tensor
GEOM = dict(frame_hw=(80, 160), mask_hw=(32, 64), fd_size=64, lmk_size=48)
ROOT = Path(__file__).resolve().parents[1]


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _bf16_close(got, want, steps=4, of_max=False):
    """Within ``steps`` bf16 steps (2**-8 relative) of the larger magnitude
    of the two, plus a bf16 step at 1 for values near 0; with ``of_max``,
    of the tensor's largest magnitude (deep features, where the bf16
    differences of earlier layers have mixed across channels)."""
    got, want = _np(got), _np(want)
    mag = np.abs(want).max() if of_max else np.maximum(np.abs(want), np.abs(got))
    tol = steps * 2.0 ** -8 * mag + 2.0 ** -8
    assert got.shape == want.shape
    bad = np.abs(got - want) > tol
    assert not bad.any(), f"{bad.sum()} of {bad.size}, max {np.abs(got - want).max()}"


# ---- MatteNet and its blocks ------------------------------------------------


@pytest.fixture(scope="module")
def trees():
    return {"seeded": init_mattenet_params(0),
            "trained": bridge.float_tree(jax.tree_util.tree_map(
                np.asarray, restore_params(str(ROOT / "checkpoints/mattenet"))))}


def _nchw(x):
    return T(x).to(torch.bfloat16).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


def _sub(tree, *path):
    p, st = tree["params"], tree["batch_stats"]
    for k in path:
        p, st = p[k], st.get(k, {})
    return p, st


def test_seeded_tree_has_the_flax_names_and_shapes(trees):
    flax_tree = models.MatteNet().init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 64, 3)))
    shapes = lambda t: jax.tree_util.tree_map(lambda a: np.shape(a), t)  # noqa: E731
    assert shapes(dict(flax_tree)) == shapes(trees["seeded"])
    assert shapes(trees["trained"]) == shapes(trees["seeded"])


def test_se_block_matches(trees, rng):
    p, _ = _sub(trees["trained"], "MobileEncoder_0", "InvertedResidual_4")
    x = rng.normal(0, 2, (2, 4, 8, 240)).astype(np.float32)
    want = JB.SEBlock().apply({"params": p["SEBlock_0"]}, jnp.asarray(x, jnp.bfloat16))
    got = TB.SEBlock(p["SEBlock_0"])(_nchw(x))
    _bf16_close(_nhwc(got), want)


@pytest.mark.parametrize("block,stride,expand,se", [
    ("InvertedResidual_0", 1, 1, False), ("InvertedResidual_1", 2, 6, False),
    ("InvertedResidual_2", 1, 6, False), ("InvertedResidual_4", 1, 6, True),
    ("InvertedResidual_5", 2, 6, True)])
def test_inverted_residual_matches(trees, rng, block, stride, expand, se):
    p, st = _sub(trees["trained"], "MobileEncoder_0", block)
    cin = p["ConvBN_0"]["Conv_0"]["kernel"].shape[-2 if expand != 1 else -1]
    c = p[f"ConvBN_{1 if expand == 1 else 2}"]["Conv_0"]["kernel"].shape[-1]
    x = rng.random((2, 8, 16, cin)).astype(np.float32)
    want = JB.InvertedResidual(c, strides=(stride, stride), expand=expand, use_se=se).apply(
        {"params": p, "batch_stats": st}, jnp.asarray(x, jnp.bfloat16))
    got = TB.InvertedResidual(p, st, stride=stride, expand=expand, use_se=se)(_nchw(x))
    _bf16_close(_nhwc(got), want)


def test_easpp_matches(trees, rng):
    p, st = _sub(trees["trained"], "EASPP_0")
    x = rng.random((2, 4, 8, 128)).astype(np.float32)
    want = JB.EASPP(96).apply({"params": p, "batch_stats": st}, jnp.asarray(x, jnp.bfloat16))
    got = TB.EASPP(p, st)(_nchw(x))
    _bf16_close(_nhwc(got), want)


def test_mobile_encoder_matches(trees, rng):
    p, st = _sub(trees["trained"], "MobileEncoder_0")
    x = rng.random((2, 32, 64, 3)).astype(np.float32)
    want = JB.MobileEncoder().apply({"params": p, "batch_stats": st},
                                    jnp.asarray(x, jnp.bfloat16))
    got = TB.MobileEncoder(p, st)(_nchw(x))
    for level, (g, w) in enumerate(zip(got, want)):
        if level < 2:  # before the first SE block
            np.testing.assert_array_equal(_np(_nhwc(g)), _np(w))
        else:
            _bf16_close(_nhwc(g), w, of_max=True)


def test_nearest_x2_matches(rng):
    x = rng.random((2, 3, 5, 4)).astype(np.float32)
    want = JB.nearest_x2(jnp.asarray(x), 2)
    np.testing.assert_array_equal(_nhwc(TB.nearest_x2(T(x).permute(0, 3, 1, 2), 2)).numpy(),
                                  np.asarray(want))


def _iou(a, b):
    return float((a & b).sum() / max((a | b).sum(), 1))


@pytest.mark.parametrize("which", ["seeded", "trained"])
def test_mattenet_matches(trees, which):
    """Rendered people at the mask grid, against the reference's op-by-op
    forward: the seeded net within 2e-3; the trained net no further than
    twice the reference's own jitted forward (mean and 99th percentile of
    the difference, plus a bf16 step at 1/2) and an IoU of alpha > 0.5 at
    most 0.02 below the jitted forward's."""
    f = np.concatenate([articulated_clip(n_frames=1, hw=(80, 160), seed=sd,
                                         features=True).frames for sd in (2, 1)])
    small = np.asarray(ops.resize_bilinear(jnp.asarray(f, jnp.float32) / 255.0, (32, 64),
                                           method="asymmetric"))
    jm = models.MatteNet()
    want = np.asarray(jm.apply(trees[which], jnp.asarray(small))["alpha"])
    got = MatteNet(trees[which])(T(small))["alpha"]
    assert got.dtype == torch.float32 and got.shape == (2, 32, 64)
    diff = np.abs(got.numpy() - want)
    if which == "seeded":
        assert diff.max() <= 2e-3
        return
    jit = np.asarray(jax.jit(lambda p, x: jm.apply(p, x)["alpha"])(trees[which],
                                                                   jnp.asarray(small)))
    jdiff = np.abs(jit - want)
    assert diff.mean() <= 2 * jdiff.mean() + 2.0 ** -9
    assert np.quantile(diff, 0.99) <= 2 * np.quantile(jdiff, 0.99) + 2.0 ** -9
    assert _iou(got.numpy() > 0.5, want > 0.5) >= _iou(jit > 0.5, want > 0.5) - 0.02


def test_mattenet_refuses_k_classes(trees):
    """A tree whose alpha head has K = 4 classes while its semantic and
    detail heads have one is refused (K-class trees, whose three heads
    agree, are served: tests/test_torch_multiclass_natural.py)."""
    tree = jax.tree_util.tree_map(lambda a: a, trees["seeded"])
    tree["params"]["Conv_2"] = {"kernel": np.zeros((1, 1, 16, 4), np.float32),
                                "bias": np.zeros(4, np.float32)}
    with pytest.raises(ValueError, match="must agree"):
        MatteNet(tree)


# ---- the natural layout's ops ----------------------------------------------


def test_resize_frames_u8_is_the_f32_resize(rng):
    """The /255 applied after the row gather: bit for bit the reference's
    resize of the f32 frames."""
    f = rng.integers(0, 256, (2, 80, 160, 3), dtype=np.uint8)
    for out_hw, method in (((32, 64), "asymmetric"), ((80, 64), "asymmetric"),
                           ((33, 50), "half_pixel")):
        want = ops.resize_bilinear(jnp.asarray(f, jnp.float32) / 255.0, out_hw, method=method)
        np.testing.assert_array_equal(TRS.resize_frames_u8(T(f), out_hw, method).numpy(),
                                      np.asarray(want))


def test_crop_and_resize_gather_matches(rng):
    img = rng.random((3, 20, 30, 3), dtype=np.float32)
    # inside, partly outside the frame, and degenerate boxes
    box = np.asarray([[3.0, 2.0, 17.5, 15.0], [-4.0, 10.0, 12.0, 26.0],
                      [25.0, 1.0, 25.0, 1.5]], np.float32)
    want = np.stack([np.asarray(ops.crop_and_resize(jnp.asarray(img[i]), jnp.asarray(box[i]),
                                                    (9, 11))) for i in range(3)])
    np.testing.assert_array_equal(TRS.crop_and_resize(T(img), T(box), (9, 11)).numpy(), want)


def test_gather_letterbox_matches(rng):
    from video_stream_segmenetation_tpu.runtime.pipeline import _letterbox_to_square

    fr = rng.random((2, 80, 160, 3), dtype=np.float32)
    want = _letterbox_to_square(jnp.asarray(fr), (80, 160), 64, impl="gather")
    np.testing.assert_array_equal(
        TPL.letterbox_to_square(T(fr), (80, 160), 64, "gather").numpy(), np.asarray(want))


def test_warp_affine_nearest_matches(rng):
    """Rotation, scale and shift, a near-singular affine, identity."""
    src = rng.random((4, 32, 64), dtype=np.float32)
    a = np.asarray([[0.995, -0.09, 3.0, 0.09, 0.995, -2.0],
                    [1.02, 0.05, -1.5, -0.05, 1.02, 1.0],
                    [0.0, 0.0, 4.0, 0.0, 0.0, 2.0],
                    [1.0, 0.0, 0.0, 0.0, 1.0, 0.0]], np.float32)
    want = ops.warp_affine_nearest(jnp.asarray(src), jnp.asarray(a))
    np.testing.assert_array_equal(TW.warp_affine_nearest(T(src), T(a)).numpy(),
                                  np.asarray(want))


def test_face_prior_mask_matches(rng):
    """Within two float32 steps at 1 (XLA fuses the cosine ramp and may
    round it an ulp apart); the same plane as the analytic form's."""
    box = np.concatenate([rng.random((6, 2)) * 100, 100 + rng.random((6, 2)) * 60], 1)
    box = box.astype(np.float32)
    for video_hw, mask_hw in (((720, 1280), (288, 512)), ((80, 160), (32, 64))):
        got = TP.face_prior_mask(T(box), video_hw, mask_hw)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(ops.face_prior_mask(jnp.asarray(box), video_hw, mask_hw)),
            rtol=0, atol=2.0 ** -22)
        np.testing.assert_array_equal(got.numpy(), TP.prior_plane_from_params(
            TP.face_prior_params(T(box), video_hw, mask_hw), mask_hw).numpy())


def _composite_case(rng):
    frames = rng.integers(0, 256, (2, 80, 160, 3), dtype=np.uint8)
    bg = rng.integers(0, 256, (2, 80, 160, 3), dtype=np.uint8)
    alpha = rng.random((2, 32, 64), dtype=np.float32)
    alpha[0, :4] = 0.0
    alpha[1, -4:] = 1.0
    return frames, alpha, bg


def _reference_composite(frames, alpha, bg):
    """The reference step's plain route on the CPU (its DEFAULT precision
    is f32 there)."""
    a_up = jnp.clip(ops.resize_bilinear_mxu(jnp.asarray(alpha), (80, 160), method="half_pixel",
                                            channel_last=False), 0.0, 1.0)
    return np.asarray(ops.alpha_composite(jnp.asarray(frames, jnp.float32) / 255.0, a_up,
                                          background=jnp.asarray(bg, jnp.float32) / 255.0,
                                          out_u8=True)).astype(np.int32)


def test_alpha_composite_matches(rng):
    """upsample_precision='exact' (f32) is within one u8 step of the CPU
    reference on under 0.1 % of values (f32 sums in another order); 'fast'
    (the TPU's bf16 pass) rounds the alpha, the interpolation weights and
    the row values to bf16, which moves the upsampled alpha by up to about
    3 * 2**-9: 1.5 u8 steps where frame and background are 255 apart, as
    in these random images.  So within two steps, and one at 99.9 % of
    values (the engine tests hold the served frames to one step)."""
    frames, alpha, bg = _composite_case(rng)
    want = _reference_composite(frames, alpha, bg)
    exact = TC.natural_composite(T(frames), T(alpha), T(bg), bf16_pass=False).numpy()
    fast = TC.natural_composite(T(frames), T(alpha), T(bg)).numpy()
    assert exact.dtype == np.uint8 and exact.shape == (2, 80, 160, 3)
    diff = np.abs(exact.astype(np.int32) - want)
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    diff = np.abs(fast.astype(np.int32) - want)
    assert diff.max() <= 2 and (diff > 1).mean() < 1e-3 and (diff > 0).mean() < 0.1
    u = rng.random((2, 5, 7, 3), dtype=np.float32) * 1.2 - 0.1
    np.testing.assert_array_equal(TC.denormalize_to_u8(T(u)).numpy(),
                                  np.asarray(ops.denormalize_to_u8(jnp.asarray(u))))


# ---- the refine bodies against the reference's Pallas kernels ---------------


def _refine_case(rng, s=4, h=32, w=64):
    alpha = rng.random((s, h, w), dtype=np.float32)
    prev = rng.random((s, h, w), dtype=np.float32)
    guide = rng.integers(0, 256, (s, 3, h, w), dtype=np.uint8)
    box = np.asarray([[40.0, 15.0, 100.0, 70.0]] * s, np.float32)
    prior = np.asarray(ops.face_prior_mask(jnp.asarray(box), (80, 160), (h, w)))
    has_prior = np.asarray([True, False, True, True])[:s]
    prior = np.where(has_prior[:, None, None], prior, 0.0).astype(np.float32)
    knobs = default_knobs(s, ema_adapt=1.0)
    knobs.use_bilateral = T(np.asarray([True, True, False, True])[:s])
    knobs.gamma = T(np.asarray([0.4, 0.7, 0.4, 1.0], np.float32)[:s])
    return alpha, prev, guide, prior, has_prior, knobs


def _jknobs(knobs):
    return [jnp.asarray(getattr(knobs, n).numpy()) for n in
            ("noise_cutoff", "high_threshold", "gamma", "use_bilateral", "sigma_spatial",
             "sigma_range")]


def test_fused_refine_plain_matches_pallas(rng):
    """fused_refine (stages 5/7/8/9, the prior plane, f32 out): the plain
    version against _refine_kernel in interpret mode; the reference takes
    the guide HWC in 0..255."""
    alpha, _, guide, prior, has_prior, knobs = _refine_case(rng)
    want = JR.fused_refine(jnp.asarray(alpha), jnp.asarray(guide.transpose(0, 2, 3, 1),
                                                            jnp.float32),
                           jnp.asarray(prior), *_jknobs(knobs), jnp.asarray(has_prior),
                           interpret=True)
    got = TR.fused_refine(T(alpha), T(guide), T(prior), T(has_prior), knobs)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)
    assert 0.05 < float(np.asarray(want).mean()) < 0.95


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_plane_prior_temporal_refine_matches_pallas(rng, out_dtype):
    """The plane-prior body (_temporal_refine_kernel) in interpret mode
    against the port's plain version with the same plane, warp and EMA
    inputs; new_prev within 2e-5, the refined alpha within 2e-5 (f32) or
    4e-3 (bf16)."""
    alpha, prev, guide, prior, has_prior, knobs = _refine_case(rng)
    s = alpha.shape[0]
    affine = np.asarray([[1.05, 0, 2.5, 0, 0.97, -1.5], [1, 0, 0, 0, 1, 0],
                         [1.0, 0, 30.0, 0, 1.0, 12.0], [0.9, 0, -1.0, 0, 1.1, 3.0]],
                        np.float32)[:s]
    init = np.asarray([True, True, False, True])[:s]
    use_warp = np.asarray([True, False, True, True])[:s] & init
    jk = _jknobs(knobs)
    want_prev, want = JR.fused_temporal_refine(
        jnp.asarray(alpha), jnp.asarray(prev), jnp.asarray(affine), jnp.asarray(use_warp),
        jnp.asarray(init), 0.3, jnp.asarray(guide), jnp.asarray(prior),
        jnp.asarray(knobs.ema.numpy()), *jk, jnp.asarray(has_prior),
        knobs_ema_adapt=jnp.asarray(knobs.ema_adapt.numpy()), interpret=True,
        guide_planar=True, out_dtype=jnp.bfloat16 if out_dtype == torch.bfloat16 else None)
    got_prev, got = TR.fused_temporal_refine_plane(
        T(alpha), T(prev), T(affine), T(use_warp), T(init), 0.3, T(guide), T(prior),
        T(has_prior), knobs, out_dtype=out_dtype)
    assert got.dtype == out_dtype
    np.testing.assert_allclose(got_prev.numpy(), np.asarray(want_prev), rtol=0, atol=2e-5)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=0,
                               atol=2e-5 if out_dtype == torch.float32 else 4e-3)


def test_plane_prior_equals_analytic_prior(rng):
    """The plane rendered from the same scalars gives the analytic form's
    result exactly (both plain versions)."""
    alpha, prev, guide, _, has_prior, knobs = _refine_case(rng)
    s = alpha.shape[0]
    pp = T(np.asarray([[30.0, 18.0, 14.0, 12.0]] * s, np.float32))
    plane = TP.prior_plane_from_params(pp, (32, 64))
    aff = T(np.tile(np.asarray([[1.0, 0, 2.0, 0, 1.0, -1.0]], np.float32), (s, 1)))
    args = (T(alpha), T(prev), aff, T(has_prior), T(has_prior), 0.3, T(guide))
    a = TR.fused_temporal_refine(*args, pp, T(has_prior), knobs, out_dtype=torch.float32)
    b = TR.fused_temporal_refine_plane(*args, plane, T(has_prior), knobs,
                                       out_dtype=torch.float32)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


# ---- the Engine on the four routes -----------------------------------------

ENGINE_T = 8
ROUTES = {
    "active": {},
    "fused_composite": {"use_fused_composite": True},
    "plane": {"prior_impl": "plane"},
    "exact_warp": {"warp_impl": "exact"},
}
# a rotation and a scale with shifts: the warp has work from the first step
AFFINE0 = np.asarray([[0.995, -0.09, 3.0, 0.09, 0.995, -2.0],
                      [1.02, 0.05, -1.5, -0.05, 1.02, 1.0]], np.float32)


@pytest.fixture(scope="module")
def engine_frames():
    """Rendered people, stream 0 from one clip and stream 1 from another,
    ENGINE_T frames each (rendered once for the four routes)."""
    clips = [articulated_clip(n_frames=ENGINE_T, hw=(80, 160), seed=sd, features=True).frames
             for sd in (2, 1)]
    return [np.stack([clips[s][t] for s in range(2)]) for t in range(ENGINE_T)]


def _host_state(e):
    return {k: np.asarray(getattr(e.state, k)).copy() for k in
            ("prev_alpha", "affine", "has_affine", "initialized", "frame_idx")}


def _drive(e, frames, bgs, before_step=None):
    """Backgrounds, the AFFINE0 state, then 8 steps; at step 3 stream 0 is
    evicted and re-admitted, so its cadence restarts (K=1 face stream a
    round: stream 0 at steps 0 and 3, stream 1 at step 6)."""
    e.face_min_interval_s = 0.0
    e.admit_all()
    for s in range(2):
        e.set_background(s, bgs[s])
    if isinstance(e, Engine):
        e.state.affine[:] = T(AFFINE0)
        e.state.has_affine[:] = True
    else:
        e.state = dataclasses.replace(e.state, affine=jnp.asarray(AFFINE0),
                                      has_affine=jnp.ones((2,), bool))
    outs = []
    for t, f in enumerate(frames):
        if t == 3:
            e.evict(0)
            e.admit()
        if before_step is not None:
            before_step(t)
        state_in = _host_state(e)
        last = np.array(e._last_face_at)
        out = e.process(f)
        out["applied"] = np.array(e._last_face_at) != last
        out["state_in"], out["state"] = state_in, _host_state(e)
        outs.append(out)
    return outs


@pytest.fixture(scope="module")
def face_trees():
    return {n: bridge.float_tree(jax.tree_util.tree_map(
        np.asarray, restore_params(str(ROOT / f"checkpoints/{n}"))))
        for n in ("facefinder", "landmarknet")}


@pytest.fixture(scope="module", params=sorted(ROUTES))
def engines(request, face_trees, engine_frames):
    """The JAX Engine (its refine and composite kernels in interpret mode,
    the plane prior exported by debug_face_outputs) and the port's, seeded
    MatteNet weights, the trained face models; plus a teacher-forced port
    run that starts each step from the JAX state and takes the JAX step's
    prior."""
    route = request.param
    over = ROUTES[route]
    tree = init_mattenet_params(0)
    jst = jax_preset("active", use_fused_refine=True, debug_face_outputs=True, **over, **GEOM)
    bundle = ModelBundle(models.MatteNet(), jax.tree_util.tree_map(jnp.asarray, tree),
                         models.FaceFinder(input_size=GEOM["fd_size"]), face_trees["facefinder"],
                         models.LandmarkNet(), face_trees["landmarknet"])
    je = JaxEngine(num_streams=2, statics=jst, bundle=bundle, donate_state=False)
    frames = engine_frames
    rng = np.random.default_rng(3)
    bgs = [rng.integers(0, 256, (80, 160, 3), dtype=np.uint8) for _ in range(2)]
    jouts = _drive(je, frames, bgs)
    kw = dict(params=tree, face_params={"face": face_trees["facefinder"],
                                        "lmk": face_trees["landmarknet"]}, device="cpu")
    st = preset("active", **over, **GEOM)
    touts = _drive(Engine(2, st, **kw), frames, bgs)

    tf = Engine(2, st, **kw)
    real = TPL.face_subpath_compact
    step_t = {}

    def forced_face(*args, **kwargs):
        _, _, aff, has_upd, score = real(*args, **kwargs)
        j = jouts[step_t["t"]]
        key = "face_prior_plane" if "face_prior_plane" in j else "face_prior_params"
        return (T(np.asarray(j[key])), T(np.asarray(j["face_has_prior"])), aff, has_upd,
                score)

    def set_state(t):
        step_t["t"] = t
        tf.state = StreamState(**{k: T(v) for k, v in jouts[t]["state_in"].items()},
                               rec=tf.state.rec)

    TPL.face_subpath_compact = forced_face
    try:
        forced = _drive(tf, frames, bgs, before_step=set_state)
    finally:
        TPL.face_subpath_compact = real
    return route, jouts, touts, forced


def test_engine_face_decisions_match(engines):
    """face_applied and the prior's presence equal at every step, det_score
    within 1e-2, the affine state within 0.6 mask pixels in translation and
    3e-2 in its linear part; the face rounds go where the cadence sends
    them."""
    route, jouts, touts, _ = engines
    for t, (j, g) in enumerate(zip(jouts, touts)):
        np.testing.assert_array_equal(g["applied"], j["applied"], err_msg=f"step {t}")
        np.testing.assert_array_equal(g["face_applied"].numpy(), j["applied"])
        np.testing.assert_allclose(g["det_score"].numpy(), np.asarray(j["det_score"]),
                                   rtol=0, atol=1e-2)
        ja, ga = j["state"]["affine"], g["state"]["affine"]
        np.testing.assert_allclose(ga[:, [2, 5]], ja[:, [2, 5]], rtol=0, atol=0.6)
        np.testing.assert_allclose(ga[:, [0, 1, 3, 4]], ja[:, [0, 1, 3, 4]], rtol=0,
                                   atol=3e-2)
        np.testing.assert_array_equal(g["state"]["frame_idx"], j["state"]["frame_idx"])
    has_prior = np.stack([np.asarray(j["face_has_prior"]) for j in jouts])
    assert has_prior[[0, 3], 0].all() and has_prior[6, 1] and has_prior.sum() == 3
    assert np.stack([j["applied"] for j in jouts]).any()
    # the prior's scalars ride the outputs where the prior is scalars, as
    # in the reference
    assert ("face_prior_params" in touts[0]) == (route in ("active", "fused_composite"))
    for j, g in zip(jouts, touts):
        np.testing.assert_array_equal(g["face_has_prior"].numpy(),
                                      np.asarray(j["face_has_prior"]))


@pytest.mark.parametrize("step", range(ENGINE_T))
def test_engine_step_matches(engines, step):
    """Teacher-forced: the alpha within 5e-3 (f32 on every route), new_prev
    within 1e-3, the frame within one u8 step."""
    route, jouts, _, forced = engines
    j, g = jouts[step], forced[step]
    assert g["alpha"].dtype == torch.float32 and g["frame"].dtype == torch.uint8
    np.testing.assert_allclose(g["alpha"].numpy(), np.asarray(j["alpha"], np.float32),
                               rtol=0, atol=5e-3)
    np.testing.assert_allclose(g["state"]["prev_alpha"], j["state"]["prev_alpha"],
                               rtol=0, atol=1e-3)
    diff = np.abs(g["frame"].numpy().astype(np.int32) - np.asarray(j["frame"]).astype(np.int32))
    assert diff.max() <= 1


# ---- what the Engine serves, and what it refuses ------------------------------


def test_engine_defaults_to_the_reference_statics():
    """Engine(n) with no statics serves PipelineStatics(), which is the
    active preset; on the card by default, so it raises without one."""
    assert preset("active") == PipelineStatics()
    e = Engine(1, device="cpu")
    assert e.statics == PipelineStatics() and not e.packed
    assert isinstance(e.model, MatteNet)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            Engine(1)


@pytest.mark.parametrize("override", [
    {"refined_dtype": "f16"}, {"upsample_impl": "conv"}, {"affine_mode": "reference"},
    {"face_compact": False}, {"resize_impl": "bicubic"}, {"crop_impl": "mxu"},
    {"face_input": "guide"}, {"upsample_method": "asymmetric"},
    {"upsample_precision": "highest"}, {"guide_impl": "bicubic"}])
def test_active_refuses_unserved_options(override):
    """What active's step still does not serve is refused by name (the
    blend, temporal-filter, morphology and unfused-refine options are
    served since the stage chain was ported: tests/test_torch_variants.py;
    refined_dtype='bf16', upsample_impl='gather', resize_impl='mxu' and
    guide_impl='nearest_u8' since they were: tests/test_torch_active_
    options.py; a value the reference does not have stays refused)."""
    with pytest.raises(NotImplementedError, match=next(iter(override))):
        Engine(1, preset("active", **override, **GEOM), device="cpu")


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
    return names


def test_port_imports_no_jax():
    """Every module of the port and chip_smoke.py, parsed: no import of jax
    (or flax, orbax) and none of the JAX package."""
    files = sorted((ROOT / "video_stream_segmenetation_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    banned = ("jax", "jaxlib", "flax", "orbax", "video_stream_segmenetation_tpu")
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in banned, f"{path.relative_to(ROOT)} imports {name}"
