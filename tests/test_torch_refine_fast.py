"""The fast form of the port's fused temporal refine (the plain version of
the CUDA kernel's LOWRES/LANES forms) against the JAX Pallas kernel's
``_temporal_refine_kernel_fast`` (``fused_temporal_refine`` with
``alpha_lowres_hw`` and/or ``guide_lanes_geom``), run in interpret mode,
on the cases of tests/test_torch_refine.py; the port's own forms against
each other; the lane and tap preparation.

Tolerances (tests/test_temporal_refine_kernel.py): new_prev and the f32
refined alpha within 2e-5, the bf16 refined alpha within 4e-3 (the gamma
curve is pow() here and exp(g*log t) in the reference).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stream_segmenetation_tpu import ops as jops
from video_stream_segmenetation_tpu import runtime
from video_stream_segmenetation_tpu.kernels.refine_fused import fused_temporal_refine as jax_refine
from video_stream_segmenetation_tpu_torch.kernels import refine_fused as TR
from video_stream_segmenetation_tpu_torch.ops import layout as TL
from video_stream_segmenetation_tpu_torch.ops.resize import _interp_matrix, resize_bilinear_mxu
from video_stream_segmenetation_tpu_torch.runtime import config as TC

S, H, W = 4, 32, 64
FY = FX = 4
H0, W0 = H // FY, W // FX

# (affines, use_warp, initialized, has_prior, use_bilateral), as in
# tests/test_torch_refine.py
CASES = {
    "warp_prior_mixed": (
        [[1.02, 0.0, 1.5, 0.0, 0.98, -1.0], [1.0, 0, 0, 0, 1.0, 0],
         [1.1, 0.0, -3.2, 0.0, 0.9, 2.6], [0.95, 0.0, 4.0, 0.0, 1.05, -2.0]],
        [True, False, True, True], [True, True, True, True],
        [True, False, True, False], [True, True, False, True],
    ),
    "out_of_range": (
        [[1.0, 0.0, 40.0, 0.0, 1.0, -20.0], [1.0, 0.0, -70.0, 0.0, 1.0, 0.0],
         [2.0, 0.0, 0.0, 0.0, 2.0, 0.0], [1.0, 0.0, 0.0, 0.0, 1.0, 40.0]],
        [True, True, True, True], [True, True, True, True],
        [False, True, False, True], [True, True, True, True],
    ),
    "cold_start": (
        [[1.05, 0.0, 2.0, 0.0, 1.05, 1.0]] * 4,
        [False, False, False, False], [False, False, True, False],
        [True, True, False, False], [True, False, True, True],
    ),
}
FORMS = {"lowres": (True, False), "lanes": (False, True), "lowres+lanes": (True, True)}
PRIOR = np.asarray([[30.0, 14.0, 12.0, 10.0], [10.0, 20.0, 8.0, 6.0],
                    [50.0, 5.0, 20.0, 9.0], [32.0, 16.0, 1e-6, 7.0]], np.float32)
EMA_ADAPT = np.asarray([1.0, 0.0, 0.5, 1.0], np.float32)


def to_lanes(guide_planar: np.ndarray) -> np.ndarray:
    """``[S, 3, H, W]`` -> lanes ``[3*FY*FX, S, H/FY, W/FX]``, lane
    (c*FY + yy)*FX + xx at (i, j) = pixel (c, FY*i + yy, FX*j + xx)."""
    s = guide_planar.shape[0]
    return np.ascontiguousarray(
        guide_planar.reshape(s, 3, H0, FY, W0, FX).transpose(1, 3, 5, 0, 2, 4)
        .reshape(3 * FY * FX, s, H0, W0))


def inputs(rng, case):
    affine, use_warp, init, has_prior, use_bi = (np.asarray(v) for v in CASES[case])
    return dict(
        affine=affine.astype(np.float32), use_warp=use_warp & init, init=init,
        has_prior=has_prior, use_bi=use_bi,
        logits=((rng.random((S, H0, W0), dtype=np.float32) - 0.5) * 8.0),
        alpha=rng.random((S, H, W), dtype=np.float32),
        prev=rng.random((S, H, W), dtype=np.float32),
        guide=rng.integers(0, 256, (S, 3, H, W), dtype=np.uint8))


def port_knobs(d):
    tk = TC.default_knobs(S)
    tk.use_bilateral = torch.as_tensor(d["use_bi"])
    tk.ema_adapt = torch.as_tensor(EMA_ADAPT)
    return tk


def run_port(d, lowres, lanes, out_dtype):
    return TR.fused_temporal_refine_fast(
        torch.as_tensor(d["logits"] if lowres else d["alpha"]), torch.as_tensor(d["prev"]),
        torch.as_tensor(d["affine"]), torch.as_tensor(d["use_warp"]),
        torch.as_tensor(d["init"]), 0.3,
        torch.as_tensor(to_lanes(d["guide"]) if lanes else d["guide"]), torch.as_tensor(PRIOR),
        torch.as_tensor(d["has_prior"]), port_knobs(d), out_dtype=out_dtype,
        alpha_lowres_hw=(H, W) if lowres else None, guide_lanes_geom=(FY, FX) if lanes else None)


@pytest.mark.parametrize("out", ["bf16", "f32"])
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_fast_matches_pallas_fast(rng, case, form, out):
    lowres, lanes = FORMS[form]
    d = inputs(rng, case)
    k = runtime.default_knobs(S)
    want_prev, want = jax_refine(
        jnp.asarray(d["logits"] if lowres else d["alpha"]), jnp.asarray(d["prev"]),
        jnp.asarray(d["affine"]), jnp.asarray(d["use_warp"]), jnp.asarray(d["init"]), 0.3,
        jnp.asarray(to_lanes(d["guide"]) if lanes else d["guide"]), None, k.ema,
        k.noise_cutoff, k.high_threshold, k.gamma, jnp.asarray(d["use_bi"]), k.sigma_spatial,
        k.sigma_range, jnp.asarray(d["has_prior"]), knobs_ema_adapt=jnp.asarray(EMA_ADAPT),
        interpret=True, guide_planar=not lanes, prior_params=jnp.asarray(PRIOR),
        alpha_lowres_hw=(H, W) if lowres else None,
        guide_lanes_geom=(FY, FX) if lanes else None,
        out_dtype=jnp.bfloat16 if out == "bf16" else None)
    dt = torch.bfloat16 if out == "bf16" else torch.float32
    got_prev, got = run_port(d, lowres, lanes, dt)
    assert got.dtype == dt and got_prev.dtype == torch.float32
    assert got.shape == got_prev.shape == (S, H, W)
    np.testing.assert_allclose(got_prev.numpy(), np.asarray(want_prev), rtol=0, atol=2e-5)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=0,
                               atol=4e-3 if out == "bf16" else 2e-5)
    assert 0.05 < got.float().mean().item() < 0.95


@pytest.mark.parametrize("case", sorted(CASES))
def test_lanes_form_equals_planar_form(rng, case):
    """The lanes carry the planar guide's bytes: the same result bit for
    bit."""
    d = inputs(rng, case)
    got_prev, got = run_port(d, False, True, torch.bfloat16)
    want_prev, want = TR.fused_temporal_refine(
        torch.as_tensor(d["alpha"]), torch.as_tensor(d["prev"]), torch.as_tensor(d["affine"]),
        torch.as_tensor(d["use_warp"]), torch.as_tensor(d["init"]), 0.3,
        torch.as_tensor(d["guide"]), torch.as_tensor(PRIOR), torch.as_tensor(d["has_prior"]),
        port_knobs(d))
    assert torch.equal(got_prev, want_prev) and torch.equal(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lowres_form_equals_full_form(rng, case):
    """Head-grid logits through the fast form equal the model's own
    upsample and sigmoid (models/quantized.py) through the analytic form,
    bit for bit, in the plain versions."""
    d = inputs(rng, case)
    got_prev, got = run_port(d, True, True, torch.float32)
    alpha = torch.sigmoid(resize_bilinear_mxu(torch.as_tensor(d["logits"]), (H, W),
                                              "half_pixel", channel_last=False))
    want_prev, want = TR.fused_temporal_refine(
        alpha, torch.as_tensor(d["prev"]), torch.as_tensor(d["affine"]),
        torch.as_tensor(d["use_warp"]), torch.as_tensor(d["init"]), 0.3,
        torch.as_tensor(d["guide"]), torch.as_tensor(PRIOR), torch.as_tensor(d["has_prior"]),
        port_knobs(d), out_dtype=torch.float32)
    assert torch.equal(got_prev, want_prev) and torch.equal(got, want)


@pytest.mark.parametrize("hw, hw0", [((32, 64), (8, 16)), ((288, 512), (72, 128)),
                                     ((30, 50), (7, 13))])
def test_lowres_taps_rebuild_the_interpolation_matrices(hw, hw0):
    """The kernel's two taps a row and column give back the half-pixel
    interpolation matrices exactly, edge clamps included."""
    taps, wts = (t.numpy() for t in TR.lowres_taps(hw, hw0, "cpu"))
    assert taps.shape == wts.shape == (hw[0] + hw[1], 2) and taps.dtype == np.int32
    for n, (out_size, in_size) in enumerate(zip(hw, hw0)):
        rows = slice(0, hw[0]) if n == 0 else slice(hw[0], None)
        m = np.zeros((out_size, in_size), np.float32)
        r = np.arange(out_size)
        np.add.at(m, (r, taps[rows, 0]), wts[rows, 0])
        np.add.at(m, (r, taps[rows, 1]), wts[rows, 1])
        np.testing.assert_array_equal(m, _interp_matrix(out_size, in_size, "half_pixel"))
        assert (taps[rows, 0] <= taps[rows, 1]).all()


@pytest.mark.parametrize("frame_hw, mask_hw", [((80, 160), (32, 64)), ((720, 1280), (288, 512))])
def test_guide_lanes_match_reference(rng, frame_hw, mask_hw):
    """guide_lanes_s2d: the same lanes and geometry as the reference's
    one-hot product; lanes_to_planar gives guide_from_s2d's planar guide."""
    frames = rng.integers(0, 256, (2, *frame_hw, 3), dtype=np.uint8)
    packed_j = jops.space_to_depth(jnp.asarray(frames), 10)
    want, want_geom = jops.guide_lanes_s2d(packed_j, frame_hw, mask_hw, 10)
    packed = TL.space_to_depth(torch.as_tensor(frames), 10)
    got, geom = TL.guide_lanes_s2d(packed, frame_hw, mask_hw, 10)
    assert geom == tuple(want_geom) == (4, 4)
    assert got.dtype == torch.uint8 and got.shape == (48, 2, frame_hw[0] // 10,
                                                      frame_hw[1] // 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    planar = TL.lanes_to_planar(got, geom)
    assert torch.equal(planar, TL.guide_from_s2d(packed, frame_hw, mask_hw, 10))


def test_guide_lanes_refuse_a_mask_off_the_stem_grid():
    """A mask that is no multiple of the stem grid has no lanes: both
    packages refuse it."""
    with pytest.raises(ValueError):
        TL.guide_lanes_s2d(torch.zeros((1, 8, 16, 300), dtype=torch.uint8), (80, 160),
                           (20, 40), 10)
    with pytest.raises(ValueError):
        jops.guide_lanes_s2d(jnp.zeros((1, 8, 16, 300), jnp.uint8), (80, 160), (20, 40), 10)


@pytest.mark.parametrize("bad", ["alpha_shape", "lanes_shape", "hw", "neither", "plane"])
def test_fast_launch_refuses_bad_inputs(rng, bad):
    """The wrapper checks shapes, types and the options before it looks
    for the kernel library."""
    d = inputs(rng, "warp_prior_mixed")
    h, w = d["prev"].shape[-2:]
    yi = torch.zeros((S, h), dtype=torch.int32)
    xi = torch.zeros((S, w), dtype=torch.int32)
    table = torch.zeros((S, len(TR.KNOB_COLUMNS)))
    logits = torch.as_tensor(d["logits"])
    lanes = torch.as_tensor(to_lanes(d["guide"]))
    hw, geom, plane = (H, W), (FY, FX), None
    if bad == "alpha_shape":
        logits = logits[:, :, :-1]
    elif bad == "lanes_shape":
        lanes = lanes[:47]
    elif bad == "hw":
        hw = (H, W + 4)
    elif bad == "plane":
        plane = torch.zeros((S, H, W))
    else:
        hw = geom = None
    with pytest.raises(ValueError):
        TR._launch(logits, torch.as_tensor(d["prev"]), yi, xi, lanes, table,
                   torch.bfloat16, plane, hw, geom)


def test_jax_on_cpu():
    assert jax.default_backend() == "cpu"
