"""The torch port's CUDA kernels against their plain PyTorch versions, on
the card.  Marked ``gpu``: without a card each test skips.  The machine
with the card has no JAX, so this file imports none; run it there with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py -q

On the CPU the wrappers take the plain versions (checked here too, without
a card: a CPU tensor never counts a launch).
"""

import numpy as np
import pytest
import torch

from video_stream_segmenetation_tpu_torch.kernels import refine_fused as TR
from video_stream_segmenetation_tpu_torch.kernels import trunk_int8 as TK
from video_stream_segmenetation_tpu_torch.models import quantized as Q
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import init_pico_params
from video_stream_segmenetation_tpu_torch.models.quantized import (
    quantize_mattenet_hd,
    trunk_params,
)
from video_stream_segmenetation_tpu_torch.runtime.config import default_knobs
from video_stream_segmenetation_tpu_torch.runtime.presets import preset
from video_stream_segmenetation_tpu_torch.service.engine import Engine


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _refine_inputs(device, s=4, h=40, w=72, seed=0):
    g = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    alpha = t(g.random((s, h, w), dtype=np.float32))
    prev = t(g.random((s, h, w), dtype=np.float32))
    guide = t(g.integers(0, 256, (s, 3, h, w), dtype=np.uint8))
    affine = t(np.asarray([[1.05, 0, 2.5, 0, 0.97, -1.5], [1, 0, 0, 0, 1, 0],
                           [1.0, 0, 30.0, 0, 1.0, 12.0], [0.9, 0, -1.0, 0, 1.1, 3.0]],
                          np.float32)[:s])
    init = t(np.asarray([True, True, False, True])[:s])
    use_warp = t(np.asarray([True, False, True, True])[:s]) & init
    has_prior = t(np.asarray([True, False, True, False])[:s])
    pp = t(np.asarray([[30.0, 18.0, 14.0, 12.0]] * s, np.float32))
    knobs = default_knobs(s, ema_adapt=1.0, device=device)
    knobs.use_bilateral = t(np.asarray([True, True, False, True])[:s])
    return alpha, prev, affine, use_warp, init, guide, pp, has_prior, knobs


def _trunk_inputs(device, s=2, h=16, w=32, seed=0):
    tp = trunk_params(quantize_mattenet_hd(init_pico_params(seed, 10), 10), device)
    g = np.random.default_rng(seed)
    x0 = torch.as_tensor(g.integers(0, 128, (s, h, w, 128), dtype=np.int8), device=device)
    return x0, tp


def test_cpu_tensors_take_plain_versions_and_count_no_launch():
    n_t, n_r = TK.fused_nano_trunk_alpha.launches, TR.fused_temporal_refine.launches
    x0, tp = _trunk_inputs("cpu", h=8, w=16)
    np.testing.assert_array_equal(TK.fused_nano_trunk_alpha(x0, tp).numpy(),
                                  Q.xla_trunk_alpha(x0, tp).numpy())
    args = _refine_inputs("cpu")
    TR.fused_temporal_refine(*args[:5], 0.3, *args[5:])
    assert TK.fused_nano_trunk_alpha.launches == n_t
    assert TR.fused_temporal_refine.launches == n_r


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(16, 32), (72, 128)])
def test_trunk_kernel_matches_plain(card, hw):
    x0, tp = _trunk_inputs(card, h=hw[0], w=hw[1])
    n = TK.fused_nano_trunk_alpha.launches
    got = TK.fused_nano_trunk_alpha(x0, tp)
    want = Q.xla_trunk_alpha(x0, tp)
    torch.cuda.synchronize()
    assert TK.fused_nano_trunk_alpha.launches == n + 1
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.gpu
def test_refine_kernel_matches_plain(card):
    from video_stream_segmenetation_tpu_torch.ops.warp import separable_warp_indices

    alpha, prev, affine, use_warp, init, guide, pp, has_prior, knobs = _refine_inputs(card)
    n = TR.fused_temporal_refine.launches
    got_prev, got = TR.fused_temporal_refine(alpha, prev, affine, use_warp, init, 0.3,
                                             guide, pp, has_prior, knobs)
    yi, xi = separable_warp_indices(affine, alpha.shape[-2:])
    table = TR.scalar_table(knobs, use_warp, init, 0.3, pp, has_prior)
    want_prev, want = TR.fused_temporal_refine_plain(alpha, prev, yi, xi, guide, table)
    torch.cuda.synchronize()
    assert TR.fused_temporal_refine.launches == n + 1
    assert (got_prev - want_prev).abs().max().item() <= 2e-5
    assert (got.float() - want.float()).abs().max().item() <= 4e-3


@pytest.mark.gpu
def test_engine_on_card_runs_both_kernels(card):
    eng = Engine(2, preset("fast_int8_pico", face_path=False, frame_hw=(160, 320),
                           mask_hw=(64, 128)), seed=0)
    eng.admit_all()
    frames = np.random.default_rng(0).integers(0, 256, (2, 160, 320, 3), dtype=np.uint8)
    n_t, n_r = TK.fused_nano_trunk_alpha.launches, TR.fused_temporal_refine.launches
    for _ in range(2):
        out = eng.process(frames)
    assert TK.fused_nano_trunk_alpha.launches == n_t + 2
    assert TR.fused_temporal_refine.launches == n_r + 2
    assert out["frame"].shape == (2, 160, 320, 3) and out["frame"].is_cuda
    assert bool(torch.isfinite(out["alpha"].float()).all())


def _micro_tp(device):
    from video_stream_segmenetation_tpu_torch.models.mattenet_hd import init_params

    return trunk_params(quantize_mattenet_hd(init_params("micro", 0, 10), 10, "micro"), device)


@pytest.mark.gpu
@pytest.mark.parametrize("level,grid,ca,cb", [("u2", (18, 32), 256, 192),
                                              ("u1", (36, 64), 192, 128),
                                              ("u1", (3, 5), 192, 128)])
def test_decoder_kernel_matches_plain(card, level, grid, ca, cb):
    """Bit-exact s8 at micro's two levels (720p grids, and a ragged one)."""
    from video_stream_segmenetation_tpu_torch.kernels import decoder_int8 as DK

    tp = _micro_tp(card)
    g = np.random.default_rng(1)
    small = torch.as_tensor(g.integers(0, 128, (2, *grid, ca), dtype=np.int8), device=card)
    skip = torch.as_tensor(g.integers(0, 128, (2, 2 * grid[0], 2 * grid[1], cb),
                                      dtype=np.int8), device=card)
    up, sk = tp[f"{level}red_up"], tp[f"{level}red_skip"]
    n = DK.fused_decoder_level.launches
    got = DK.fused_decoder_level(small, skip, up, sk)
    want = Q.split_conv_up(small, skip, up, sk)
    torch.cuda.synchronize()
    assert DK.fused_decoder_level.launches == n + 1
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_micro_trunk_kernels_match_plain(card):
    x0 = torch.as_tensor(np.random.default_rng(2).integers(0, 128, (2, 72, 128, 128),
                                                            dtype=np.int8), device=card)
    tp = _micro_tp(card)
    got = TK.micro_trunk_alpha(x0, tp)
    want = Q.xla_micro_trunk_alpha(x0, tp)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.gpu
def test_refine_kernel_f32_out_matches_plain(card):
    from video_stream_segmenetation_tpu_torch.ops.warp import separable_warp_indices

    alpha, prev, affine, use_warp, init, guide, pp, has_prior, knobs = _refine_inputs(card)
    got_prev, got = TR.fused_temporal_refine(alpha, prev, affine, use_warp, init, 0.3,
                                             guide, pp, has_prior, knobs,
                                             out_dtype=torch.float32)
    yi, xi = separable_warp_indices(affine, alpha.shape[-2:])
    table = TR.scalar_table(knobs, use_warp, init, 0.3, pp, has_prior)
    want_prev, want = TR.fused_temporal_refine_plain(alpha, prev, yi, xi, guide, table,
                                                     torch.float32)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert (got_prev - want_prev).abs().max().item() <= 2e-5
    assert (got - want).abs().max().item() <= 2e-5


@pytest.mark.gpu
def test_micro_engine_on_card_runs_its_kernels(card):
    from video_stream_segmenetation_tpu_torch.kernels import decoder_int8 as DK

    eng = Engine(2, preset("fast_int8_micro", frame_hw=(160, 320), mask_hw=(64, 128)), seed=0)
    eng.admit_all()
    frames = np.random.default_rng(0).integers(0, 256, (2, 160, 320, 3), dtype=np.uint8)
    n_d, n_r = DK.fused_decoder_level.launches, TR.fused_temporal_refine.launches
    for _ in range(2):
        out = eng.process(frames)
    assert DK.fused_decoder_level.launches == n_d + 4
    assert TR.fused_temporal_refine.launches == n_r + 2
    assert out["alpha"].dtype == torch.float32 and out["face_applied"].is_cuda


def _k_trunk(device, plan, k):
    from video_stream_segmenetation_tpu_torch.models.mattenet_hd import init_params

    return trunk_params(quantize_mattenet_hd(init_params(plan, 0, 10, k), 10, plan), device)


@pytest.mark.gpu
@pytest.mark.parametrize("plan,k,hw", [("pico", 4, (72, 128)), ("nano", 4, (72, 128)),
                                       ("nano", 3, (16, 32))])
def test_k_class_trunk_kernel_matches_plain(card, plan, k, hw):
    """The K-class head at the pico and nano widths: logits [S, H, W, K]
    equal to the plain trunk's (exact s32 sums, the same f32 epilogue);
    K = 3 as well, so the class axis cannot pass by symmetry."""
    tp = _k_trunk(card, plan, k)
    x0 = torch.as_tensor(np.random.default_rng(3).integers(0, 128, (2, *hw, 128),
                                                            dtype=np.int8), device=card)
    n = TK.fused_nano_trunk_alpha.launches
    got = TK.fused_nano_trunk_alpha(x0, tp)
    want = Q.xla_trunk_alpha(x0, tp)
    torch.cuda.synchronize()
    assert TK.fused_nano_trunk_alpha.launches == n + 1
    assert got.shape == want.shape == (2, *hw, k)
    assert torch.equal(got, want)


def test_k_class_head_refuses_too_many_classes():
    """The head kernel takes 1 to ALPHA_HEAD_MAX_K classes; the wrapper
    refuses more by name before it launches (checked without a card)."""
    tp = {"w": torch.zeros((TK.ALPHA_HEAD_MAX_K + 1, 3, 3, 128), dtype=torch.int8),
          "mult": torch.ones(TK.ALPHA_HEAD_MAX_K + 1),
          "bias": torch.zeros(TK.ALPHA_HEAD_MAX_K + 1)}
    u1 = torch.zeros((1, 4, 4, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="classes"):
        TK._alpha_head(None, 0, u1, tp)


@pytest.mark.gpu
@pytest.mark.parametrize("name,mask_hw", [("multiclass_fast_pico", (16, 32)),
                                          ("multiclass_fast", (64, 128))])
def test_multiclass_engine_on_card_runs_the_trunk(card, name, mask_hw):
    eng = Engine(2, preset(name, frame_hw=(160, 320), mask_hw=mask_hw), seed=0)
    eng.admit_all()
    frames = np.random.default_rng(0).integers(0, 256, (2, 160, 320, 3), dtype=np.uint8)
    n_t, n_r = TK.fused_nano_trunk_alpha.launches, TR.fused_temporal_refine.launches
    for _ in range(2):
        out = eng.process(frames)
    assert TK.fused_nano_trunk_alpha.launches == n_t + 2
    assert TR.fused_temporal_refine.launches == n_r
    ca = out["class_alpha"]
    assert ca.shape == (2, *mask_hw, 4) and ca.is_cuda
    assert (ca.sum(-1) - 1).abs().max().item() <= 1e-3
    assert out["frame"].shape == (2, 160, 320, 3)


def _precision_flags():
    m = torch.backends.cuda.matmul
    return (m.allow_tf32, torch.backends.cudnn.allow_tf32,
            m.allow_bf16_reduced_precision_reduction)


def _set_precision_flags(matmul_tf32, cudnn_tf32, bf16_reduction):
    m = torch.backends.cuda.matmul
    m.allow_tf32 = matmul_tf32
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    m.allow_bf16_reduced_precision_reduction = bf16_reduction


@pytest.mark.gpu
def test_served_step_does_not_depend_on_precision_flags(card):
    """One step of fast_int8_pico with the face path on (16 streams, seeded
    weights, 720p frames, backgrounds resized from 360x640): the same
    frame and alpha bit for bit with TF32 (matmul and cuDNN) and cuBLAS's
    bf16 reduced-precision reductions on as with all three off; the
    engine leaves the caller's flags as it found them."""
    s = 16
    g = np.random.default_rng(5)
    frames = (g.random((s, 720, 1280, 3)) * 90).astype(np.uint8)
    yy, xx = np.ogrid[0:720, 0:1280]
    frames[:, ((xx - 640) / 200.0) ** 2 + ((yy - 380) / 260.0) ** 2 <= 1.0] = (230, 200, 175)
    bgs = g.integers(0, 256, (s, 360, 640, 3), dtype=np.uint8)

    def serve():
        eng = Engine(s, preset("fast_int8_pico"), seed=0)
        eng.face_min_interval_s = 0.0
        eng.admit_all()
        for i in range(s):
            eng.set_background(i, bgs[i])
        out = eng.process(frames)
        return out["frame"].cpu(), out["alpha"].float().cpu()

    saved = _precision_flags()
    try:
        _set_precision_flags(False, False, False)
        strict = serve()
        _set_precision_flags(True, True, True)
        loose = serve()
        assert _precision_flags() == (True, True, True)
    finally:
        _set_precision_flags(*saved)
    assert torch.equal(strict[0], loose[0])
    assert torch.equal(strict[1], loose[1])


# ---- plans B and C, the conv kernel, the u1-out trunk ----------------------


def _conv_case(device, cin, cout, hw, seed=4):
    g = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    x = t(g.integers(0, 128, (2, *hw, cin), dtype=np.int8))
    wq = t(g.integers(-127, 128, (3, 3, cin, cout), dtype=np.int8))
    mult = t((g.random(cout) * 2e-2).astype(np.float32))
    bias = t((g.random(cout) - 0.5).astype(np.float32))
    res = t(g.integers(0, 128, (2, *hw, cout), dtype=np.int8))
    return x, wq, mult, bias, res


@pytest.mark.gpu
@pytest.mark.parametrize("dilation,cin,cout,hw", [
    (1, 128, 128, (72, 128)), (1, 192, 192, (36, 64)), (2, 256, 256, (18, 32)),
    (4, 256, 256, (18, 32)), (3, 64, 100, (5, 7))],
    ids=["d1-72x128", "d1-36x64", "d2-18x32", "d4-18x32", "d3-ragged"])
@pytest.mark.parametrize("act", [True, False], ids=["act", "noact"])
@pytest.mark.parametrize("residual", [False, True], ids=["nores", "res"])
def test_conv3x3_kernel_matches_plain(card, residual, act, dilation, cin, cout, hw):
    """conv3x3_i8_fused's four forms at plan B's layer shapes and a ragged
    one (output channels not a multiple of the 64-channel tile, pixels not
    a multiple of 64): bit for bit the plain version."""
    from video_stream_segmenetation_tpu_torch.kernels import conv_int8 as TC

    x, wq, mult, bias, res = _conv_case(card, cin, cout, hw)
    r = res if residual else None
    n = TC.conv3x3_i8_fused.launches
    got = TC.conv3x3_i8_fused(x, wq, mult, bias, r, act=act, dilation=dilation)
    want = TC.conv3x3_i8_plain(x, wq, mult, bias, r, act=act, dilation=dilation)
    torch.cuda.synchronize()
    assert TC.conv3x3_i8_fused.launches == n + 1
    assert got.dtype == torch.int8 and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("plan", ["pico", "nano"])
def test_u1_trunk_kernel_matches_plain(card, plan):
    """fused_nano_trunk (u1 out, no head) at the 72x128 stem grid: u1 s8
    bit for bit the plain trunk's; one count, none in the head form's."""
    tp = _k_trunk(card, plan, 1)
    x0 = torch.as_tensor(np.random.default_rng(5).integers(0, 128, (2, 72, 128, 128),
                                                            dtype=np.int8), device=card)
    n, n_alpha = TK.fused_nano_trunk.launches, TK.fused_nano_trunk_alpha.launches
    got = TK.fused_nano_trunk(x0, tp)
    want = Q.xla_trunk(x0, tp)
    torch.cuda.synchronize()
    assert TK.fused_nano_trunk.launches == n + 1
    assert TK.fused_nano_trunk_alpha.launches == n_alpha
    assert got.shape == (2, 72, 128, 128) and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("conv_impl", ["xla", "pallas"])
@pytest.mark.parametrize("plan", ["full", "light", "micro"])
def test_plan_trunk_kernels_match_plain(card, plan, conv_impl):
    """Plans B, C and micro on the card at the 72x128 stem grid, seeded
    weights: u1 bit for bit the plain trunk's, the logits within 1e-5 (the
    same bound as the other trunks'); with 'pallas' the routed convs launch
    the conv kernel (B: 4, C: 5, micro: 2 a call), with 'xla' never."""
    from video_stream_segmenetation_tpu_torch.kernels import conv_int8 as TC
    from video_stream_segmenetation_tpu_torch.kernels import decoder_int8 as DK

    tp = _k_trunk(card, plan, 1)
    x0 = torch.as_tensor(np.random.default_rng(6).integers(0, 128, (2, 72, 128, 128),
                                                            dtype=np.int8), device=card)
    fn = TK.PLAN_TRUNKS[plan]
    n_c, n_d, n_t = TC.conv3x3_i8_fused.launches, DK.fused_decoder_level.launches, \
        fn.launches
    u1 = fn(x0, tp, conv_impl=conv_impl, head=False)
    logits = fn(x0, tp, conv_impl=conv_impl)
    plain_u1 = Q.PLAIN_TRUNKS[plan](x0, tp)
    want = Q.alpha_head(plain_u1, tp["alpha"])
    torch.cuda.synchronize()
    routed = {"full": 4, "light": 5, "micro": 2}[plan] if conv_impl == "pallas" else 0
    assert TC.conv3x3_i8_fused.launches == n_c + 2 * routed
    assert DK.fused_decoder_level.launches == n_d + (0 if plan == "full" else 4)
    assert fn.launches == n_t + 2
    assert torch.equal(u1, plain_u1)
    assert (logits - want).abs().max().item() <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("name,over,counter,per_step", [
    ("fast_int8", {"int8_conv_impl": "pallas"}, "conv", 4),
    ("fast_int8_lite", {"int8_conv_impl": "pallas"}, "conv", 5),
    ("fast_int8", {}, "full", 1),
    ("fast_int8_pico", {"int8_head_impl": "bf16"}, "u1", 1)])
def test_plan_engines_on_card_run_their_kernels(card, name, over, counter, per_step):
    """The new presets and switches through Engine.process on the card
    (small geometry, seeded weights): each step launches the routed
    kernels as many times as the plan has routed layers, and the bf16 head
    runs on the u1-out trunk with no int8-head trunk launch."""
    from video_stream_segmenetation_tpu_torch.kernels import conv_int8 as TC

    eng = Engine(2, preset(name, frame_hw=(160, 320), mask_hw=(64, 128), **over), seed=0)
    eng.admit_all()
    frames = np.random.default_rng(0).integers(0, 256, (2, 160, 320, 3), dtype=np.uint8)
    counters = {"conv": TC.conv3x3_i8_fused, "full": TK.full_trunk_alpha,
                "u1": TK.fused_nano_trunk, "alpha": TK.fused_nano_trunk_alpha}
    before = {k: c.launches for k, c in counters.items()}
    for _ in range(2):
        out = eng.process(frames)
    assert counters[counter].launches == before[counter] + 2 * per_step
    if counter == "u1":
        assert TK.fused_nano_trunk_alpha.launches == before["alpha"]
    assert out["frame"].shape == (2, 160, 320, 3)
    assert bool(torch.isfinite(out["alpha"].float()).all())


# ---- active: the composite kernel, the plane-prior refine, fused_refine ------


@pytest.mark.gpu
@pytest.mark.parametrize("s,h,w,mh,mw,bg_rows", [
    (2, 80, 160, 32, 64, 2), (2, 720, 1280, 288, 512, 2), (3, 50, 70, 21, 33, 1)],
    ids=["80x160", "720p", "ragged-broadcast-bg"])
def test_composite_kernel_matches_plain(card, s, h, w, mh, mw, bg_rows):
    """The fused composite equals its plain version (the matrix form, TF32
    off) bit for bit: 720p, a small frame, and a ragged one whose rows are
    not a multiple of 16 bytes, with one background for every stream."""
    from video_stream_segmenetation_tpu_torch.kernels import composite_fused as KC
    from video_stream_segmenetation_tpu_torch.runtime.precision import pinned

    g = np.random.default_rng(7)
    frames = torch.as_tensor(g.integers(0, 256, (s, h, w, 3), dtype=np.uint8), device=card)
    bg = torch.as_tensor(g.integers(0, 256, (bg_rows, h, w, 3), dtype=np.uint8), device=card)
    alpha = torch.as_tensor(g.random((s, mh, mw), dtype=np.float32), device=card)
    alpha[0, : mh // 4] = 0.0
    alpha[-1, -(mh // 4):] = 1.0
    n = KC.fused_composite.launches
    got = KC.fused_composite(frames, alpha, bg)
    with pinned():
        want = KC.fused_composite_plain(frames, alpha, bg)
    torch.cuda.synchronize()
    assert KC.fused_composite.launches == n + 1
    assert got.dtype == torch.uint8 and torch.equal(got, want)


def _plane(pp, has_prior, hw):
    from video_stream_segmenetation_tpu_torch.ops.prior import prior_plane_from_params

    return torch.where(has_prior[:, None, None], prior_plane_from_params(pp, hw),
                       torch.zeros((), device=pp.device)).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(40, 72), (288, 512), (37, 61)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_plane_refine_kernel_matches_plain(card, hw, out_dtype):
    """The plane-prior form of the temporal refine against its plain
    version: new_prev within 2e-5, the refined alpha within 2e-5 (f32) or
    4e-3 (bf16), as the analytic form is held; one count in its own
    counter, none in the analytic form's."""
    from video_stream_segmenetation_tpu_torch.ops.warp import separable_warp_indices

    alpha, prev, affine, use_warp, init, guide, pp, has_prior, knobs = _refine_inputs(
        card, h=hw[0], w=hw[1])
    pp = pp * torch.tensor([hw[1] / 72, hw[0] / 40, hw[1] / 72, hw[0] / 40], device=card)
    plane = _plane(pp, has_prior, hw)
    n, n_a = TR.fused_temporal_refine_plane.launches, TR.fused_temporal_refine.launches
    got_prev, got = TR.fused_temporal_refine_plane(alpha, prev, affine, use_warp, init, 0.3,
                                                   guide, plane, has_prior, knobs,
                                                   out_dtype=out_dtype)
    yi, xi = separable_warp_indices(affine, hw)
    table = TR.scalar_table(knobs, use_warp, init, 0.3, torch.zeros_like(pp), has_prior)
    want_prev, want = TR.fused_temporal_refine_plain(alpha, prev, yi, xi, guide, table,
                                                     out_dtype, plane)
    torch.cuda.synchronize()
    assert TR.fused_temporal_refine_plane.launches == n + 1
    assert TR.fused_temporal_refine.launches == n_a
    assert got.dtype == out_dtype
    assert (got_prev - want_prev).abs().max().item() <= 2e-5
    tol = 2e-5 if out_dtype == torch.float32 else 4e-3
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(40, 72), (288, 512), (37, 61)])
def test_fused_refine_kernel_matches_plain(card, hw):
    """fused_refine (stages 5/7/8/9, the prior plane, f32 out) within 2e-5
    of its plain version (exp/pow ulps)."""
    alpha, _, _, _, _, guide, pp, has_prior, knobs = _refine_inputs(card, h=hw[0], w=hw[1])
    pp = pp * torch.tensor([hw[1] / 72, hw[0] / 40, hw[1] / 72, hw[0] / 40], device=card)
    plane = _plane(pp, has_prior, hw)
    n = TR.fused_refine.launches
    got = TR.fused_refine(alpha, guide, plane, has_prior, knobs)
    want = TR.fused_refine_plain(alpha, guide, plane, TR.refine_table(knobs, has_prior))
    torch.cuda.synchronize()
    assert TR.fused_refine.launches == n + 1
    assert got.dtype == torch.float32
    assert (got - want).abs().max().item() <= 2e-5


@pytest.mark.gpu
@pytest.mark.parametrize("over,counts", [
    ({}, {"analytic": 1}), ({"use_fused_composite": True}, {"analytic": 1, "composite": 1}),
    ({"prior_impl": "plane"}, {"plane": 1}), ({"warp_impl": "exact"}, {"refine": 1})])
def test_active_engine_on_card_runs_its_kernels(card, over, counts):
    """active's four routes through Engine.process on the card (seeded
    weights, 160x320 frames): each step launches its route's kernels once,
    the others never."""
    from video_stream_segmenetation_tpu_torch.kernels import composite_fused as KC

    eng = Engine(2, preset("active", frame_hw=(160, 320), mask_hw=(64, 128), fd_size=128,
                           lmk_size=128, **over), seed=0)
    eng.admit_all()
    frames = np.random.default_rng(0).integers(0, 256, (2, 160, 320, 3), dtype=np.uint8)
    counters = {"analytic": TR.fused_temporal_refine, "plane": TR.fused_temporal_refine_plane,
                "refine": TR.fused_refine, "composite": KC.fused_composite}
    before = {k: c.launches for k, c in counters.items()}
    for _ in range(2):
        out = eng.process(frames)
    for k, c in counters.items():
        assert c.launches == before[k] + 2 * counts.get(k, 0), k
    assert out["frame"].shape == (2, 160, 320, 3) and out["frame"].is_cuda
    assert out["alpha"].dtype == torch.float32
    assert bool(torch.isfinite(out["alpha"]).all())


def test_cpu_tensors_take_plain_versions_of_the_active_kernels():
    """The composite, the plane-prior refine and fused_refine on CPU tensors:
    their plain versions, no launch counted."""
    from video_stream_segmenetation_tpu_torch.kernels import composite_fused as KC

    counters = (KC.fused_composite, TR.fused_temporal_refine_plane, TR.fused_refine)
    before = [c.launches for c in counters]
    alpha, prev, affine, use_warp, init, guide, pp, has_prior, knobs = _refine_inputs("cpu")
    plane = _plane(pp, has_prior, (40, 72))
    got = TR.fused_refine(alpha, guide, plane, has_prior, knobs)
    assert torch.equal(got, TR.fused_refine_plain(alpha, guide, plane,
                                                  TR.refine_table(knobs, has_prior)))
    TR.fused_temporal_refine_plane(alpha, prev, affine, use_warp, init, 0.3, guide, plane,
                                   has_prior, knobs)
    frames = torch.zeros((4, 80, 144, 3), dtype=torch.uint8)
    assert torch.equal(KC.fused_composite(frames, alpha, frames + 7),
                       KC.fused_composite_plain(frames, alpha, frames + 7))
    assert [c.launches for c in counters] == before
