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
    # four streams' settings, repeated over more streams
    affine = t(np.resize(np.asarray([[1.05, 0, 2.5, 0, 0.97, -1.5], [1, 0, 0, 0, 1, 0],
                                     [1.0, 0, 30.0, 0, 1.0, 12.0], [0.9, 0, -1.0, 0, 1.1, 3.0]],
                                    np.float32), (s, 6)))
    init = t(np.resize(np.asarray([True, True, False, True]), s))
    use_warp = t(np.resize(np.asarray([True, False, True, True]), s)) & init
    has_prior = t(np.resize(np.asarray([True, False, True, False]), s))
    pp = t(np.asarray([[30.0, 18.0, 14.0, 12.0]] * s, np.float32))
    knobs = default_knobs(s, ema_adapt=1.0, device=device)
    knobs.use_bilateral = t(np.resize(np.asarray([True, True, False, True]), s))
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


# (id, streams, small's grid, Ca, Cb, Cout, the level of a plan's seeded
# weights or None for random 1x1 weights): micro's and plan C's u2 and u1
# at the 720p grids; one stream; tiles of 64 parents that end inside a
# stream (5x7) or past the last parent (3x5, 5x7); Ca and Cb of 128, 192
# and 256; Cout 128 and 192, one not a multiple of the N tile (odd), one
# over two N tiles (320)
DECODER_CASES = [
    ("micro-u2", 2, (18, 32), 256, 192, 192, ("micro", "u2")),
    ("micro-u1", 2, (36, 64), 192, 128, 128, ("micro", "u1")),
    ("light-u2", 2, (18, 32), 256, 192, 192, ("light", "u2")),
    ("light-u1", 2, (36, 64), 192, 128, 128, ("light", "u1")),
    ("micro-u1-ragged-3x5", 2, (3, 5), 192, 128, 128, ("micro", "u1")),
    ("s1-u1", 1, (36, 64), 192, 128, 128, None),
    ("ragged-5x7", 3, (5, 7), 256, 192, 192, None),
    ("ca128-cb256", 2, (5, 7), 128, 256, 128, None),
    ("ca256-cb128", 2, (9, 16), 256, 128, 192, None),
    ("ca192-cb192", 1, (9, 16), 192, 192, 192, None),
    ("cout-odd-37", 2, (5, 7), 128, 128, 37, None),
    ("cout-320", 1, (5, 7), 128, 192, 320, None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", DECODER_CASES, ids=[c[0] for c in DECODER_CASES])
def test_decoder_kernel_matches_plain(card, case):
    """The decoder level, one launch, bit-exact s8 (tolerance 0) against the
    plain split conv at micro's and plan C's levels and at the tile's
    edges (see DECODER_CASES)."""
    from video_stream_segmenetation_tpu_torch.kernels import decoder_int8 as DK

    _, s, grid, ca, cb, cout, level = case
    g = np.random.default_rng(len(DECODER_CASES) + ca + 2 * cb + cout)
    t = lambda a: torch.as_tensor(a, device=card)  # noqa: E731
    if level is not None:
        tp = _k_trunk(card, level[0], 1)
        up, sk = tp[f"{level[1]}red_up"], tp[f"{level[1]}red_skip"]
    else:
        # y spread over about 2 +- 4: the lattice's whole range
        mult = t(((0.5 + g.random(cout)) * 4e-4 / np.sqrt(ca + cb)).astype(np.float32))
        up = {"w": t(g.integers(-127, 128, (cout, 1, 1, ca), dtype=np.int8)), "mult": mult,
              "bias": t((g.random(cout) + 1.5).astype(np.float32))}
        sk = {"w": t(g.integers(-127, 128, (cout, 1, 1, cb), dtype=np.int8)), "mult": mult,
              "bias": torch.zeros_like(mult)}
    assert tuple(up["w"].shape) == (cout, 1, 1, ca) and tuple(sk["w"].shape) == (cout, 1, 1, cb)
    small = t(g.integers(0, 128, (s, *grid, ca), dtype=np.int8))
    skip = t(g.integers(0, 128, (s, 2 * grid[0], 2 * grid[1], cb), dtype=np.int8))
    n = DK.fused_decoder_level.launches
    got = DK.fused_decoder_level(small, skip, up, sk)
    want = Q.split_conv_up(small, skip, up, sk)
    torch.cuda.synchronize()
    assert DK.fused_decoder_level.launches == n + 1
    assert got.shape == want.shape == (s, 2 * grid[0], 2 * grid[1], cout)
    if level is None:
        inside = ((want > 0) & (want < 127)).float().mean().item()
        assert inside > 0.3, inside
    assert torch.equal(got, want), (got.double() - want.double()).abs().max().item()


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


@pytest.mark.gpu
@pytest.mark.parametrize("plan,hw", [("femto", (72, 128)), ("nano", (72, 128)),
                                     ("femto", (16, 32))])
def test_one_class_trunk_kernel_matches_plain_at_femto_and_nano(card, plan, hw):
    """The trunk kernel at the widths of fast_int8_femto (every level at
    128 channels) and fast_int8_nano (192/256) with the one-class head:
    logits [S, H, W] equal to the plain trunk's (tolerance 0: exact s32
    sums, the same f32 epilogues, the SE in float64 on both sides)."""
    tp = _k_trunk(card, plan, 1)
    x0 = torch.as_tensor(np.random.default_rng(5).integers(0, 128, (2, *hw, 128),
                                                            dtype=np.int8), device=card)
    n = TK.fused_nano_trunk_alpha.launches
    got = TK.fused_nano_trunk_alpha(x0, tp)
    want = Q.xla_trunk_alpha(x0, tp)
    torch.cuda.synchronize()
    assert TK.fused_nano_trunk_alpha.launches == n + 1
    assert got.shape == want.shape == (2, *hw)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("name,trunk,refine", [
    ("fast_int8_nano", 1, 1), ("fast_int8_femto", 1, 1), ("blaze_tracking", 0, 0),
    ("branch", 0, 0), ("rvm", 0, 0), ("u2", 0, 0), ("fast_int8_pico", 1, 0)])
def test_zoo_engines_on_card_run_their_kernels(card, name, trunk, refine):
    """The new presets through Engine.process on the card (small geometry,
    seeded weights): nano and femto launch the trunk and the refine kernel
    once a step; the chain pipelines launch neither, and pico with
    use_fused_refine=False its trunk only."""
    over = {"use_fused_refine": False} if name == "fast_int8_pico" else {}
    mask = (40, 40) if name == "u2" else (64, 128)
    eng = Engine(2, preset(name, frame_hw=(160, 320), mask_hw=mask, fd_size=64, lmk_size=48,
                           **over), seed=0)
    eng.face_min_interval_s = 0.0
    eng.admit_all()
    frames = np.random.default_rng(0).integers(0, 256, (2, 160, 320, 3), dtype=np.uint8)
    before = (TK.fused_nano_trunk_alpha.launches, TR.fused_temporal_refine.launches)
    for _ in range(2):
        out = eng.process(frames)
    assert not out["passthrough"]
    assert TK.fused_nano_trunk_alpha.launches == before[0] + 2 * trunk
    assert TR.fused_temporal_refine.launches == before[1] + 2 * refine
    assert out["alpha"].dtype == torch.float32 and tuple(out["alpha"].shape) == (2, *mask)
    assert bool(torch.isfinite(out["alpha"]).all())
    if name == "rvm":
        assert all(r.is_cuda and bool(r.abs().sum() > 0) for r in eng.state.rec)


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
    (4, 256, 256, (18, 32)), (3, 64, 100, (5, 7)), (1, 32, 128, (9, 16)),
    (2, 128, 260, (9, 16))],
    ids=["d1-72x128", "d1-36x64", "d2-18x32", "d4-18x32", "d3-ragged", "cin32",
         "cout260-two-n-tiles"])
@pytest.mark.parametrize("act", [True, False], ids=["act", "noact"])
@pytest.mark.parametrize("residual", [False, True], ids=["nores", "res"])
def test_conv3x3_kernel_matches_plain(card, residual, act, dilation, cin, cout, hw):
    """conv3x3_i8_fused's four forms at plan B's layer shapes, a ragged one
    (output channels not a multiple of the 64-channel tile, pixels not a
    multiple of the 128-pixel tile), 32 input channels and 260 output
    channels (two N tiles): bit for bit the plain version."""
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


def _conv_i8_plain(x, layer, stride=1, dil=1, mode=0, res=None, up=None, in_up=False):
    """One launch of the conv tile in plain PyTorch, in the plain trunks'
    f32 order: ``acc * mult + bias``, then mode 1 as it is, mode 2
    ``clip(y + res * 6/127, 0, 6)``, mode 3 (conv3x3_i8_fused's no-act
    form) ``clip(rint((y [+ res * 6/127]) * 127/6), -127, 127)``, mode 0
    ``requant(up + y [+ res * 6/127])`` with ``up`` at the output grid or
    at half of it."""
    y = Q._conv_i8(Q._nearest_x2(x) if in_up else x, layer, stride, dil)
    if mode == 1:
        return y
    if mode == 2:
        return torch.clamp(y + res.to(torch.float32) * Q.ACT_SCALE, 0.0, 6.0)
    if mode == 3:
        if res is not None:
            y = y + res.to(torch.float32) * Q.ACT_SCALE
        return torch.clamp(torch.round(y * Q.RELU6_SCALE), -127, 127).to(torch.int8)
    if up is not None:
        y = (up if up.shape[1:3] == y.shape[1:3] else Q._nearest_x2(up)) + y
    if res is not None:
        y = y + res.to(torch.float32) * Q.ACT_SCALE
    return Q._requant(y)


# (id, streams, grid, Cin, Cout, kernel size, stride, dilation, mode, with a
# residual, the addend's grid ('same' or 'half' of the output's), in_shift)
CONV_EDGES = [
    ("1x1-one-tile", 1, (8, 16), 128, 128, 1, 1, 1, 1, False, None, False),
    ("3x3-s1", 1, (16, 32), 128, 128, 3, 1, 1, 0, False, None, False),
    ("3x3-s3", 3, (16, 32), 128, 128, 3, 1, 1, 0, False, None, False),
    ("ragged-m", 3, (18, 30), 192, 192, 3, 1, 1, 0, False, None, False),
    ("under-one-tile", 1, (6, 10), 128, 256, 3, 1, 1, 0, False, None, False),
    ("stride2-c192", 3, (16, 32), 128, 192, 3, 2, 1, 0, False, None, False),
    ("stride2-c256-odd", 1, (18, 30), 192, 256, 3, 2, 1, 0, False, None, False),
    ("dil2", 2, (18, 32), 256, 256, 3, 1, 2, 0, False, None, False),
    ("dil3-mode2", 3, (18, 32), 192, 192, 3, 1, 3, 2, True, None, False),
    ("dil4-mode1", 2, (18, 32), 256, 256, 3, 1, 4, 1, False, None, False),
    ("residual", 1, (16, 32), 128, 128, 3, 1, 1, 0, True, None, False),
    ("1x1-up-half", 3, (16, 32), 128, 128, 1, 1, 1, 0, False, "half", False),
    ("1x1-up-half-c192", 1, (18, 32), 192, 192, 1, 1, 1, 0, False, "half", False),
    ("3x3-up-same", 2, (16, 32), 192, 128, 3, 1, 1, 0, False, "same", False),
    ("in-shift", 2, (16, 32), 256, 192, 3, 1, 1, 1, False, None, True),
    ("1x1-mode1-c192", 3, (9, 16), 256, 192, 1, 1, 1, 1, False, None, False),
    # mode 3 is the routed instantiation's (conv3x3_i8_fused, act=False)
    ("noact-ragged-m", 3, (18, 30), 192, 192, 3, 1, 1, 3, False, None, False),
    ("noact-res-dil2", 2, (18, 32), 256, 256, 3, 1, 2, 3, True, None, False),
    ("noact-cout100", 1, (6, 10), 64, 100, 3, 1, 1, 3, False, None, False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CONV_EDGES, ids=[c[0] for c in CONV_EDGES])
def test_conv_kernel_edges_match_plain(card, case):
    """The tensor-core conv tile (one launch: ``vst_conv_i8``, or for mode 3
    ``conv3x3_i8_fused`` without act, its routed instantiation) at its
    edges: ragged M (tiles that end inside a stream or past the last),
    Cout 100/128/192/256, stride 2 with odd output grids, dilations 2/3/4,
    the residual, the addend at the output's grid and at half of it, the
    input read through a nearest x2 upsample, the four modes; bit for bit
    the plain version (tolerance 0)."""
    from video_stream_segmenetation_tpu_torch.kernels import _build
    from video_stream_segmenetation_tpu_torch.kernels import conv_int8 as TC

    _, s, hw, cin, cout, k, stride, dil, mode, with_res, up_grid, in_up = case
    g = np.random.default_rng(len(CONV_EDGES) + cout + cin + k)
    t = lambda a: torch.as_tensor(a, device=card)  # noqa: E731
    xhw = (hw[0] // 2, hw[1] // 2) if in_up else hw
    x = t(g.integers(0, 128, (s, *xhw, cin), dtype=np.int8))
    layer = {"w": t(g.integers(-127, 128, (cout, k, k, cin), dtype=np.int8)),
             # y = acc * mult + bias spread over about 2 +- 3: the lattice's
             # whole range, not only its two ends
             "mult": t(((0.5 + g.random(cout)) * 6e-4 / np.sqrt(k * k * cin))
                       .astype(np.float32)),
             "bias": t((g.random(cout) + 1.5).astype(np.float32))}
    ho, wo = -(-hw[0] // stride), -(-hw[1] // stride)
    res = t(g.integers(0, 128, (s, ho, wo, cout), dtype=np.int8)) if with_res else None
    up = None
    if up_grid is not None:
        uh, uw = (ho, wo) if up_grid == "same" else (ho // 2, wo // 2)
        up = t((g.random((s, uh, uw, cout)) * 4.0 - 1.0).astype(np.float32))
    if mode == 3:
        n = TC.conv3x3_i8_fused.launches
        got = TC.conv3x3_i8_fused(x, layer["w"].permute(1, 2, 3, 0).contiguous(),
                                  layer["mult"], layer["bias"], res, act=False, dilation=dil,
                                  w_ohwi=layer["w"])
        assert TC.conv3x3_i8_fused.launches == n + 1
    else:
        out_dtype = torch.int8 if mode == 0 else torch.float32
        got = TK._conv(_build.library(), torch.cuda.current_stream(card).cuda_stream, x,
                       layer, out_dtype, stride=stride, dil=dil, mode=mode, res=res, up=up,
                       in_up=in_up)
    want = _conv_i8_plain(x, layer, stride, dil, mode, res, up, in_up)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape == (s, ho, wo, cout)
    if mode in (0, 3):
        # most outputs inside the lattice, not at its ends
        inside = ((want > 0) & (want < 127)).float().mean().item()
        assert inside > 0.3, inside
    assert torch.equal(got, want), (got.double() - want.double()).abs().max().item()


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


# ---- the fast form of the temporal refine and the production rotation ------

FAST_ROUTE = dict(refine_alpha_src="lowres", guide_kernel_unfold=True, guide_source="host")
SMALL = dict(frame_hw=(80, 160), mask_hw=(32, 64), fd_size=64, lmk_size=48)


def _fast_inputs(device, s, hw, seed=0):
    """Head-grid logits (a quarter of ``hw``), the alpha they upsample to,
    a planar guide and its tap lanes (geometry (4, 4)), and the rest."""
    from video_stream_segmenetation_tpu_torch.ops.resize import resize_bilinear_mxu
    from video_stream_segmenetation_tpu_torch.runtime.precision import pinned

    h, w = hw
    _, prev, affine, use_warp, init, _, pp, has_prior, knobs = _refine_inputs(device, s, h, w,
                                                                               seed)
    g = np.random.default_rng(seed + 1)
    logits = torch.as_tensor((g.random((s, h // 4, w // 4), dtype=np.float32) - 0.5) * 8,
                             device=device)
    with pinned():
        alpha = torch.sigmoid(resize_bilinear_mxu(logits, hw, "half_pixel",
                                                  channel_last=False)).contiguous()
    guide = torch.as_tensor(g.integers(0, 256, (s, 3, h, w), dtype=np.uint8), device=device)
    lanes = guide.reshape(s, 3, h // 4, 4, w // 4, 4).permute(1, 3, 5, 0, 2, 4) \
        .reshape(48, s, h // 4, w // 4).contiguous()
    return logits, alpha, guide, lanes, prev, affine, use_warp, init, pp, has_prior, knobs


def test_cpu_fast_refine_counts_no_launch():
    logits, _, _, lanes, prev, affine, use_warp, init, pp, has_prior, knobs = _fast_inputs(
        "cpu", 4, (40, 72))
    before = TR.fused_temporal_refine_fast.launches
    new_prev, out = TR.fused_temporal_refine_fast(logits, prev, affine, use_warp, init, 0.3,
                                                  lanes, pp, has_prior, knobs,
                                                  alpha_lowres_hw=(40, 72),
                                                  guide_lanes_geom=(4, 4))
    assert TR.fused_temporal_refine_fast.launches == before
    assert out.shape == new_prev.shape == (4, 40, 72) and out.dtype == torch.bfloat16


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(40, 72), (288, 512)])
@pytest.mark.parametrize("form", ["lowres", "lanes", "lowres+lanes"])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_fast_refine_kernel_matches_plain(card, hw, form, out_dtype):
    """The kernel's three fast forms against the plain version (720p's
    288x512 mask and a small one): new_prev within 2e-5, the refined alpha
    within 4e-3 (bf16) or 2e-5 (f32); the lanes form exact."""
    from video_stream_segmenetation_tpu_torch.ops.warp import separable_warp_indices
    from video_stream_segmenetation_tpu_torch.runtime.precision import pinned

    logits, alpha, guide, lanes, prev, affine, use_warp, init, pp, has_prior, knobs = \
        _fast_inputs(card, 4, hw)
    lowres, use_lanes = "lowres" in form, "lanes" in form
    a_src, g_src = (logits if lowres else alpha), (lanes if use_lanes else guide)
    lhw, geom = (hw if lowres else None), ((4, 4) if use_lanes else None)
    before = TR.fused_temporal_refine_fast.launches
    got_prev, got = TR.fused_temporal_refine_fast(a_src, prev, affine, use_warp, init, 0.3,
                                                  g_src, pp, has_prior, knobs,
                                                  out_dtype=out_dtype, alpha_lowres_hw=lhw,
                                                  guide_lanes_geom=geom)
    assert TR.fused_temporal_refine_fast.launches == before + 1
    yi, xi = separable_warp_indices(affine, hw)
    table = TR.scalar_table(knobs, use_warp, init, 0.3, pp, has_prior)
    with pinned():
        want_prev, want = TR.fused_temporal_refine_plain(a_src, prev, yi, xi, g_src, table,
                                                         out_dtype, None, lhw, geom)
    torch.cuda.synchronize()
    tol = 4e-3 if out_dtype == torch.bfloat16 else 2e-5
    assert got.dtype == out_dtype
    assert (got_prev - want_prev).abs().max().item() <= (0 if not lowres else 2e-5)
    assert (got.float() - want.float()).abs().max().item() <= (0 if not lowres else tol)


REFINE_FORMS = ["analytic-bf16", "analytic-f32", "plane", "fused_refine", "lowres", "lanes",
                "lowres+lanes", "lowres-same-grid"]


@pytest.mark.gpu
@pytest.mark.parametrize("form", REFINE_FORMS)
def test_refine_forms_at_ragged_tiles(card, form):
    """Every form of the refine body at a plane whose width (200) is not a
    multiple of a block's strip (86 columns) and whose height (148) ends
    inside a block's segment (72 rows): three strips and three segments,
    the zero border only at the plane's edges.  Held as each form's own
    test holds it: new_prev within 2e-5, the refined alpha within 4e-3
    (bf16) or 2e-5 (f32); the lanes form exact."""
    from video_stream_segmenetation_tpu_torch.ops.warp import separable_warp_indices
    from video_stream_segmenetation_tpu_torch.runtime.precision import pinned

    hw = (148, 200)
    logits, alpha, guide, lanes, prev, affine, use_warp, init, pp, has_prior, knobs = \
        _fast_inputs(card, 3, hw, seed=3)
    # the prior ellipse inside the plane, near its bottom-right strip
    pp = pp * torch.tensor([5.0, 6.0, 3.0, 3.0], device=card)
    yi, xi = separable_warp_indices(affine, hw)
    f32, bf16 = torch.float32, torch.bfloat16
    if form == "fused_refine":
        plane = _plane(pp, has_prior, hw)
        got = TR.fused_refine(alpha, guide, plane, has_prior, knobs)
        want = TR.fused_refine_plain(alpha, guide, plane, TR.refine_table(knobs, has_prior))
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= 2e-5
        return
    if form == "plane":
        plane = _plane(pp, has_prior, hw)
        table = TR.scalar_table(knobs, use_warp, init, 0.3, torch.zeros_like(pp), has_prior)
        got_prev, got = TR.fused_temporal_refine_plane(alpha, prev, affine, use_warp, init, 0.3,
                                                       guide, plane, has_prior, knobs,
                                                       out_dtype=f32)
        want_prev, want = TR.fused_temporal_refine_plain(alpha, prev, yi, xi, guide, table, f32,
                                                         plane)
        tol_prev, tol = 2e-5, 2e-5
    elif form.startswith("analytic"):
        out_dtype = bf16 if form.endswith("bf16") else f32
        table = TR.scalar_table(knobs, use_warp, init, 0.3, pp, has_prior)
        got_prev, got = TR.fused_temporal_refine(alpha, prev, affine, use_warp, init, 0.3,
                                                 guide, pp, has_prior, knobs,
                                                 out_dtype=out_dtype)
        want_prev, want = TR.fused_temporal_refine_plain(alpha, prev, yi, xi, guide, table,
                                                         out_dtype)
        tol_prev, tol = 2e-5, (4e-3 if out_dtype == bf16 else 2e-5)
    else:
        lowres, use_lanes = "lowres" in form, "lanes" in form
        if form == "lowres-same-grid":
            # logits on the plane's own grid: a strip reads one more
            # head-grid column than it has columns
            logits = torch.as_tensor((np.random.default_rng(4).random((3, *hw), dtype=np.float32)
                                      - 0.5) * 8, device=card)
        a_src, g_src = (logits if lowres else alpha), (lanes if use_lanes else guide)
        lhw, geom = (hw if lowres else None), ((4, 4) if use_lanes else None)
        table = TR.scalar_table(knobs, use_warp, init, 0.3, pp, has_prior)
        got_prev, got = TR.fused_temporal_refine_fast(a_src, prev, affine, use_warp, init, 0.3,
                                                      g_src, pp, has_prior, knobs,
                                                      alpha_lowres_hw=lhw, guide_lanes_geom=geom)
        with pinned():
            want_prev, want = TR.fused_temporal_refine_plain(a_src, prev, yi, xi, g_src, table,
                                                             bf16, None, lhw, geom)
        tol_prev, tol = (2e-5, 4e-3) if lowres else (0, 0)
    torch.cuda.synchronize()
    assert bool(has_prior.any()) and float((want.float() > 0.5).float().mean()) > 0.05
    assert (got_prev - want_prev).abs().max().item() <= tol_prev
    assert got.dtype == want.dtype
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.gpu
def test_fast_refine_refuses_logits_larger_than_the_plane(card):
    """The kernel takes head-grid logits no larger than the plane (a strip
    of the plane reads at most one head-grid column more than it has)."""
    logits, _, guide, _, prev, affine, use_warp, init, pp, has_prior, knobs = \
        _fast_inputs(card, 2, (40, 72))
    big = torch.zeros((2, 40, 80), device=card)
    with pytest.raises(ValueError, match="larger than the plane"):
        TR.fused_temporal_refine_fast(big, prev, affine, use_warp, init, 0.3, guide, pp,
                                      has_prior, knobs, alpha_lowres_hw=(40, 72))


def _two_tap_alpha(logits, hw):
    """The head-grid logits' half-pixel upsample to ``hw`` as the kernel
    computes it (each output from its two row taps, then its two column
    taps, products and sums rounded apart), then the sigmoid."""
    taps, wts = TR.lowres_taps(hw, logits.shape[-2:], logits.device)
    h = hw[0]
    r, a, c, b = taps[:h].long(), wts[:h], taps[h:].long(), wts[h:]
    u = a[:, 0, None] * logits[:, r[:, 0]] + a[:, 1, None] * logits[:, r[:, 1]]
    v = b[:, 0] * u[:, :, c[:, 0]] + b[:, 1] * u[:, :, c[:, 1]]
    return torch.sigmoid(v).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["lowres", "lanes", "lowres+lanes"])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s", [16, 96])
def test_fast_refine_kernel_at_rotation_group_sizes(card, s, form, out_dtype):
    """The three fast forms at the production rotation's group sizes (the
    logits' and the lanes' index run over the streams), 720p's 288x512
    mask, against the plain version given the kernel's own upsample
    (:func:`_two_tap_alpha`) and the reassembled lanes: new_prev and the
    f32 alpha within 2e-5, bf16 within 4e-3.  Against the plain version's
    matrix upsample (up to 1.8e-7 apart on a tenth of the pixels at S=96)
    the f32 alpha can move by 6.9e-4: the gamma's x**0.4 just above the
    noise cutoff magnifies an ulp.  The production rotation's bf16 alpha
    is held against that upsample in chip_smoke.py."""
    from video_stream_segmenetation_tpu_torch.ops.warp import separable_warp_indices
    from video_stream_segmenetation_tpu_torch.runtime.precision import pinned

    hw = (288, 512)
    logits, alpha, guide, lanes, prev, affine, use_warp, init, pp, has_prior, knobs = \
        _fast_inputs(card, s, hw, seed=s)
    lowres, use_lanes = "lowres" in form, "lanes" in form
    a_src, g_src = (logits if lowres else alpha), (lanes if use_lanes else guide)
    lhw, geom = (hw if lowres else None), ((4, 4) if use_lanes else None)
    got_prev, got = TR.fused_temporal_refine_fast(a_src, prev, affine, use_warp, init, 0.3,
                                                  g_src, pp, has_prior, knobs,
                                                  out_dtype=out_dtype, alpha_lowres_hw=lhw,
                                                  guide_lanes_geom=geom)
    yi, xi = separable_warp_indices(affine, hw)
    table = TR.scalar_table(knobs, use_warp, init, 0.3, pp, has_prior)
    with pinned():
        want_prev, want = TR.fused_temporal_refine_plain(
            _two_tap_alpha(logits, hw) if lowres else alpha, prev, yi, xi, g_src, table,
            out_dtype, None, None, geom)
    torch.cuda.synchronize()
    tol = 4e-3 if out_dtype == torch.bfloat16 else 2e-5
    assert (got_prev - want_prev).abs().max().item() <= 2e-5
    assert (got.float() - want.float()).abs().max().item() <= tol


def _round_engine(device, **over):
    eng = Engine(6, preset("fast_int8_pico", **FAST_ROUTE, **over, **SMALL), device=device)
    eng.face_min_interval_s = 0.0
    return eng


@pytest.mark.gpu
def test_dispatch_round_makes_no_host_sync(card):
    """After a priming round, the round step itself (after its ingest)
    runs under set_sync_debug_mode('error'): a .item(), a blocking copy or
    a nonzero inside the round raises."""
    import time

    from video_stream_segmenetation_tpu_torch.runtime.scheduler import StreamScheduler

    eng = _round_engine(card)
    sched = StreamScheduler(eng, group_sizes=[4, 2], fused_rounds=True)
    assert sched.pool is not None and sched.pool.num_lanes == 48
    sched.admit_all()
    g = np.random.default_rng(0)
    for _ in range(2):
        for s in range(6):
            sched.push_frame(s, g.integers(0, 256, (80, 160, 3), dtype=np.uint8))
        sched.step_round()
    sched.drain()
    offs = sched.group_offsets
    step_frames = [eng._ingest(sched._group_frames(offs[i], offs[i + 1])[0],
                               rows=offs[i + 1] - offs[i])[1] for i in range(2)]
    torch.cuda.synchronize()
    before = TR.fused_temporal_refine_fast.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = eng.round_step([4, 2], step_frames, time.monotonic())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert TR.fused_temporal_refine_fast.launches == before + 2
    assert [tuple(o["alpha"].shape) for o in outs] == [(4, 32, 64), (2, 32, 64)]
    sched.stop()


@pytest.mark.gpu
def test_pool_lanes_on_card_equal_device_gathered(card):
    """The pool's (packed, lanes) on the card equal the lanes the engine
    gathers on the card from natural frames, and a round served from each
    gives the same alpha and frames."""
    from video_stream_segmenetation_tpu_torch.runtime.native import FramePool
    from video_stream_segmenetation_tpu_torch.ops.layout import guide_s2d_sel

    g = np.random.default_rng(1)
    frames = g.integers(0, 256, (6, 80, 160, 3), dtype=np.uint8)
    pool = FramePool(6, 80, 160, s2d_block=10,
                     guide_lanes=guide_s2d_sel((80, 160), (32, 64), 10), depth=4)
    for s in range(6):
        pool.push_rgb(s, frames[s])
    outs = []
    for feed in ("pool", "natural"):
        eng = _round_engine(card)
        eng.admit_all()
        fl = []
        for i0, i1 in ((0, 4), (4, 6)):
            if feed == "pool":
                packed, _ = pool.assemble_range(i0, i1)
                fl.append((packed, pool.lanes()))
            else:
                fl.append(frames[i0:i1])
        step_in = [eng._ingest(f, rows=len(f[0]) if isinstance(f, tuple) else len(f))[1]
                   for f in fl]
        outs.append((step_in, eng.collect_round(eng.dispatch_round([4, 2], fl))))
    (pin, pout), (nin, nout) = outs
    for a, b in zip(pin, nin):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for a, b in zip(pout, nout):
        assert torch.equal(a["alpha"], b["alpha"]) and torch.equal(a["frame"], b["frame"])
    pool.close()


@pytest.mark.gpu
def test_color_background_through_the_composite_kernel(card):
    """active with use_fused_composite=True and background='color': each
    step launches the composite kernel once with the colour as a one-row
    u8 background (floor(c*255+0.5)), and the kernel equals its plain
    version on that step's inputs bit for bit."""
    from video_stream_segmenetation_tpu_torch.kernels import composite_fused as KC
    from video_stream_segmenetation_tpu_torch.runtime import pipeline
    from video_stream_segmenetation_tpu_torch.runtime.precision import pinned

    eng = Engine(2, preset("active", use_fused_composite=True, background="color",
                           face_path=False, **SMALL), device=card)
    eng.admit_all()
    kept = []
    orig = pipeline.fused_composite

    def spy(frames, alpha, bg):
        kept.append((frames.clone(), alpha.clone(), bg.clone()))
        return orig(frames, alpha, bg)

    g = np.random.default_rng(3)
    n = KC.fused_composite.launches
    pipeline.fused_composite = spy
    try:
        for _ in range(2):
            out = eng.process(g.integers(0, 256, (2, 80, 160, 3), dtype=np.uint8))
    finally:
        pipeline.fused_composite = orig
    torch.cuda.synchronize()
    assert KC.fused_composite.launches == n + 2 and not out["passthrough"]
    frames, alpha, bg = kept[-1]
    want_row = np.floor(np.asarray(eng.statics.bg_color, np.float32) * np.float32(255)
                        + np.float32(0.5)).astype(np.uint8)
    assert tuple(bg.shape) == (1, 80, 160, 3) and (bg.cpu().numpy() == want_row).all()
    with pinned():
        want = KC.fused_composite_plain(frames, alpha.float(), bg)
    assert torch.equal(KC.fused_composite(frames, alpha, bg), want)


@pytest.mark.gpu
def test_passthrough_on_the_card(card):
    """A failing step on the card serves the input frames (on the card, as
    passed) and f32 ones; three in a row degrade, the probe recovers; a
    launch the C entry point refuses is one such failure; a failed round
    restores the snapshot's cheap fields over a cold EMA."""
    from video_stream_segmenetation_tpu_torch.kernels import _build

    eng = _round_engine(card, face_path=False)
    eng.admit_all()
    g = np.random.default_rng(4)
    frames = g.integers(0, 256, (6, 80, 160, 3), dtype=np.uint8)
    assert not eng.process(frames)["passthrough"]
    step = eng._step

    def refused(*args):
        lib = _build.library()
        _build.check(lib, lib.vst_alpha_head_i8(None, None, None, None, None, 1, 1, 1, 3, 1,
                                                torch.cuda.current_stream(card).cuda_stream),
                     "alpha head")

    eng._step = refused
    for n in range(1, 4):
        out = eng.process(frames)
        assert out["passthrough"] and out["frame"].device.type == "cuda"
        assert torch.equal(out["frame"].cpu(), torch.as_tensor(frames))
        assert out["alpha"].dtype == torch.float32 and bool((out["alpha"] == 1).all())
    assert eng.health.state.value == "degraded"
    assert "invalid argument" in eng.health.last_error
    eng._step = step
    eng.health._degraded_at = 0.0
    assert not eng.process(frames)["passthrough"] and eng.health.state.value == "ok"
    # a round that fails after its first group wrote its rows
    tok = eng.dispatch_round([4, 2], [frames[:4], frames[4:]])
    eng.collect_round(tok)
    before = eng.state.frame_idx.clone()
    eng._dispatches = 0

    def fails(group_sizes):
        def rs(full_state, frames_list, bgs, knobs, face_last, now, mi):
            eng._range_step(full_state, 0, frames_list[0], bgs, knobs, face_last, now, mi, 4)
            raise RuntimeError("injected failure in the second group")
        return rs

    eng._round_step_for = fails
    try:
        outs = eng.collect_round(eng.dispatch_round([4, 2], [frames[:4], frames[4:]]))
    finally:
        del eng._round_step_for
    assert [o["passthrough"] for o in outs] == [True, True]
    assert torch.equal(eng.state.frame_idx, before)
    assert not bool(eng.state.prev_alpha.any()) and not bool(eng.state.initialized.any())
    outs = eng.collect_round(eng.dispatch_round([4, 2], [frames[:4], frames[4:]]))
    assert not any(o["passthrough"] for o in outs)
