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
                                  TK.fused_nano_trunk_alpha_plain(x0, tp).numpy())
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
    want = TK.fused_nano_trunk_alpha_plain(x0, tp)
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
