"""The kernels on the serving options of the float MatteNetHD and the
upsample and warp, on the card: the composite kernel at each upsample
method's taps, fused_refine on the s2d exact-warp route's inputs, and the
float MatteNetHD's engines on the card with their kernel launches.  Marked
``gpu``: without a card each test skips.  The machine with the card has no
JAX, so this file imports none; run it there with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_options_gpu.py -q

Tolerances: the composite kernel equals its plain version bit for bit (its
design: f64 two-tap row sums, exact bf16 products, the same blend);
fused_refine within 2e-5 of its plain version (exp/pow ulps, as
tests/test_torch_gpu.py holds it).
"""

import numpy as np
import pytest
import torch

from video_stream_segmenetation_tpu_torch.kernels import composite_fused as KC
from video_stream_segmenetation_tpu_torch.kernels import refine_fused as TR
from video_stream_segmenetation_tpu_torch.kernels import trunk_int8 as TK
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import MatteNetHD
from video_stream_segmenetation_tpu_torch.runtime import pipeline
from video_stream_segmenetation_tpu_torch.runtime.presets import preset
from video_stream_segmenetation_tpu_torch.service.engine import Engine

METHODS = ("half_pixel", "asymmetric", "align_corners")
GEOM = dict(frame_hw=(160, 320), mask_hw=(64, 128), fd_size=128, lmk_size=128)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _composite_case(device, s, h, w, mh, mw):
    g = np.random.default_rng(11)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    frames = t(g.integers(0, 256, (s, h, w, 3), dtype=np.uint8))
    bg = t(g.integers(0, 256, (s, h, w, 3), dtype=np.uint8))
    alpha = t(g.random((s, mh, mw), dtype=np.float32))
    alpha[0, : mh // 4] = 0.0
    alpha[-1, -(mh // 4):] = 1.0
    return frames, alpha, bg


@pytest.mark.gpu
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("s,h,w,mh,mw", [(2, 720, 1280, 288, 512), (3, 50, 70, 21, 33)],
                         ids=["720p", "ragged"])
def test_composite_kernel_matches_plain_at_each_method(card, method, s, h, w, mh, mw):
    from video_stream_segmenetation_tpu_torch.runtime.precision import pinned

    frames, alpha, bg = _composite_case(card, s, h, w, mh, mw)
    n = KC.fused_composite.launches
    got = KC.fused_composite(frames, alpha, bg, method=method)
    with pinned():
        want = KC.fused_composite_plain(frames, alpha, bg, method)
    torch.cuda.synchronize()
    assert KC.fused_composite.launches == n + 1
    assert got.dtype == torch.uint8 and torch.equal(got, want)


def test_cpu_composite_at_each_method_takes_the_plain_version():
    """On the CPU the wrapper is its plain version at every method and
    counts no launch."""
    frames, alpha, bg = _composite_case("cpu", 2, 80, 160, 32, 64)
    n = KC.fused_composite.launches
    for method in METHODS:
        assert torch.equal(KC.fused_composite(frames, alpha, bg, method=method),
                           KC.fused_composite_plain(frames, alpha, bg, method))
    assert KC.fused_composite.launches == n


@pytest.mark.gpu
def test_fused_refine_on_the_s2d_exact_warp_route(card, monkeypatch):
    """fast_int8_pico with the exact warp on the card (seeded weights,
    160x320): the trunk and fused_refine once a step, no temporal-refine
    kernel; fused_refine held against its plain version on the inputs the
    step gave it (the planar u8 guide off the packed frames)."""
    held = []
    orig = pipeline.fused_refine

    def rec(alpha, guide, prior, has_prior, knobs):
        held.append((alpha.clone(), guide.clone(), prior.clone(), has_prior.clone(), knobs))
        return orig(alpha, guide, prior, has_prior, knobs)

    monkeypatch.setattr(pipeline, "fused_refine", rec)
    eng = Engine(2, preset("fast_int8_pico", warp_impl="exact", upsample_precision="exact",
                           upsample_method="align_corners", **GEOM), seed=0)
    eng.admit_all()
    frames = np.random.default_rng(0).integers(0, 256, (2, 160, 320, 3), dtype=np.uint8)
    n = (TK.fused_nano_trunk_alpha.launches, TR.fused_refine.launches,
         TR.fused_temporal_refine.launches)
    for _ in range(2):
        out = eng.process(frames)
    assert (TK.fused_nano_trunk_alpha.launches - n[0], TR.fused_refine.launches - n[1],
            TR.fused_temporal_refine.launches - n[2]) == (2, 2, 0)
    assert not out["passthrough"] and out["alpha"].dtype == torch.float32
    alpha, guide, plane, has_prior, knobs = held[-1]
    assert guide.dtype == torch.uint8 and tuple(guide.shape) == (2, 3, 64, 128)
    got = TR.fused_refine(alpha, guide, plane, has_prior, knobs)
    want = TR.fused_refine_plain(alpha, guide, plane, TR.refine_table(knobs, has_prior))
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 2e-5


@pytest.mark.gpu
@pytest.mark.parametrize("name,over,refines,k", [
    ("fast", {"frame_layout": "s2d"}, 1, 1),
    ("fast_int8", {"matting_precision": "bf16"}, 1, 1),
    ("multiclass_fast_pico", {"matting_precision": "bf16", "mask_hw": (16, 32)}, 0, 4)],
    ids=["plan_a_s2d", "plan_b_s2d", "k4_pico_s2d"])
def test_float_hd_engines_on_card(card, name, over, refines, k):
    """The float MatteNetHD over packed frames on the card (seeded): the
    refine kernel once a step on the single-class routes, no trunk kernel;
    the maps finite, on the simplex with K classes."""
    eng = Engine(2, preset(name, **{**GEOM, **over}), seed=0)
    assert isinstance(eng.model, MatteNetHD) and eng.model.num_classes == k
    eng.admit_all()
    frames = np.random.default_rng(1).integers(0, 256, (2, 160, 320, 3), dtype=np.uint8)
    n = (TR.fused_temporal_refine.launches, TK.fused_nano_trunk_alpha.launches)
    for _ in range(2):
        out = eng.process(frames)
    assert (TR.fused_temporal_refine.launches - n[0],
            TK.fused_nano_trunk_alpha.launches - n[1]) == (2 * refines, 0)
    assert not out["passthrough"] and bool(torch.isfinite(out["alpha"]).all())
    if k > 1:
        assert (out["class_alpha"].sum(-1) - 1.0).abs().max().item() <= 1e-3
