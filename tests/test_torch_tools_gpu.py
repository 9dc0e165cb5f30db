"""The EMA gate and the parity tools on the card (no JAX: the card's machine
runs these with ``-m gpu --noconftest``).

Marked ``gpu``: without a card each test skips.  Bars: the refine forms at
a moved gate bit for bit with their plain versions (the forms fed head-grid
logits within their default-gate tolerances, 2e-5 and one bf16 step: the
kernel's two-tap upsample against the plain version's products);
parity_check card against CPU every frame at least 0.99 (720p) and the
synthetic mean within 0.02; face_parity's bars of chip_smoke.py's tools
phase.
"""

import json

import numpy as np
import pytest
import torch

from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch import face_parity as FP
from video_stream_segmenetation_tpu_torch import parity_check as PC
from video_stream_segmenetation_tpu_torch.kernels import refine_fused as TR
from video_stream_segmenetation_tpu_torch.ops.prior import prior_plane_from_params
from video_stream_segmenetation_tpu_torch.ops.warp import separable_warp_indices
from video_stream_segmenetation_tpu_torch.runtime.config import default_knobs, ema_gate_at
from video_stream_segmenetation_tpu_torch.runtime.precision import pinned

pytestmark = pytest.mark.gpu

S, H, W = 6, 72, 128
MOVED = (0.05, 0.25)  # t0, t1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _inputs(dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    alpha = torch.rand((S, H, W), generator=gen, device=dev)
    prev = torch.rand((S, H, W), generator=gen, device=dev)
    guide = torch.randint(0, 256, (S, 3, H, W), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    logits = (torch.rand((S, H // 4, W // 4), generator=gen, device=dev) - 0.5) * 8.0
    i = torch.arange(S, device=dev, dtype=torch.float32)
    affine = torch.stack([1.0 + 0.01 * i, 0 * i, 2.0 - i, 0 * i, 0.99 + 0.01 * i, i - 2.0], 1)
    init = (torch.arange(S, device=dev) % 3) != 0
    use_warp = ((torch.arange(S, device=dev) % 2) == 0) & init
    has_prior = (torch.arange(S, device=dev) % 2) == 1
    pp = torch.stack([60.0 + i, 30.0 + i, 20.0 + 0 * i, 16.0 + 0 * i], 1)
    knobs = default_knobs(S, ema_adapt=1.0, device=dev)
    return alpha, prev, guide, logits, affine, init, use_warp, has_prior, pp, knobs


def test_refine_forms_at_a_moved_gate_match_plain(card):
    alpha, prev, guide, logits, affine, init, use_warp, has_prior, pp, knobs = _inputs(card)
    yi, xi = separable_warp_indices(affine, (H, W))
    lanes = guide.reshape(S, 3, H // 4, 4, W // 4, 4).permute(1, 3, 5, 0, 2, 4) \
        .reshape(48, S, H // 4, W // 4).contiguous()
    plane = torch.where(has_prior[:, None, None], prior_plane_from_params(pp, (H, W)),
                        torch.zeros((), device=card)).contiguous()
    zeros = torch.zeros_like(pp)

    table = TR.scalar_table(knobs, use_warp, init, 0.3, pp, has_prior)
    table_z = TR.scalar_table(knobs, use_warp, init, 0.3, zeros, has_prior)

    cases = [
        (lambda: TR.fused_temporal_refine(alpha, prev, affine, use_warp, init, 0.3, guide,
                                          pp, has_prior, knobs),
         lambda: TR.fused_temporal_refine_plain(alpha, prev, yi, xi, guide, table),
         0, 0),
        (lambda: TR.fused_temporal_refine_plane(alpha, prev, affine, use_warp, init, 0.3,
                                                guide, plane, has_prior, knobs,
                                                out_dtype=torch.float32),
         lambda: TR.fused_temporal_refine_plain(alpha, prev, yi, xi, guide, table_z,
                                                torch.float32, plane), 0, 0),
        (lambda: TR.fused_temporal_refine_fast(alpha, prev, affine, use_warp, init, 0.3,
                                               lanes, pp, has_prior, knobs,
                                               guide_lanes_geom=(4, 4)),
         lambda: TR.fused_temporal_refine_plain(alpha, prev, yi, xi, lanes, table,
                                                torch.bfloat16, None, None, (4, 4)),
         0, 0),
        (lambda: TR.fused_temporal_refine_fast(logits, prev, affine, use_warp, init, 0.3,
                                               guide, pp, has_prior, knobs,
                                               alpha_lowres_hw=(H, W)),
         lambda: TR.fused_temporal_refine_plain(logits, prev, yi, xi, guide, table,
                                                torch.bfloat16, None, (H, W)),
         2e-5, 4e-3),
    ]
    for kernel, plain, prev_tol, tol in cases:
        with ema_gate_at(*MOVED):
            got_prev, got = kernel()
            with pinned():
                want_prev, want = plain()
        with pinned():
            at_default = plain()[1]
        assert (got_prev - want_prev).abs().max().item() <= prev_tol
        assert (got.float() - want.float()).abs().max().item() <= tol
        assert (want.float() - at_default.float()).abs().max().item() > 0


def test_parity_check_on_the_card_matches_the_cpu(card, tmp_path):
    frames, gt = bridge.load_frames()
    clip = tmp_path / "clip.npz"
    np.savez(clip, frames=frames, masks=gt.astype(np.float32) / 255.0)
    assert PC.main(["--clip", str(clip), "--device", "cpu", "--save-masks",
                    str(tmp_path / "cpu.npz")]) in (0, 1)
    rep = tmp_path / "card.json"
    assert PC.main(["--clip", str(clip), "--ref", str(tmp_path / "cpu.npz"),
                    "--report", str(rep)]) == 0
    assert json.loads(rep.read_text())["iou_min"] >= 0.99
    cpu = PC.run(PC.parse_args(["--synthetic", "--frames", "4", "--device", "cpu"]))
    got = PC.run(PC.parse_args(["--synthetic", "--frames", "4"]))
    assert abs(got["iou_mean"] - cpu["iou_mean"]) <= 0.02


def test_face_parity_on_the_card(card):
    rep = FP.report(card, n_decode=8, n_student=8)
    assert all(v["max_rel"] <= 1e-4 for outs in rep["port_fidelity"].values()
               for v in outs.values())
    dc, bn = rep["decode_consistency"], rep["blaze_nms"]
    assert dc["best_anchor_agreement"] == 1.0 and dc["box_iou_torch_vs_numpy_min"] >= 0.9999
    assert bn["selected_count_match"] and bn["max_abs_diff"] <= 1e-6
