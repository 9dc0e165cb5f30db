"""On the card: the refine kernel's debug variants against their plain
versions, and the step and round rollouts against the sequential steps
and rounds they chain.  Marked ``gpu``: without a card each test skips.
The machine with the card has no JAX, so this file imports none; run it
there with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_rollout_gpu.py -q

Tolerances: the debug variants as tests/test_torch_gpu.py holds each form
(new_prev 2e-5; the refined alpha 4e-3 in bf16, 2e-5 in f32; the lanes
form from the full alpha exact); the rollouts bit for bit (the same
kernels and library calls on the same inputs in the same order).
"""

import numpy as np
import pytest
import torch

from tests.test_torch_gpu import _fast_inputs, _plane
from video_stream_segmenetation_tpu_torch.kernels import refine_fused as TR
from video_stream_segmenetation_tpu_torch.runtime import make_round_rollout, make_step_rollout
from video_stream_segmenetation_tpu_torch.runtime import rollout as RO
from video_stream_segmenetation_tpu_torch.runtime.pipeline import make_round_step, make_step
from video_stream_segmenetation_tpu_torch.runtime.presets import preset
from video_stream_segmenetation_tpu_torch.runtime.state import map_state
from video_stream_segmenetation_tpu_torch.service.engine import Engine

DEBUGS = (("no_morph",), ("no_bilateral",), ("no_morph", "no_bilateral"))
GEOM = dict(frame_hw=(80, 160), mask_hw=(32, 64), fd_size=64, lmk_size=48)
FAST = dict(refine_alpha_src="lowres", guide_kernel_unfold=True, guide_source="host")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("debug", DEBUGS, ids=",".join)
@pytest.mark.parametrize("form", ["analytic-bf16", "analytic-f32", "plane", "lanes",
                                  "lowres+lanes"])
def test_debug_variant_matches_plain(card, form, debug):
    """Each form's debug variant at a plane of ragged strips and segments
    (148 x 200), held against the plain version with the same tokens; a
    launch counts in the form's own wrapper."""
    from video_stream_segmenetation_tpu_torch.ops.warp import separable_warp_indices
    from video_stream_segmenetation_tpu_torch.runtime.precision import pinned

    hw = (148, 200)
    logits, alpha, guide, lanes, prev, affine, use_warp, init, pp, has_prior, knobs = \
        _fast_inputs(card, 3, hw, seed=5)
    pp = pp * torch.tensor([5.0, 6.0, 3.0, 3.0], device=card)
    yi, xi = separable_warp_indices(affine, hw)
    f32, bf16 = torch.float32, torch.bfloat16
    table = TR.scalar_table(knobs, use_warp, init, 0.3, pp, has_prior)
    if form == "plane":
        plane = _plane(pp, has_prior, hw)
        wrapper = TR.fused_temporal_refine_plane
        before = wrapper.launches
        got_prev, got = wrapper(alpha, prev, affine, use_warp, init, 0.3, guide, plane,
                                has_prior, knobs, out_dtype=f32, debug=debug)
        ztable = TR.scalar_table(knobs, use_warp, init, 0.3, torch.zeros_like(pp), has_prior)
        want_prev, want = TR.fused_temporal_refine_plain(alpha, prev, yi, xi, guide, ztable,
                                                         f32, plane, debug=debug)
        tol = 2e-5
    elif form.startswith("analytic"):
        out_dtype = bf16 if form.endswith("bf16") else f32
        wrapper = TR.fused_temporal_refine
        before = wrapper.launches
        got_prev, got = wrapper(alpha, prev, affine, use_warp, init, 0.3, guide, pp, has_prior,
                                knobs, out_dtype=out_dtype, debug=debug)
        want_prev, want = TR.fused_temporal_refine_plain(alpha, prev, yi, xi, guide, table,
                                                         out_dtype, debug=debug)
        tol = 4e-3 if out_dtype == bf16 else 2e-5
    else:
        lowres = form == "lowres+lanes"
        a_src, lhw = (logits, hw) if lowres else (alpha, None)
        wrapper = TR.fused_temporal_refine_fast
        before = wrapper.launches
        got_prev, got = wrapper(a_src, prev, affine, use_warp, init, 0.3, lanes, pp, has_prior,
                                knobs, alpha_lowres_hw=lhw, guide_lanes_geom=(4, 4),
                                debug=debug)
        with pinned():
            want_prev, want = TR.fused_temporal_refine_plain(a_src, prev, yi, xi, lanes, table,
                                                             bf16, None, lhw, (4, 4), debug)
        tol = 4e-3 if lowres else 0
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert (got_prev - want_prev).abs().max().item() <= (2e-5 if tol else 0)
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.gpu
def test_debug_variant_refuses_an_unknown_token(card):
    logits, alpha, guide, lanes, prev, affine, use_warp, init, pp, has_prior, knobs = \
        _fast_inputs(card, 2, (32, 64))
    with pytest.raises(ValueError, match="unknown debug token"):
        TR.fused_temporal_refine(alpha, prev, affine, use_warp, init, 0.3, guide, pp,
                                 has_prior, knobs, debug=("no_warp",))


def _engine(card, over):
    e = Engine(4, preset("fast_int8_pico", **GEOM, **over), device=card)
    e.face_min_interval_s = 0.0
    e.admit_all()
    g = np.random.default_rng(0)
    frames = g.integers(0, 256, (4, 80, 160, 3), dtype=np.uint8)
    e.process(frames)
    return e, e._ingest(frames[::-1].copy())[1][0]


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["preset", "fast"])
def test_step_rollout_equals_sequential_steps(card, route):
    e, frames = _engine(card, FAST if route == "fast" else {})
    gate = torch.ones((4,), dtype=torch.bool, device=card)
    n = 4
    before = {w: w.launches for w in (TR.fused_temporal_refine, TR.fused_temporal_refine_fast)}
    st_r, af, aa = make_step_rollout(e.model, e.statics, e.face_models)(
        e.state, frames, e.backgrounds, e.knobs, gate, n)
    counted = {w: w.launches - before[w] for w in before}
    step = make_step(e.model, e.statics, e.face_models)
    st, ef, ea = e.state, None, None
    from video_stream_segmenetation_tpu_torch.runtime.precision import pinned

    with pinned():
        for i in range(n):
            st, out = step(st, frames if i == 0 else RO._perturb(frames, i), e.backgrounds,
                           e.knobs, gate)
            ef = out["frame"] if ef is None else ef + out["frame"]
            ea = out["alpha"] if ea is None else ea + out["alpha"]
    torch.cuda.synchronize()
    assert torch.equal(af, ef) and torch.equal(aa, ea)
    assert torch.equal(st_r.prev_alpha, st.prev_alpha)
    wrapper = TR.fused_temporal_refine_fast if route == "fast" else TR.fused_temporal_refine
    assert counted[wrapper] == n


@pytest.mark.gpu
def test_round_rollout_equals_sequential_rounds_without_a_sync(card):
    """n rounds of the fast route in groups [3, 1] under
    set_sync_debug_mode('error'), against the sequential round steps."""
    from video_stream_segmenetation_tpu_torch.runtime.precision import pinned

    e, frames = _engine(card, FAST)
    sizes, n = [3, 1], 3
    fp, lanes = frames
    groups = [(fp[:3].contiguous(), lanes[:, :3].contiguous()),
              (fp[3:].contiguous(), lanes[:, 3:].contiguous())]

    def clock():
        return (torch.full((4,), -1e9, device=card), torch.full((), 5.0, device=card),
                torch.full((), 0.1, device=card))

    roll = make_round_rollout(e.model, e.statics, sizes, e.face_models)
    st_r = map_state(torch.clone, e.state)
    last_r, now0, mi = clock()
    roll(st_r, groups, e.backgrounds, e.knobs, last_r, now0, mi, 1)  # warm
    st_r = map_state(torch.clone, e.state)
    last_r = clock()[0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, last_r, accs = roll(st_r, groups, e.backgrounds, e.knobs, last_r, now0, mi, n)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    rstep = make_round_step(e.model, e.statics, sizes, e.face_models)
    st, last = map_state(torch.clone, e.state), clock()[0]
    exp = None
    with pinned():
        for i in range(n):
            now = now0 + float(np.float32(i) * np.float32(1.0 / 30.0))
            fl = groups if i == 0 else [RO._perturb(f, i) for f in groups]
            st, last, outs = rstep(st, fl, e.backgrounds, e.knobs, last, now, mi)
            got = [(o["frame"], o["alpha"]) for o in outs]
            exp = got if exp is None else [(a + f, b + al) for (a, b), (f, al) in zip(exp, got)]
    torch.cuda.synchronize()
    for (af, aa), (ef, ea) in zip(accs, exp):
        assert torch.equal(af, ef) and torch.equal(aa, ea)
    assert torch.equal(st_r.prev_alpha, st.prev_alpha)
