"""The fused temporal refine's bench-only debug variants ('no_morph': stages
5 and 7 skipped; 'no_bilateral': stage 8 skipped; both): the plain version
of each form (analytic prior, plane prior, the fast form from head-grid
logits and tap lanes) against the reference's Pallas kernel with the same
``debug`` in interpret mode (tests/test_torch_refine_fast.py's inputs,
S=4, 32x64); an unknown token refused on the CPU as on the card; and the
tokens through the step on fast_int8_pico (tests/torch_rollout_engines.py
::step_both, one step from the reference engine's state, face off).

Tolerances (tests/test_torch_refine.py's): new_prev within 2e-5, the
refined alpha within 4e-3 in bf16 and 2e-5 in f32; the step at
tests/torch_rollout_engines.py::STEP_BARS.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_rollout_engines as RE
from tests.test_torch_refine_fast import (
    EMA_ADAPT,
    FX,
    FY,
    H,
    PRIOR,
    S,
    W,
    inputs,
    port_knobs,
    to_lanes,
)
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu import runtime
from video_stream_segmenetation_tpu.kernels.refine_fused import fused_temporal_refine as jax_refine
from video_stream_segmenetation_tpu_torch.kernels import refine_fused as TR

DEBUGS = (("no_morph",), ("no_bilateral",), ("no_morph", "no_bilateral"))
FORMS = ("analytic", "plane", "lowres+lanes")


def _plane(rng):
    """A prior plane: values in (0, 1] on about half the pixels."""
    p = rng.random((S, H, W), dtype=np.float32)
    return np.where(rng.random((S, H, W)) > 0.5, p, 0.0).astype(np.float32)


@pytest.mark.parametrize("out", ["bf16", "f32"])
@pytest.mark.parametrize("debug", DEBUGS, ids=",".join)
@pytest.mark.parametrize("form", FORMS)
def test_plain_debug_variant_matches_pallas(rng, form, debug, out):
    d = inputs(rng, "warp_prior_mixed")
    plane = _plane(rng) if form == "plane" else None
    fast = form == "lowres+lanes"
    k = runtime.default_knobs(S)
    want_prev, want = jax_refine(
        jnp.asarray(d["logits"] if fast else d["alpha"]), jnp.asarray(d["prev"]),
        jnp.asarray(d["affine"]), jnp.asarray(d["use_warp"]), jnp.asarray(d["init"]), 0.3,
        jnp.asarray(to_lanes(d["guide"]) if fast else d["guide"]),
        None if plane is None else jnp.asarray(plane), k.ema, k.noise_cutoff,
        k.high_threshold, k.gamma, jnp.asarray(d["use_bi"]), k.sigma_spatial, k.sigma_range,
        jnp.asarray(d["has_prior"]), knobs_ema_adapt=jnp.asarray(EMA_ADAPT), interpret=True,
        guide_planar=not fast, debug=debug,
        prior_params=None if plane is not None else jnp.asarray(PRIOR),
        alpha_lowres_hw=(H, W) if fast else None, guide_lanes_geom=(FY, FX) if fast else None,
        out_dtype=jnp.bfloat16 if out == "bf16" else None)
    dt = torch.bfloat16 if out == "bf16" else torch.float32
    args = (torch.as_tensor(d["prev"]), torch.as_tensor(d["affine"]),
            torch.as_tensor(d["use_warp"]), torch.as_tensor(d["init"]), 0.3)
    if form == "analytic":
        got_prev, got = TR.fused_temporal_refine(
            torch.as_tensor(d["alpha"]), *args, torch.as_tensor(d["guide"]),
            torch.as_tensor(PRIOR), torch.as_tensor(d["has_prior"]), port_knobs(d),
            out_dtype=dt, debug=debug)
    elif form == "plane":
        got_prev, got = TR.fused_temporal_refine_plane(
            torch.as_tensor(d["alpha"]), *args, torch.as_tensor(d["guide"]),
            torch.as_tensor(plane), torch.as_tensor(d["has_prior"]), port_knobs(d),
            out_dtype=dt, debug=debug)
    else:
        got_prev, got = TR.fused_temporal_refine_fast(
            torch.as_tensor(d["logits"]), *args, torch.as_tensor(to_lanes(d["guide"])),
            torch.as_tensor(PRIOR), torch.as_tensor(d["has_prior"]), port_knobs(d),
            out_dtype=dt, alpha_lowres_hw=(H, W), guide_lanes_geom=(FY, FX), debug=debug)
    assert got.dtype == dt and got_prev.dtype == torch.float32
    np.testing.assert_allclose(got_prev.numpy(), np.asarray(want_prev), rtol=0, atol=2e-5)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=0,
                               atol=4e-3 if out == "bf16" else 2e-5)


def test_variants_change_the_output(rng):
    """Each variant computes something else than the serving form (the
    stages it skips do work on these inputs)."""
    d = inputs(rng, "warp_prior_mixed")
    outs = {}
    for debug in ((), *DEBUGS):
        _, outs[debug] = TR.fused_temporal_refine(
            torch.as_tensor(d["alpha"]), torch.as_tensor(d["prev"]),
            torch.as_tensor(d["affine"]), torch.as_tensor(d["use_warp"]),
            torch.as_tensor(d["init"]), 0.3, torch.as_tensor(d["guide"]),
            torch.as_tensor(PRIOR), torch.as_tensor(d["has_prior"]), port_knobs(d),
            out_dtype=torch.float32, debug=debug)
    for debug in DEBUGS:
        assert not torch.equal(outs[debug], outs[()]), debug
    assert TR.debug_bits(("no_morph", "no_bilateral")) == 3 and TR.debug_bits(()) == 0


def test_unknown_debug_token_raises(rng):
    d = inputs(rng, "cold_start")
    with pytest.raises(ValueError, match="unknown debug token 'no_opening'"):
        TR.fused_temporal_refine(
            torch.as_tensor(d["alpha"]), torch.as_tensor(d["prev"]),
            torch.as_tensor(d["affine"]), torch.as_tensor(d["use_warp"]),
            torch.as_tensor(d["init"]), 0.3, torch.as_tensor(d["guide"]),
            torch.as_tensor(PRIOR), torch.as_tensor(d["has_prior"]), port_knobs(d),
            debug=("no_opening",))


@pytest.fixture(scope="module")
def pairs():
    return {}


@pytest.mark.parametrize("debug_stage", ["no_morph", "no_bilateral", "no_morph,no_bilateral"])
def test_refine_tokens_through_the_step(pairs, debug_stage):
    jres, tres, fj = RE.step_both(RE.pair(pairs, "pico"), "pico", debug_stage)
    RE.assert_step_matches(jres, tres, fj, "pico", debug_stage)
