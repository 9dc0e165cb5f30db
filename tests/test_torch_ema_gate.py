"""The motion-adaptive EMA's gate (runtime/config.py ``EMA_ADAPT_T0/T1``)
as an input of the step, as the reference reads it when it traces one: the
port's refine plain versions (analytic, plane, fast; the exact-warp route's
EMA before ``fused_refine``) and ops/temporal.py against the reference's
interpret-mode kernels and XLA twins with the gate moved on both sides; at
the default gate, bit for bit what the port computed with the gate fixed
in its code; a step served after the gate moves follows it, and serves the
default gate again once the gate is put back.

Tolerances are those of the existing tests of the same functions
(tests/test_torch_refine.py, test_torch_refine_fast.py, test_torch_active.py,
test_torch_ops.py): new_prev and f32 alphas within 2e-5, bf16 alphas
within 4e-3, temporal_ema within 1e-6.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_refine_fast import CASES, EMA_ADAPT, FORMS, PRIOR, inputs, run_port, to_lanes
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu import ops as J
from video_stream_segmenetation_tpu import runtime
from video_stream_segmenetation_tpu.kernels import refine_fused as JR
from video_stream_segmenetation_tpu.ops.prior import prior_plane_from_params
from video_stream_segmenetation_tpu.runtime import config as JC
from video_stream_segmenetation_tpu_torch.kernels import refine_fused as TR
from video_stream_segmenetation_tpu_torch.ops import temporal as TT
from video_stream_segmenetation_tpu_torch.runtime import config as TC
from video_stream_segmenetation_tpu_torch.runtime.presets import preset
from video_stream_segmenetation_tpu_torch.service.engine import Engine

S, H, W = 4, 32, 64
MOVED = (0.05, 0.25)  # t0, t1
DEFAULT = (0.10, 0.40)


def T(a):
    return torch.as_tensor(np.array(a))


def set_gate(t0, t1):
    """Both packages' gate; the JAX caches cleared so that no trace keeps
    the other gate."""
    JC.EMA_ADAPT_T0, JC.EMA_ADAPT_T1 = t0, t1
    TC.EMA_ADAPT_T0, TC.EMA_ADAPT_T1 = t0, t1
    jax.clear_caches()


@pytest.fixture
def moved_gate():
    saved = (JC.EMA_ADAPT_T0, JC.EMA_ADAPT_T1)
    assert saved == (TC.EMA_ADAPT_T0, TC.EMA_ADAPT_T1) == DEFAULT
    set_gate(*MOVED)
    yield
    set_gate(*saved)


def jax_refine(d, lowres=False, lanes=False, out=jnp.bfloat16, prior=PRIOR):
    k = runtime.default_knobs(S)
    return JR.fused_temporal_refine(
        jnp.asarray(d["logits"] if lowres else d["alpha"]), jnp.asarray(d["prev"]),
        jnp.asarray(d["affine"]), jnp.asarray(d["use_warp"]), jnp.asarray(d["init"]), 0.3,
        jnp.asarray(to_lanes(d["guide"]) if lanes else d["guide"]),
        None if prior is PRIOR else jnp.asarray(prior), k.ema, k.noise_cutoff,
        k.high_threshold, k.gamma, jnp.asarray(d["use_bi"]), k.sigma_spatial, k.sigma_range,
        jnp.asarray(d["has_prior"]), knobs_ema_adapt=jnp.asarray(EMA_ADAPT), interpret=True,
        guide_planar=not lanes, prior_params=jnp.asarray(PRIOR) if prior is PRIOR else None,
        alpha_lowres_hw=(H, W) if lowres else None,
        guide_lanes_geom=(4, 4) if lanes else None, out_dtype=out)


def held(got, want, bf16):
    got_prev, got_a = got
    want_prev, want_a = want
    np.testing.assert_allclose(got_prev.numpy(), np.asarray(want_prev), rtol=0, atol=2e-5)
    np.testing.assert_allclose(got_a.float().numpy(), np.asarray(want_a, np.float32), rtol=0,
                               atol=4e-3 if bf16 else 2e-5)


def moved_apart(moved, at_default):
    """The moved gate's new_prev departs from the default gate's (the gate
    is live) by far more than the bars."""
    assert float((moved[0] - at_default[0]).abs().max()) > 0.05


@pytest.mark.parametrize("case", sorted(CASES))
def test_analytic_refine_follows_a_moved_gate(rng, moved_gate, case):
    d = inputs(rng, case)
    got = run_port(d, False, False, torch.bfloat16)
    held(got, jax_refine(d), True)
    if case != "cold_start":
        tk = TC.default_knobs(S)
        tk.ema_adapt = T(EMA_ADAPT)
        table = TR.scalar_table(tk, T(d["use_warp"]), T(d["init"]), 0.3, T(PRIOR),
                                T(d["has_prior"]))
        with TC.ema_gate_at(*DEFAULT):
            at_default = TR.fused_temporal_refine_plain(
                T(d["alpha"]), T(d["prev"]), *TR.separable_warp_indices(T(d["affine"]), (H, W)),
                T(d["guide"]), table)
        moved_apart(got, at_default)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_fast_refine_follows_a_moved_gate(rng, moved_gate, form):
    lowres, lanes = FORMS[form]
    d = inputs(rng, "warp_prior_mixed")
    held(run_port(d, lowres, lanes, torch.bfloat16), jax_refine(d, lowres, lanes), True)


@pytest.mark.parametrize("out", ["bf16", "f32"])
def test_plane_refine_follows_a_moved_gate(rng, moved_gate, out):
    d = inputs(rng, "warp_prior_mixed")
    plane = np.where(d["has_prior"][:, None, None], _plane(), 0.0).astype(np.float32)
    tk = TC.default_knobs(S)
    tk.use_bilateral, tk.ema_adapt = T(d["use_bi"]), T(EMA_ADAPT)
    dt = torch.bfloat16 if out == "bf16" else torch.float32
    got = TR.fused_temporal_refine_plane(
        T(d["alpha"]), T(d["prev"]), T(d["affine"]), T(d["use_warp"]), T(d["init"]), 0.3,
        T(d["guide"]), T(plane), T(d["has_prior"]), tk, out_dtype=dt)
    held(got, jax_refine(d, out=jnp.bfloat16 if out == "bf16" else None, prior=plane),
         out == "bf16")


def _plane():
    """The prior plane of PRIOR's ellipses ``[S, H, W]`` (the reference's)."""
    p = jnp.asarray(PRIOR)
    return np.asarray(prior_plane_from_params(*(p[:, i, None, None] for i in range(4)), (H, W)),
                      np.float32)


def test_exact_warp_route_follows_a_moved_gate(rng, moved_gate):
    """``warp_impl='exact'``: the EMA in ops/temporal.py, then fused_refine
    (which reads no gate) on what it gives, against the reference's
    temporal_ema and fused_refine."""
    d = inputs(rng, "warp_prior_mixed")
    ema, init = np.asarray([0.55, 0.7, 0.3, 0.55], np.float32), d["init"]
    got_prev, got_a = TT.temporal_ema(T(d["prev"]), T(d["alpha"]), T(ema), T(init),
                                      adapt=T(EMA_ADAPT))
    want_prev, want_a = J.temporal_ema(jnp.asarray(d["prev"]), jnp.asarray(d["alpha"]),
                                       jnp.asarray(ema), jnp.asarray(init),
                                       adapt=jnp.asarray(EMA_ADAPT))
    np.testing.assert_allclose(got_prev.numpy(), np.asarray(want_prev), rtol=0, atol=1e-6)
    plane = _plane()
    tk = TC.default_knobs(S)
    tk.use_bilateral = T(d["use_bi"])
    got = TR.fused_refine(got_a.contiguous(), T(d["guide"]), T(plane), T(d["has_prior"]), tk)
    k = runtime.default_knobs(S)
    want = JR.fused_refine(want_a, jnp.asarray(d["guide"].transpose(0, 2, 3, 1), jnp.float32),
                           jnp.asarray(plane), k.noise_cutoff, k.high_threshold, k.gamma,
                           jnp.asarray(d["use_bi"]), k.sigma_spatial, k.sigma_range,
                           jnp.asarray(d["has_prior"]), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)
    with TC.ema_gate_at(*DEFAULT):
        at_default = TT.temporal_ema(T(d["prev"]), T(d["alpha"]), T(ema), T(init),
                                     adapt=T(EMA_ADAPT))
    moved_apart((got_prev,), at_default)


def test_simplex_ema_follows_a_moved_gate(rng, moved_gate):
    """The multi-class steps' EMA on the class simplex against the
    reference's expression (runtime/pipeline.py:384-400), written out in
    jax.numpy with the moved gate read from its runtime/config.py."""
    from video_stream_segmenetation_tpu_torch.runtime.pipeline import simplex_ema

    ca, prev = rng.random((2, S, 8, 16, 4), dtype=np.float32)
    ca /= ca.sum(-1, keepdims=True)
    prev /= prev.sum(-1, keepdims=True)
    init = np.asarray([True, True, False, True])
    tk = TC.default_knobs(S)
    tk.ema_adapt = T(EMA_ADAPT)
    got = simplex_ema(T(ca), T(prev), tk, T(init))
    kk = jnp.asarray(tk.ema.numpy())[:, None, None, None]
    ad = jnp.asarray(EMA_ADAPT)[:, None, None, None]
    m = jnp.clip((jnp.max(jnp.abs(ca - prev), axis=-1, keepdims=True) - JC.EMA_ADAPT_T0)
                 * (1.0 / (JC.EMA_ADAPT_T1 - JC.EMA_ADAPT_T0)), 0.0, 1.0)
    ke = kk * (1.0 - ad * m)
    b = jnp.where(jnp.asarray(init)[:, None, None, None], ke * prev + (1 - ke) * ca, ca)
    want = b / jnp.maximum(b.sum(-1, keepdims=True), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


# ---- the default gate: what the port computed with the gate in its code ----


def _fixed_gate_ema(prev, current, ema, initialized, adapt):
    """ops/temporal.py::temporal_ema as it was with the gate fixed in the
    code (the constants 0.10 and 1 / (0.40 - 0.10) of the expression)."""
    k = ema.to(current.dtype)[:, None, None]
    ad = adapt.to(current.dtype)[:, None, None]
    m = torch.clamp((torch.abs(current - prev) - 0.10) * (1.0 / (0.40 - 0.10)), 0.0, 1.0)
    k = k * (1.0 - ad * m)
    return torch.where(initialized[:, None, None], k * prev + (1.0 - k) * current, current)


def test_default_gate_is_bit_for_bit_the_fixed_one(rng):
    """At runtime/config.py's default gate: the two floats the kernel's
    launch takes (ctypes rounds each to f32) are the constants the CUDA body
    held (0.10f and (float)(1.0 / (0.40 - 0.10))); temporal_ema and every
    temporal plain version's new_prev equal the fixed-gate expression bit
    for bit."""
    assert (TC.EMA_ADAPT_T0, TC.EMA_ADAPT_T1) == DEFAULT
    t0, inv_ramp = TC.ema_gate()
    assert ctypes.c_float(t0).value == float(np.float32(0.10))
    assert ctypes.c_float(inv_ramp).value == float(np.float32(1.0 / (0.40 - 0.10)))
    d = inputs(rng, "warp_prior_mixed")
    tk = TC.default_knobs(S)
    tk.ema_adapt = T(EMA_ADAPT)
    table = TR.scalar_table(tk, T(d["use_warp"]), T(d["init"]), 0.3, T(PRIOR),
                            T(d["has_prior"]))
    new_prev, _ = TT.temporal_ema(T(d["prev"]), T(d["alpha"]), tk.ema, T(d["init"]),
                                  adapt=tk.ema_adapt)
    want = _fixed_gate_ema(T(d["prev"]), T(d["alpha"]), tk.ema, T(d["init"]), tk.ema_adapt)
    assert torch.equal(new_prev, want)
    yi, xi = TR.separable_warp_indices(T(d["affine"]), (H, W))
    base = TR.warp_separable_gather(T(d["prev"]), yi, xi)
    wb = torch.where(T(d["use_warp"])[:, None, None], base * 0.3 + T(d["alpha"]) * 0.7,
                     T(d["alpha"]))
    want = _fixed_gate_ema(T(d["prev"]), wb, tk.ema, T(d["init"]), tk.ema_adapt)
    for got in (TR.fused_temporal_refine_plain(T(d["alpha"]), T(d["prev"]), yi, xi,
                                               T(d["guide"]), table)[0],
                TR.fused_temporal_refine_fast(T(d["alpha"]), T(d["prev"]), T(d["affine"]),
                                              T(d["use_warp"]), T(d["init"]), 0.3,
                                              T(to_lanes(d["guide"])), T(PRIOR),
                                              T(d["has_prior"]), tk,
                                              guide_lanes_geom=(4, 4))[0]):
        assert torch.equal(got, want)


# ---- a step served after the gate moves follows it --------------------------


def _engine(name="fast_int8_pico", **kw):
    st = preset(name, frame_hw=(80, 160), face_path=False, fd_size=64, lmk_size=48, **kw)
    eng = Engine(1, st, device="cpu")
    eng.admit()
    return eng


def _alphas(eng, frames):
    return [eng.process(f[None])["alpha"].float().clone() for f in frames]


@pytest.mark.parametrize("name,kw", [("fast_int8_pico", {"mask_hw": (32, 64)}),
                                     ("fast_int8_pico", {"mask_hw": (32, 64),
                                                         "warp_impl": "exact"}),
                                     ("multiclass_fast_pico", {"mask_hw": (8, 16)})])
def test_a_step_built_after_the_gate_moves_follows_it(rng, name, kw):
    """Seeded engines: one served at the default gate, one built and served
    with the gate moved, one after it was put back.  The first and the last
    serve the same alphas bit for bit; the one at the moved gate departs
    from them once the EMA engages (adapt 1, the pico's default)."""
    frames = rng.integers(0, 256, (4, 80, 160, 3), dtype=np.uint8)
    frames[2:] = frames[:2][::-1]  # motion, so the gate sees differences
    a0 = _alphas(_engine(name, **kw), frames)
    with TC.ema_gate_at(*MOVED):
        a1 = _alphas(_engine(name, **kw), frames)
    a2 = _alphas(_engine(name, **kw), frames)
    for x, y in zip(a0, a2):
        assert torch.equal(x, y)
    assert torch.equal(a0[0], a1[0])  # the first frame is copied, no EMA
    assert max(float((x - y).abs().max()) for x, y in zip(a0[1:], a1[1:])) > 1e-3
