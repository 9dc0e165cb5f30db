"""The port's Engine service surface against the JAX Engine's: passthrough
degradation, the health probe and snapshot recovery on each of the six
call families (process, process_range/process_group, process_chunked,
dispatch/collect, dispatch_range/collect_range, dispatch_round/
collect_round), reset_knobs, stream_stats, output_layout='packed' and
collect_sync=False.

Both engines serve fast_int8_pico with the face path off at 80x160 (mask
32x64), S=4, from one seeded pico tree (the JAX side built with a
ModelBundle, its refine kernel in interpret mode and its int8 trunk
through XLA as it resolves off a TPU -- tests/test_torch_trunk.py holds
the port's trunk against the Pallas one -- state donation on as it
ships), and go through the same calls in the same order with the same
failure injected at the same call: four failing calls (the fourth finds
the engine DEGRADED and does not run the step), then the probe.  Where
the reference's failure surfaces at collect (a step whose output cannot
be waited for), the port's is raised while the step is enqueued; both
recover from the snapshot of the same dispatch.  The port's round failure
comes after its first group wrote its rows.

Tolerances as tests/test_torch_engine.py: refined alpha 4e-3 (bf16 out),
prev_alpha 2e-5, composited frames one u8 step; health states, the
passthrough frames (equal to the input), the alpha of a passthrough (f32
ones) and the cheap per-stream fields (affine, has_affine, frame_idx)
after a recovery exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stream_segmenetation_tpu import models as jm
from video_stream_segmenetation_tpu.runtime.pipeline import ModelBundle
from video_stream_segmenetation_tpu.runtime.presets import preset as jax_preset
from video_stream_segmenetation_tpu.service import Engine as JaxEngine
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu_torch.models.blazeface import init_face_finder_params
from video_stream_segmenetation_tpu_torch.models.facemesh import init_landmark_net_params
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import init_params
from video_stream_segmenetation_tpu_torch.models.quantized import quantize_mattenet_hd
from video_stream_segmenetation_tpu_torch.ops.layout import space_to_depth
from video_stream_segmenetation_tpu_torch.runtime.presets import preset
from video_stream_segmenetation_tpu_torch.service.engine import Engine

S = 4
GEOM = dict(face_path=False, frame_hw=(80, 160), mask_hw=(32, 64), fd_size=64, lmk_size=48)
SIZES = [2, 2]
CHEAP = ("affine", "has_affine", "frame_idx")
FAMILIES = ("process", "range", "chunked", "dispatch", "dispatch_range", "round")


def _frames(t):
    """A bright ellipse moving over noise, per stream."""
    rng = np.random.default_rng(100 + t)
    f = (rng.random((S, 80, 160, 3)) * 120).astype(np.uint8)
    yy, xx = np.mgrid[0:80, 0:160]
    for s in range(S):
        cx, cy = 50 + 6 * t + 12 * s, 40 + 2 * t
        inside = ((xx - cx) / 28.0) ** 2 + ((yy - cy) / 30.0) ** 2 <= 1.0
        f[s][inside] = (220, 190, 170)
    return f


class _Unreadable:
    """A step output whose wait raises: a failure on the device that the
    reference finds at collect time."""

    def block_until_ready(self):
        raise RuntimeError("device fault")


def _poison_out(out):
    out = dict(out)
    out["frame"] = _Unreadable()
    return out


def _raise(*args, **kw):
    raise RuntimeError("injected step failure")


def _np(x):
    """A host copy (a view of a JAX buffer would follow it when the next
    step takes the state's buffers over)."""
    return x.float().numpy().copy() if isinstance(x, torch.Tensor) else np.array(x, np.float32)


def _call(e, family, frames, t):
    """One call of ``family`` (the range families alternate their two
    groups); returns the list of its result dicts."""
    if family == "process":
        return [e.process(frames)]
    if family == "range":
        return [e.process_group(1, 2, frames[2:]) if t % 2
                else e.process_range(0, 2, frames[:2])]
    if family == "chunked":
        return [e.process_chunked(frames, 2)]
    if family == "dispatch":
        return [e.collect(e.dispatch(frames))]
    if family == "dispatch_range":
        return [e.collect_range(e.dispatch_range(2, 4, frames[2:])) if t % 2
                else e.collect(e.dispatch_range(0, 2, frames[:2]))]
    return e.collect_round(e.dispatch_round(SIZES, [frames[:2], frames[2:]]))


def _inject(je, te, family):
    """Make the family's step fail in both engines; returns the undo."""
    saved = [(e, k, e.__dict__.get(k)) for e in (je, te)
             for k in ("_step", "_range_step", "_round_step_for")]
    if family in ("process", "range", "chunked", "dispatch"):
        je._step = te._step = _raise
    elif family == "dispatch_range":
        jrs = je._range_step

        def jax_range(*a, **kw):
            new_full, new_last, out = jrs(*a, **kw)
            return new_full, new_last, _poison_out(out)

        je._range_step, te._range_step = jax_range, _raise
    else:
        jfor, trs = je._round_step_for, te._run_range

        def jax_for(sizes):
            rs = jfor(sizes)

            def poisoned(*a):
                new_full, new_last, outs = rs(*a)
                return new_full, new_last, outs[:-1] + [_poison_out(outs[-1])]
            return poisoned

        def port_for(sizes):
            def fails(step_frames, now):
                # the first group writes its rows back, then the round fails
                trs(0, SIZES[0], step_frames[0], now)
                raise RuntimeError("injected failure in the round's second group")
            return fails

        je._round_step_for, te._round_step_for = jax_for, port_for

    def undo():
        for e, k, v in saved:
            if v is None:  # a method: drop the instance's override
                e.__dict__.pop(k, None)
            else:
                setattr(e, k, v)
    return undo


def _state(e):
    return {k: _np(getattr(e.state, k)) for k in ("prev_alpha", "initialized", *CHEAP)}


@pytest.fixture(scope="module")
def tree():
    return init_params("pico", 0, 10)


def _engines(tree):
    bundle = ModelBundle(
        jm.MatteNetHD(stem_stride=10, head_upsample=4, decoder="pico"),
        jax.tree_util.tree_map(jnp.asarray, tree), jm.FaceFinder(input_size=64),
        init_face_finder_params(1), jm.LandmarkNet(), init_landmark_net_params(2))
    je = JaxEngine(num_streams=S, statics=jax_preset(
        "fast_int8_pico", use_fused_refine=True, **GEOM),
        bundle=bundle)
    te = Engine(S, preset("fast_int8_pico", **GEOM), params=quantize_mattenet_hd(tree, 10, "pico"),
                device="cpu")
    rng = np.random.default_rng(7)
    for e in (je, te):
        e.admit_all()
    for s in range(S):
        bg = rng.integers(0, 256, (80, 160, 3), dtype=np.uint8)
        je.set_background(s, bg)
        te.set_background(s, bg)
    return je, te


@pytest.fixture(scope="module")
def runs(tree):
    """Per family: a served call, four failing calls, the probe; after each
    call both engines' results, health and state."""
    je, te = _engines(tree)
    t = 0
    record = {}
    for family in FAMILIES:
        calls = []
        for phase in ("served", "fail", "fail", "fail", "fail", "probe"):
            if phase == "fail" and not any(c[0] == "fail" for c in calls):
                undo = _inject(je, te, family)
            if phase == "probe":
                undo()
                je.health._degraded_at = te.health._degraded_at = 0.0
            frames = _frames(t)
            t += 1
            jres, tres = _call(je, family, frames, t), _call(te, family, frames, t)
            calls.append((phase, frames, jres, tres, je.health.snapshot(),
                          te.health.snapshot(), _state(je), _state(te)))
        record[family] = calls
    return je, te, record


@pytest.mark.parametrize("family", FAMILIES)
def test_health_follows_the_reference(runs, family):
    """ok, ok, degraded after the third failure, degraded (the step not
    run), ok after the probe; the same counts in both engines."""
    _, _, record = runs
    states = [c[5]["state"] for c in record[family]]
    assert states == [c[4]["state"] for c in record[family]]
    assert states == ["ok", "ok", "ok", "degraded", "degraded", "ok"]
    for c in record[family]:
        assert c[5]["consecutive_failures"] == c[4]["consecutive_failures"]


@pytest.mark.parametrize("family", FAMILIES)
def test_failed_calls_pass_the_input_through(runs, family):
    _, te, record = runs
    mh, mw = te.statics.mask_hw
    for phase, frames, jres, tres, *_ in record[family]:
        if phase != "fail":
            assert not any(r["passthrough"] for r in tres)
            continue
        i0 = 0
        for jr, tr in zip(jres, tres):
            rows = tr["frame"].shape[0]
            i0 = tr.get("slots", (i0,))[0]
            want = frames[i0:i0 + rows]
            assert tr["passthrough"]
            np.testing.assert_array_equal(tr["frame"].numpy(), want)
            np.testing.assert_array_equal(np.asarray(jr["frame"]), want)
            assert tr["alpha"].dtype == torch.float32
            assert tuple(tr["alpha"].shape) == np.asarray(jr["alpha"]).shape == (rows, mh, mw)
            assert bool((tr["alpha"] == 1).all()) and not tr["face_applied"].any()
            assert tr["metrics"]["passthrough_steps"] > 0
            i0 += rows


@pytest.mark.parametrize("family", FAMILIES)
def test_state_after_each_call_follows_the_reference(runs, family):
    """The cheap fields exactly (after a recovery: the snapshot's), the EMA
    within 2e-5 (cold after a recovery in both)."""
    _, _, record = runs
    for phase, _, _, _, _, _, jst, tst in record[family]:
        for k in CHEAP:
            np.testing.assert_array_equal(tst[k], jst[k], err_msg=f"{phase} {k}")
        np.testing.assert_array_equal(tst["initialized"], jst["initialized"])
        np.testing.assert_allclose(tst["prev_alpha"], jst["prev_alpha"], rtol=0, atol=2e-5)


@pytest.mark.parametrize("family", ["dispatch_range", "round"])
def test_failed_in_place_steps_recover_from_the_snapshot(runs, family):
    """After a failed range or round step the state is the snapshot's
    cheap fields over a cold EMA: no stream keeps its prev_alpha, and the
    frame counter is the snapshot's, behind the count of served steps."""
    _, _, record = runs
    first_fail = next(c for c in record[family] if c[0] == "fail")
    tst = first_fail[7]
    assert not tst["prev_alpha"].any() and not tst["initialized"].any()
    served = record[family][0][7]["frame_idx"]
    assert (tst["frame_idx"] < served).any()


@pytest.mark.parametrize("family", FAMILIES)
def test_served_calls_match_the_reference(runs, family):
    _, _, record = runs
    for phase, _, jres, tres, *_ in record[family]:
        if phase == "fail":
            continue
        for jr, tr in zip(jres, tres):
            np.testing.assert_allclose(_np(tr["alpha"]), np.asarray(jr["alpha"], np.float32),
                                       rtol=0, atol=4e-3)
            diff = np.abs(tr["frame"].numpy().astype(np.int32)
                          - np.asarray(jr["frame"]).astype(np.int32))
            assert diff.max() <= 1


def test_reset_knobs_and_stream_stats_match_the_reference(runs):
    je, te, _ = runs
    for e in (je, te):
        e.set_knobs(1, gamma=1.9, ema=0.2, use_bilateral=False, sigma_range=3.0)
        e.set_knobs(2, noise_cutoff=0.2)
        e.reset_knobs(1)
        e.process(_frames(50))
    for k in ("ema", "ema_adapt", "noise_cutoff", "high_threshold", "gamma", "use_bilateral",
              "sigma_spatial", "sigma_range"):
        np.testing.assert_array_equal(_np(getattr(te.knobs, k)),
                                      np.asarray(getattr(je.knobs, k), np.float32), err_msg=k)
    te.evict(3)
    je.evict(3)
    assert te.stream_stats() == je.stream_stats()
    assert [s["frames"] for s in te.stream_stats()][3] == 0


def test_packed_output_and_collect_sync_off(tree, runs):
    """output_layout='packed' serves the reference's frames packed (one u8
    step); collect_sync=False returns the same results through
    dispatch/collect.  Both start from the reference engine's state, knobs
    and backgrounds after the runs above."""
    je = runs[0]
    q = quantize_mattenet_hd(tree, 10, "pico")
    tp = Engine(S, preset("fast_int8_pico", **GEOM), params=q, device="cpu",
                output_layout="packed")
    tn = Engine(S, preset("fast_int8_pico", **GEOM), params=q, device="cpu", collect_sync=False)
    for e in (tp, tn):
        for k in ("prev_alpha", "affine", "has_affine", "initialized", "frame_idx"):
            getattr(e.state, k).copy_(torch.as_tensor(np.array(getattr(je.state, k))))
        for k in ("ema", "ema_adapt", "noise_cutoff", "high_threshold", "gamma",
                  "use_bilateral", "sigma_spatial", "sigma_range"):
            getattr(e.knobs, k).copy_(torch.as_tensor(np.array(getattr(je.knobs, k))))
        e.backgrounds.copy_(torch.as_tensor(np.array(je.backgrounds)))
    with pytest.raises(ValueError, match="output_layout"):
        Engine(1, preset("fast_int8_pico", **GEOM), device="cpu", output_layout="planar")
    for t in range(2):
        frames = _frames(60 + t)
        jr, pr, nr = je.process(frames), tp.process(frames), tn.collect(tn.dispatch(frames))
        assert tuple(pr["frame"].shape) == (S, 8, 16, 300)
        want = space_to_depth(torch.as_tensor(np.asarray(jr["frame"])), 10).numpy()
        assert np.abs(pr["frame"].numpy().astype(np.int32) - want.astype(np.int32)).max() <= 1
        assert torch.equal(space_to_depth(nr["frame"], 10), pr["frame"])
        assert torch.equal(nr["alpha"], pr["alpha"]) and not nr["passthrough"]
