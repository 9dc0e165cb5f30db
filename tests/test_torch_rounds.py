"""The port's serving loop against the JAX package's: Engine +
StreamScheduler(fused_rounds=True, group_sizes=[4, 2]) over each package's
native FramePool, 3 rounds of the same frames, trained pico and 128-pixel
face weights, the face path's wall-clock gate off; on the fast route
(refine_alpha_src='lowres', guide_kernel_unfold=True, guide_source='host':
the pools emit the guide lanes) and on fast_int8_pico as its preset
stands, each with the face path off (held element by element) and on
(the bf16 face models' boxes differ by fractions of a pixel, so the
merged affine's nearest warp moves a few pixels: held by the face
decisions, the affine, and the alpha's IoU, as tests/test_torch_engine.py
holds its free-running runs).  The JAX engines run their Pallas kernels
in interpret mode.  Also:
fused rounds against the per-group step_pipelined rotation in the port,
the staggered admission, the device face clock's gate against the
reference's, and the fast refine's routing against the reference's
make_step.

Tolerances as tests/test_torch_engine.py: refined alpha 4e-3 (bf16 out),
new_prev 2e-5, composited frames one u8 step, the merged affine 0.3 mask
pixels in translation and 1e-2 in its linear part; with the face path on,
the alpha > 0.5 IoU within 0.01 and new_prev within 2e-5 on the streams
no affine warps.
"""

import time
import types

import jax
import numpy as np
import pytest
import torch

from video_stream_segmenetation_tpu import models as jmodels
from video_stream_segmenetation_tpu.runtime import make_step as jax_make_step
from video_stream_segmenetation_tpu.runtime.pipeline import ModelBundle
from video_stream_segmenetation_tpu.runtime.presets import preset as jax_preset
from video_stream_segmenetation_tpu.runtime.scheduler import StreamScheduler as JaxScheduler
from video_stream_segmenetation_tpu.service import Engine as JaxEngine
from video_stream_segmenetation_tpu.utils.clips import articulated_clip
from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.runtime.presets import preset
from video_stream_segmenetation_tpu_torch.runtime.scheduler import StreamScheduler
from video_stream_segmenetation_tpu_torch.service.engine import Engine

S, SIZES, ROUNDS = 6, [4, 2], 3
GEOM = dict(frame_hw=(80, 160), mask_hw=(32, 64), fd_size=64, lmk_size=48)
FAST = dict(refine_alpha_src="lowres", guide_kernel_unfold=True, guide_source="host")
ROUTES = {"fast": FAST, "preset": {}}
PICO_CKPT = "checkpoints/mattenet_hd10_pico"
FACE_CKPTS = ("checkpoints/facefinder_128", "checkpoints/landmarknet_128")


@pytest.fixture(scope="module")
def round_frames():
    """Per round, ``[S, 80, 160, 3]``: rendered people whose faces the
    trained detector finds, stream s from clip s % 2 at frame r + s // 2."""
    clips = [articulated_clip(n_frames=ROUNDS + S // 2, hw=(80, 160), seed=sd,
                              features=True).frames for sd in (2, 1)]
    return [np.stack([clips[s % 2][r + s // 2] for s in range(S)]) for r in range(ROUNDS)]


@pytest.fixture(scope="module")
def backgrounds():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, (80, 160, 3), dtype=np.uint8) for _ in range(S)]


@pytest.fixture(scope="module")
def trained():
    """The JAX side's trained pico and face trees, and the port's weights
    made from them (as tests/test_torch_engine.py)."""
    je = JaxEngine(num_streams=1, statics=jax_preset(
        "fast_int8_pico", use_fused_refine=True, int8_decoder_impl="trunk", **GEOM),
        rng_seed=0, donate_state=False)
    je.load_matting_params(PICO_CKPT)
    je.load_face_params(*FACE_CKPTS)
    npt = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    port = dict(params=bridge.load_quantized(npt(je.bundle.matte_params)),
                face_params={"face": bridge.float_tree(npt(je.bundle.face_params)),
                             "lmk": bridge.float_tree(npt(je.bundle.lmk_params))})
    # the float trees: each JAX Engine quantizes (and replaces) its own
    # bundle's matting model, so each gets a new bundle
    return (lambda: ModelBundle(*je._raw_matte, *je._raw_face)), port


def _serve(sched, eng, frames, bgs, fused=True):
    """Admit all, set the backgrounds, serve ROUNDS rounds (fused: step_round
    and a drain; else step_pipelined a group a tick and a drain).  Returns
    per round the list of group results in slot order."""
    eng.face_min_interval_s = 0.0
    sched.admit_all()
    for s in range(S):
        eng.set_background(s, bgs[s])
    rounds, pending = [], []
    for r in range(ROUNDS):
        for s in range(S):
            sched.push_frame(s, frames[r][s])
        if fused:
            got = sched.step_round()
            if got is not None:
                rounds.append(got)
        else:
            for _ in range(sched.groups):
                got = sched.step_pipelined()
                if got is not None:
                    pending.append(got)
    tail = sched.drain()
    if fused:
        rounds.append(tail)
    else:
        pending.append(tail)
        rounds = [pending[i:i + len(SIZES)] for i in range(0, len(pending), len(SIZES))]
    return rounds


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.fixture(scope="module", params=[(r, f) for r in sorted(ROUTES) for f in (False, True)],
                ids=lambda p: f"{p[0]}-face_{'on' if p[1] else 'off'}")
def served(request, trained, round_frames, backgrounds):
    route, face = request.param
    bundle, port = trained
    over = dict(ROUTES[route], face_path=face)
    jst = jax_preset("fast_int8_pico", use_fused_refine=True, int8_decoder_impl="trunk",
                     **over, **GEOM)
    je = JaxEngine(num_streams=S, statics=jst, bundle=bundle(), donate_state=False)
    js = JaxScheduler(je, use_native_pool=True, group_sizes=SIZES, fused_rounds=True)
    te = Engine(S, preset("fast_int8_pico", **over, **GEOM), **port, device="cpu")
    ts = StreamScheduler(te, group_sizes=SIZES, fused_rounds=True)
    jr = _serve(js, je, round_frames, backgrounds)
    tr = _serve(ts, te, round_frames, backgrounds)
    out = dict(route=route, face=face, je=je, js=js, te=te, ts=ts, jr=jr, tr=tr)
    yield out
    js.stop()
    ts.stop()


def test_both_pools_are_native_with_lanes_on_the_fast_route(served):
    js, ts = served["js"], served["ts"]
    assert js.pool is not None and ts.pool is not None
    assert ts.pool.depth == js.pool.depth == 2 * len(SIZES)
    want = 48 if served["route"] == "fast" else 0
    assert ts.pool.num_lanes == js.pool.num_lanes == want
    assert served["te"].host_lanes == (served["route"] == "fast")


def _iou(a, b):
    a, b = a > 0.5, b > 0.5
    return (a & b).sum() / max((a | b).sum(), 1)


def test_rounds_match_jax_engine(served):
    """Every round and group: the slots, the refined alpha (bf16) and the
    composited frame; with the face path on, the alpha's IoU."""
    jr, tr = served["jr"], served["tr"]
    assert len(jr) == len(tr) == ROUNDS
    for r, (jg, tg) in enumerate(zip(jr, tr)):
        assert [g["slots"] for g in tg] == [tuple(g["slots"]) for g in jg] == [(0, 4), (4, 6)]
        for j, t in zip(jg, tg):
            assert t["alpha"].dtype == torch.bfloat16
            ta, ja = _np(t["alpha"]), _np(j["alpha"])
            jf = np.asarray(j["frame"]).astype(np.int32)
            tf = t["frame"].numpy().astype(np.int32)
            assert tf.shape == jf.shape == (t["slots"][1] - t["slots"][0], 80, 160, 3)
            if served["face"]:
                assert _iou(ta, ja) >= 0.99, f"round {r} slots {t['slots']}"
                continue
            np.testing.assert_allclose(ta, ja, rtol=0, atol=4e-3,
                                       err_msg=f"round {r} slots {t['slots']}")
            assert np.abs(tf - jf).max() <= 1
    assert 0.05 < _np(tr[-1][0]["alpha"]).mean() < 0.95


def test_state_matches_jax_engine(served):
    je, te = served["je"], served["te"]
    warped = np.asarray(je.state.has_affine)
    assert warped.any() == served["face"]
    np.testing.assert_allclose(te.state.prev_alpha.numpy()[~warped],
                               np.asarray(je.state.prev_alpha)[~warped], rtol=0, atol=2e-5)
    np.testing.assert_array_equal(te.state.frame_idx.numpy(), np.asarray(je.state.frame_idx))
    np.testing.assert_array_equal(te.state.initialized.numpy(),
                                  np.asarray(je.state.initialized))
    np.testing.assert_array_equal(te.state.has_affine.numpy(), np.asarray(je.state.has_affine))
    ja, ta = np.asarray(je.state.affine), te.state.affine.numpy()
    np.testing.assert_allclose(ta[:, [2, 5]], ja[:, [2, 5]], rtol=0, atol=0.3)
    np.testing.assert_allclose(ta[:, [0, 1, 3, 4]], ja[:, [0, 1, 3, 4]], rtol=0, atol=1e-2)


def test_face_clock_matches_jax_engine(served):
    """The device face clocks saw the same applications: the same streams
    stamped (the reference keeps face_applied internal; its clock shows
    it), and the face path fired with the stagger."""
    je, te = served["je"], served["te"]
    jl = np.asarray(je._face_last_dev)
    tl = te._face_last_dev.numpy()
    np.testing.assert_array_equal(tl > -1e8, jl > -1e8)
    assert ((tl > -1e8).sum() >= 2) == served["face"]
    applied = np.stack([np.concatenate([g["face_applied"].numpy() for g in rnd])
                        for rnd in served["tr"]])
    np.testing.assert_array_equal(applied.any(0), tl > -1e8)
    # the stagger: no round applies more streams than its groups' K (1 + 1)
    assert applied.sum(1).max() <= 2


def test_fused_rounds_equal_per_group_rotation(trained, round_frames, backgrounds):
    """In the port, one dispatch a round (step_round) and one group a tick
    (step_pipelined, dispatch_range) give the same state and results, on
    the fast route."""
    _, port = trained
    res = {}
    for fused in (True, False):
        te = Engine(S, preset("fast_int8_pico", **FAST, **GEOM), **port, device="cpu")
        ts = StreamScheduler(te, group_sizes=SIZES, fused_rounds=fused)
        res[fused] = (te, _serve(ts, te, round_frames, backgrounds, fused=fused))
        ts.stop()
    (ef, rf), (eg, rg) = res[True], res[False]
    assert torch.equal(ef.state.frame_idx, eg.state.frame_idx)
    assert torch.equal(ef.state.prev_alpha, eg.state.prev_alpha)
    assert torch.equal(ef.state.affine, eg.state.affine)
    for a, b in zip(rf, rg):
        for x, y in zip(a, b):
            assert x["slots"] == y["slots"]
            assert torch.equal(x["alpha"], y["alpha"]) and torch.equal(x["frame"], y["frame"])


def test_process_range_equals_a_rounds_group(trained, round_frames, backgrounds):
    """The synchronous group step writes the same rows as the group's
    step in a round, and leaves the other rows untouched."""
    _, port = trained
    st = preset("fast_int8_pico", **FAST, **GEOM)
    a = Engine(S, st, **port, device="cpu")
    b = Engine(S, st, **port, device="cpu")
    for e in (a, b):
        e.face_min_interval_s = 0.0
        e.admit_all()
    before = b.state.prev_alpha.clone()
    outs = a.collect_round(a.dispatch_round(SIZES, [round_frames[0][:4], round_frames[0][4:]]))
    got = b.process_range(4, 6, round_frames[0][4:])
    assert got["slots"] == outs[1]["slots"] == (4, 6)
    assert torch.equal(got["alpha"], outs[1]["alpha"])
    assert torch.equal(b.state.prev_alpha[4:], a.state.prev_alpha[4:])
    assert torch.equal(b.state.prev_alpha[:4], before[:4])
    assert b.state.frame_idx.tolist() == [0, 0, 0, 0, 1, 1]
    g = b.process_group(0, 3, round_frames[0][:2])
    assert g["slots"] == (0, 2)


def test_ingest_forms_agree(trained, round_frames):
    """Natural frames, packed frames and a (packed, lanes) tuple are the
    same step input on the fast route; the preset's route takes the first
    two and refuses the tuple."""
    from video_stream_segmenetation_tpu_torch.ops.layout import guide_lanes_s2d, space_to_depth

    _, port = trained
    f = torch.as_tensor(round_frames[0])
    packed = space_to_depth(f, 10).contiguous()
    lanes, _ = guide_lanes_s2d(packed, (80, 160), (32, 64), 10)
    for route, host in (("fast", True), ("preset", False)):
        e = Engine(S, preset("fast_int8_pico", **ROUTES[route], **GEOM), **port, device="cpu")
        forms = [e._ingest(x) for x in (f.numpy(), packed)]
        if host:
            forms.append(e._ingest((packed.numpy(), lanes)))
        else:
            with pytest.raises(ValueError, match="host_lanes"):
                e._ingest((packed.numpy(), lanes))
        for x in forms:
            if host:
                assert torch.equal(x[0], packed) and torch.equal(x[1], lanes)
            else:
                assert torch.equal(x, packed)
        with pytest.raises(ValueError, match="frames"):
            e._ingest(np.zeros((S, 80, 150, 3), np.uint8))


def test_staggered_admission_matches_jax(trained):
    """admit_all and admit set frame_idx = slot % lmk_interval, as the
    reference's scheduler does."""
    bundle, port = trained
    te = Engine(S, preset("fast_int8_pico", **GEOM), **port, device="cpu")
    je = JaxEngine(num_streams=S, statics=jax_preset(
        "fast_int8_pico", use_fused_refine=True, int8_decoder_impl="trunk", **GEOM),
        bundle=bundle(), donate_state=False)
    ts = StreamScheduler(te, use_native_pool=False)
    js = JaxScheduler(je, use_native_pool=False)
    assert ts.pool is None
    assert ts.admit_all() == js.admit_all() == list(range(S))
    np.testing.assert_array_equal(te.state.frame_idx.numpy(), np.asarray(je.state.frame_idx))
    assert te.state.frame_idx.tolist() == [s % 6 for s in range(S)]
    te.evict(3)
    je.evict(3)
    assert ts.admit() == js.admit() == 3
    np.testing.assert_array_equal(te.state.frame_idx.numpy(), np.asarray(je.state.frame_idx))


def test_pool_failure_is_kept_and_logged(trained, monkeypatch, caplog):
    """A pool that fails to build leaves the host-array fallback, with the
    reason in ``pool_error`` and in the log; without the pool asked for,
    there is no error."""
    from video_stream_segmenetation_tpu_torch.runtime import scheduler as TS

    _, port = trained
    te = Engine(S, preset("fast_int8_pico", **FAST, **GEOM), **port, device="cpu")
    assert StreamScheduler(te, use_native_pool=False).pool_error is None
    boom = RuntimeError("no C++ compiler on PATH")

    def fail(*args, **kwargs):
        raise boom

    monkeypatch.setattr(TS, "FramePool", fail)
    with caplog.at_level("WARNING", logger="vst.scheduler"):
        ts = StreamScheduler(te, group_sizes=SIZES, fused_rounds=True)
    assert ts.pool is None and ts.pool_error is boom
    assert "no C++ compiler on PATH" in caplog.text


def _ref_clock(epoch, host, min_interval):
    """The reference Engine's face-clock methods on a bare namespace (no
    model needed)."""
    ns = types.SimpleNamespace(_face_epoch=epoch, _last_face_at=host.copy(),
                               _face_last_dev=None, _now_bucket=None, _now_dev=None,
                               _mi_cache=None, face_min_interval_s=min_interval)
    for name in ("_face_mirror", "_now_device", "_min_interval_device", "_face_gate_async",
                 "_face_applied_async"):
        setattr(ns, name, getattr(JaxEngine, name).__get__(ns))
    return ns


@pytest.mark.parametrize("min_interval", [0.0, 0.18, 10.0])
def test_device_face_gate_matches_jax(trained, min_interval):
    """The device gate and its update against the reference's: never-run
    streams open, a recent application closes the gate for
    ``min_interval``, 25 ms buckets of ``now``."""
    _, port = trained
    te = Engine(S, preset("fast_int8_pico", face_path=False, **GEOM), device="cpu")
    epoch = time.monotonic() - 100.0
    host = np.asarray([0.0, epoch + 99.95, epoch + 99.5, epoch + 90.0, 0.0, epoch + 99.99])
    te._face_epoch = epoch
    te._last_face_at = host.copy()
    te.face_min_interval_s = min_interval
    ref = _ref_clock(epoch, host, min_interval)
    now = epoch + 100.0
    for i0, gs in ((0, S), (0, 4), (4, 2)):
        got = te._face_gate_async(i0, gs, now)
        want = np.asarray(ref._face_gate_async(i0, gs, now))
        np.testing.assert_array_equal(got.numpy(), want)
    applied = np.asarray([True, False])
    te._face_applied_async(4, torch.as_tensor(applied), now)
    ref._face_applied_async(4, jax.numpy.asarray(applied), now)
    np.testing.assert_array_equal(te._face_last_dev.numpy(), np.asarray(ref._face_last_dev))
    later = now + 0.1
    np.testing.assert_array_equal(te._face_gate_async(0, S, later).numpy(),
                                  np.asarray(ref._face_gate_async(0, S, later)))
    te.admit_all()
    assert (te._face_last_dev.numpy() == -1e9).all()


# (preset, overrides): where each fast-refine option resolves on or off
ROUTING = {
    "fast": ("fast_int8_pico", FAST),
    "gather": ("fast_int8_pico", dict(FAST, guide_source="gather")),
    "auto": ("fast_int8_pico", dict(refine_alpha_src="auto", guide_kernel_unfold="auto",
                                    guide_source="host")),
    "plane_prior": ("fast_int8_pico", dict(FAST, prior_impl="plane")),
    "face_off": ("fast_int8_pico", dict(FAST, face_path=False)),
    "lowres_only": ("fast_int8_pico", dict(refine_alpha_src="lowres")),
    "lanes_only": ("fast_int8_pico", dict(guide_kernel_unfold=True, guide_source="host")),
    "stem_grid_mask": ("fast_int8_pico", dict(FAST, mask_hw=(8, 16))),
    "plan_b": ("fast_int8", FAST),
    "natural": ("active", FAST),
    "natural_plane": ("active", dict(FAST, prior_impl="plane")),
}


@pytest.mark.parametrize("case", sorted(ROUTING))
def test_fast_routing_matches_reference(case):
    """The port's make_step routing (use_lowres_alpha, use_guide_lanes,
    lane_geom, host_lanes) equals the reference make_step's, read from its
    closure (the fused refine on, as the port always has it)."""
    name, over = ROUTING[case]
    over = dict(over)
    geom = dict(GEOM, **{k: over.pop(k) for k in list(over) if k in GEOM})
    over.pop("mask_hw", None)
    jst = jax_preset(name, use_fused_refine=True, **over, **geom)
    if jst.frame_layout == "s2d":
        mh, mw = jst.mask_hw
        model = jmodels.QuantizedMatteNetHD(10, mh // 8, decoder=jst.matting_decoder)
    else:
        model = jmodels.MatteNet()
    step = jax_make_step(ModelBundle(model, None), jst)
    cells = dict(zip(step.__code__.co_freevars, (c.cell_contents for c in step.__closure__)))
    want = {k: cells[k] for k in ("use_lowres_alpha", "use_guide_lanes", "lane_geom",
                                  "host_lanes")}
    te = Engine(1, preset(name, **over, **geom), device="cpu")
    got = te.routing
    assert {k: bool(v) if k != "lane_geom" else v for k, v in got.items()} == \
        {k: bool(v) if k != "lane_geom" else (tuple(v) if v else None)
         for k, v in want.items()}


def test_jax_on_cpu():
    assert jax.default_backend() == "cpu"
