"""The six presets of the reference's alternative pipelines and trunk widths
(``fast_int8_nano``, ``fast_int8_femto``, ``blaze_tracking``, ``branch``,
``rvm``, ``u2``) through the port's Engine against the JAX Engine on the
CPU: 8 steps each at 80x160 frames with 32x64 masks (``u2`` too), S=2,
rendered people (utils/clips.py::articulated_clip), the wall-clock face
gate off.  The JAX side is built with a ModelBundle (no flax init); its
fused refine runs in interpret mode where the route takes it.  Then
``rvm``'s ``rec`` through ``process_range`` and ``dispatch_round`` (rows
read and written in place), and the recovery of ``rvm`` and
``blaze_tracking`` after a failed round.

Weights: ``fast_int8_nano``/``_femto`` the trained trunks (the reference
restores the checkpoint, the port loads the committed export); the float
models seeded (models/modnet.py, rvm.py, u2net.py), the trained FaceFinder
for ``blaze_tracking``.

Tolerances, with their reasons:
* nano and femto (the int8 trunk, exact s32 sums; the fused refine's f32
  stages): the alpha and prev_alpha within 2e-5, the frame one u8 step;
* the float models compute in bf16, and PyTorch and XLA round their
  convolutions' partial sums at other places, so free-running steps are
  held by the IoU of alpha > 0.5 (>= 0.99) and the mean alpha difference
  (< 5e-3); ``rvm`` teacher-forced (the reference's state, ``rec``
  included, fed in each step): the alpha within 2e-2 and ``rec`` within 4
  bf16 steps of its largest magnitude (the GRU state is rounded to bf16
  inside the cell; the refined alpha's gamma 0.4 stretches small
  differences near the cutoff);
* ``blaze_tracking``: the same detections each step, the centre within
  one mask pixel, the translation within one pixel;
* the flags and counters exactly.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu import models as jm
from video_stream_segmenetation_tpu.runtime.pipeline import ModelBundle
from video_stream_segmenetation_tpu.runtime.presets import preset as jax_preset
from video_stream_segmenetation_tpu.service import Engine as JaxEngine
from video_stream_segmenetation_tpu.utils.checkpoint import restore_params
from video_stream_segmenetation_tpu.utils.clips import articulated_clip
from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.models.modnet import init_mattenet_params
from video_stream_segmenetation_tpu_torch.models.rvm import init_rvm_params
from video_stream_segmenetation_tpu_torch.models.u2net import init_u2net_params
from video_stream_segmenetation_tpu_torch.runtime.presets import preset
from video_stream_segmenetation_tpu_torch.runtime.state import StreamState
from video_stream_segmenetation_tpu_torch.service.engine import Engine

ROOT = Path(__file__).resolve().parents[1]
S, T_STEPS = 2, 8
GEOM = dict(frame_hw=(80, 160), mask_hw=(32, 64), fd_size=64, lmk_size=48)
INT8_TOL = 2e-5
IOU_MIN = 0.99
MEAN_TOL = 5e-3
RVM_ALPHA_TOL = 2e-2
REC_STEPS = 4
# a shift for stream 0 (branch: nothing in serving sets an affine, so the
# max blend runs only where one is primed, as the reference's
# tests/test_tracking_variants.py primes it)
PRIMED = np.asarray([1.0, 0.0, 2.0, 0.0, 1.0, -1.0], np.float32)


def _np(x):
    return x.float().numpy().copy() if isinstance(x, torch.Tensor) else np.array(x, np.float32)


@pytest.fixture(scope="module")
def frames():
    clips = [articulated_clip(n_frames=T_STEPS, hw=(80, 160), seed=sd, features=True).frames
             for sd in (2, 1)]
    return [np.stack([clips[s][t] for s in range(S)]) for t in range(T_STEPS)]


@pytest.fixture(scope="module")
def face_trees():
    return {n: bridge.float_tree(jax.tree_util.tree_map(
        np.asarray, restore_params(str(ROOT / f"checkpoints/{n}"))))
        for n in ("facefinder", "landmarknet")}


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _engines(name, face_trees):
    """(JAX Engine, port Engine) for ``name`` at the test geometry."""
    jover = {"use_fused_refine": True}
    face = (jm.FaceFinder(input_size=GEOM["fd_size"]), _jnp(face_trees["facefinder"]),
            jm.LandmarkNet(), _jnp(face_trees["landmarknet"]))
    face_params = {"face": face_trees["facefinder"], "lmk": face_trees["landmarknet"]}
    st = preset(name, **GEOM)
    if name in ("fast_int8_nano", "fast_int8_femto"):
        plan = st.matting_decoder
        ckpt = f"checkpoints/mattenet_hd10_{plan}"
        tree = jax.tree_util.tree_map(np.asarray, restore_params(str(ROOT / ckpt)))
        matte = (jm.MatteNetHD(stem_stride=10, head_upsample=4, decoder=plan), _jnp(tree))
        over = {"face_path": False}
        params = bridge.load_export(bridge.WEIGHTS_DIR / f"{bridge.EXPORTS[plan]}.npz")
    elif name == "rvm":
        tree = init_rvm_params(0)
        matte = (jm.RecurrentMatteNet(), _jnp(tree))
        over, params = {}, tree
    elif name == "u2":
        tree = init_u2net_params(0)
        matte = (jm.SaliencyNet(), _jnp(tree))
        over, params = {"mask_hw": GEOM["mask_hw"]}, tree
    else:
        tree = init_mattenet_params(0)
        matte = (jm.MatteNet(), _jnp(tree))
        over, params = {}, tree
    jst = jax_preset(name, **{**GEOM, **jover, **over})
    je = JaxEngine(num_streams=S, statics=jst, bundle=ModelBundle(*matte, *face),
                   donate_state=False)
    te = Engine(S, preset(name, **{**GEOM, **over}), params=params, face_params=face_params,
                device="cpu")
    for e in (je, te):
        e.face_min_interval_s = 0.0
        e.admit_all()
    return je, te


def _prime(e):
    if isinstance(e, Engine):
        e.state.affine[0] = torch.tensor(PRIMED)
        e.state.has_affine[0] = True
    else:
        import dataclasses

        e.state = dataclasses.replace(e.state, affine=e.state.affine.at[0].set(PRIMED),
                                      has_affine=e.state.has_affine.at[0].set(True))


def _host(x):
    return x.numpy().copy() if isinstance(x, torch.Tensor) else np.array(x)


def _state(e):
    """Host copies of the engine's state, dtypes kept (``rec`` a list)."""
    st = e.state
    out = {k: _host(getattr(st, k)) for k in ("prev_alpha", "affine", "has_affine",
                                               "initialized", "frame_idx", "face_center",
                                               "has_center")}
    out["rec"] = [_host(r) for r in st.rec]
    return out


def _iou(a, b):
    pa, pb = a > 0.5, b > 0.5
    return float((pa & pb).sum() / max((pa | pb).sum(), 1))


ZOO = ("fast_int8_nano", "fast_int8_femto", "blaze_tracking", "branch", "rvm", "u2")


@pytest.fixture(scope="module", params=ZOO)
def runs(request, frames, face_trees):
    """8 free-running steps of both engines, each step's state before and
    after."""
    name = request.param
    je, te = _engines(name, face_trees)
    if name == "branch":
        for e in (je, te):
            _prime(e)
    outs = []
    for e in (je, te):
        steps = []
        for f in frames:
            before = _state(e)
            out = e.process(f)
            steps.append({"out": out, "before": before, "after": _state(e)})
        outs.append(steps)
    return name, je, te, outs


def test_engines_serve_every_step(runs):
    name, je, te, (jouts, touts) = runs
    assert je.health.total_failures == 0 and te.stats()["passthrough_steps"] == 0
    for t in touts:
        assert not t["out"]["passthrough"]
        assert t["out"]["alpha"].dtype == torch.float32
        assert tuple(t["out"]["alpha"].shape) == (S, *te.statics.mask_hw)


@pytest.mark.parametrize("step", range(T_STEPS))
def test_step_matches_reference(runs, step):
    name, _, _, (jouts, touts) = runs
    j, t = jouts[step], touts[step]
    ja, ta = np.asarray(j["out"]["alpha"], np.float32), _np(t["out"]["alpha"])
    for k in ("has_affine", "initialized", "frame_idx", "has_center"):
        np.testing.assert_array_equal(t["after"][k], j["after"][k], err_msg=k)
    if name in ("fast_int8_nano", "fast_int8_femto"):
        np.testing.assert_allclose(ta, ja, rtol=0, atol=INT8_TOL)
        np.testing.assert_allclose(t["after"]["prev_alpha"], j["after"]["prev_alpha"], rtol=0,
                                   atol=INT8_TOL)
        diff = np.abs(_np(t["out"]["frame"]) - np.asarray(j["out"]["frame"], np.float32))
        assert diff.max() <= 1
    else:
        assert _iou(ta, ja) >= IOU_MIN, _iou(ta, ja)
        assert np.abs(ta - ja).mean() < MEAN_TOL
    if name == "blaze_tracking":
        # the reference returns no face_applied: the one-shot merge makes it
        # the new has_affine, held above
        np.testing.assert_array_equal(t["out"]["face_applied"].numpy(), j["after"]["has_affine"])
        np.testing.assert_allclose(t["after"]["face_center"], j["after"]["face_center"],
                                   rtol=0, atol=1.0)
        np.testing.assert_allclose(t["after"]["affine"], j["after"]["affine"], rtol=0, atol=1.0)
    else:
        np.testing.assert_allclose(t["after"]["affine"], j["after"]["affine"], rtol=0,
                                   atol=1e-6)


def test_variants_do_what_their_presets_say(runs):
    """blaze_tracking finds the faces and moves the affine by whole pixels
    (a one-shot translation); branch's primed stream blends with max; rvm
    threads a non-zero state; u2 has no temporal stage (prev_alpha is the
    served alpha's input, the raw model alpha)."""
    name, _, te, (_, touts) = runs
    last = touts[-1]
    if name == "blaze_tracking":
        applied = np.stack([t["out"]["face_applied"].numpy() for t in touts])
        assert applied.any() and last["after"]["has_center"].all()
        aff = np.stack([t["after"]["affine"] for t in touts])
        np.testing.assert_array_equal(aff[..., [0, 4]], 1.0)
        np.testing.assert_array_equal(aff[..., [2, 5]], np.trunc(aff[..., [2, 5]]))
    elif name == "branch":
        assert last["after"]["has_affine"][0] and not last["after"]["has_affine"][1]
    elif name == "rvm":
        assert [r.shape for r in last["after"]["rec"]] == [
            (S, 4, 8, 16), (S, 2, 4, 20), (S, 1, 2, 40), (S, 1, 1, 64)]
        assert all(np.abs(r).max() > 0 for r in last["after"]["rec"])
    elif name == "u2":
        assert te.statics.temporal_filter == "none"


def test_rvm_teacher_forced_each_step(frames, face_trees):
    """Each step of the port's rvm Engine starts from the reference's state
    before that step (``rec`` included): the alpha and the new ``rec``
    within their tolerances."""
    je, te = _engines("rvm", face_trees)
    for t, f in enumerate(frames):
        before = _state(je)
        jo = je.process(f)
        after = _state(je)
        te.state = StreamState(**{k: torch.tensor(v) for k, v in before.items() if k != "rec"},
                               rec=tuple(torch.tensor(r) for r in before["rec"]))
        to = te.process(f)
        np.testing.assert_allclose(_np(to["alpha"]), np.asarray(jo["alpha"], np.float32),
                                   rtol=0, atol=RVM_ALPHA_TOL, err_msg=f"step {t}")
        for got, want in zip(te.state.rec, after["rec"]):
            tol = REC_STEPS * 2.0 ** -8 * np.abs(want).max() + 2.0 ** -8
            np.testing.assert_allclose(_np(got), want, rtol=0, atol=tol, err_msg=f"step {t}")


def test_rvm_rec_rows_in_place(frames, face_trees):
    """process_range and dispatch_round read and write ``rec`` rows in
    place: rows outside the range untouched, the stepped rows as the
    reference's (IoU and rec as above, the same calls on both engines)."""
    je, te = _engines("rvm", face_trees)
    for e in (je, te):
        e.process(frames[0])
    t_before = _state(te)
    for e in (je, te):
        e.process_range(1, 2, frames[1][1:])
    ts, js = _state(te), _state(je)
    for got, was in zip(ts["rec"], t_before["rec"]):
        np.testing.assert_array_equal(got[0], was[0])  # row 0 not stepped
        assert not np.array_equal(got[1], was[1])
    for e in (je, te):
        res = e.collect_round(e.dispatch_round([1, 1], [frames[2][:1], frames[2][1:]]))
        assert [r["slots"] for r in res] == [(0, 1), (1, 2)]
    ts, js = _state(te), _state(je)
    np.testing.assert_array_equal(ts["frame_idx"], js["frame_idx"])
    assert ts["frame_idx"].tolist() == [2, 3]
    for got, want in zip(ts["rec"], js["rec"]):
        tol = REC_STEPS * 2.0 ** -8 * np.abs(want).max() + 2.0 ** -8
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert _iou(ts["prev_alpha"], js["prev_alpha"]) >= IOU_MIN


@pytest.mark.parametrize("name", ["rvm", "blaze_tracking"])
def test_recovery_after_a_failed_round(frames, face_trees, name):
    """A round that fails after its first group wrote its rows: the state
    is the snapshot's cheap fields (face_center and has_center among them)
    over a cold EMA and a zeroed ``rec``."""
    _, te = _engines(name, face_trees)
    te.snapshot_every = 1
    for t in range(3):
        te.collect_round(te.dispatch_round([1, 1], [frames[t][:1], frames[t][1:]]))
    before = _state(te)
    te._round_step_for = lambda sizes: _raise_after_first_group(te)
    res = te.collect_round(te.dispatch_round([1, 1], [frames[3][:1], frames[3][1:]]))
    assert all(r["passthrough"] for r in res)
    after = _state(te)
    for k in ("affine", "has_affine", "frame_idx", "face_center", "has_center"):
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    assert not after["prev_alpha"].any() and not after["initialized"].any()
    assert all(not r.any() for r in after["rec"])
    if name == "blaze_tracking":
        assert before["has_center"].any() and np.abs(before["face_center"]).max() > 0
    else:
        assert len(after["rec"]) == 4
    del te._round_step_for
    res = te.collect_round(te.dispatch_round([1, 1], [frames[4][:1], frames[4][1:]]))
    assert not any(r["passthrough"] for r in res)


@pytest.mark.parametrize("name", ZOO)
def test_call_families_serve_the_presets(frames, name):
    """process, process_chunked (chunks of one stream) and
    dispatch/collect serve each preset alike (the port alone; seeded
    weights, nano and femto with the face path off so that no stream's
    face round depends on the chunk): the alpha within 1e-5 (the
    convolutions see other batch sizes), the state's counters equal."""
    over = {"face_path": False} if name.startswith("fast_int8") else {}
    engines = [Engine(S, preset(name, **GEOM, **over), seed=0, device="cpu") for _ in range(3)]
    for e in engines:
        e.face_min_interval_s = 0.0
        e.admit_all()
    for f in frames[:3]:
        a = engines[0].process(f)
        b = engines[1].process_chunked(f, 1)
        c = engines[2].collect(engines[2].dispatch(f))
        for r in (b, c):
            assert not r["passthrough"]
            np.testing.assert_allclose(_np(r["alpha"]), _np(a["alpha"]), rtol=0, atol=1e-5)
    for e in engines[1:]:
        for k in ("frame_idx", "has_affine", "has_center"):
            np.testing.assert_array_equal(_host(getattr(e.state, k)),
                                          _host(getattr(engines[0].state, k)))
        assert len(e.state.rec) == len(engines[0].state.rec)


def test_full_snapshot_restores_rec(frames, face_trees):
    """With state_snapshot_every the recovery restores the whole state
    the failing round's dispatch saw, ``rec`` included, exactly."""
    _, te = _engines("rvm", face_trees)
    te.snapshot_every = te.state_snapshot_every = 1
    for t in range(2):
        te.collect_round(te.dispatch_round([1, 1], [frames[t][:1], frames[t][1:]]))
    before = _state(te)
    te._round_step_for = lambda sizes: _raise_after_first_group(te)
    res = te.collect_round(te.dispatch_round([1, 1], [frames[2][:1], frames[2][1:]]))
    assert all(r["passthrough"] for r in res)
    after = _state(te)
    for k in ("prev_alpha", "affine", "has_affine", "initialized", "frame_idx"):
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    assert all(np.abs(r).max() > 0 for r in after["rec"])
    for got, want in zip(after["rec"], before["rec"]):
        np.testing.assert_array_equal(got, want)


def _raise_after_first_group(te):
    rs = te._range_step

    def step(full_state, frames_list, bgs, knobs, face_last, now, mi):
        rs(full_state, 0, frames_list[0], bgs, knobs, face_last, now, mi, 1)
        raise RuntimeError("injected failure in the round's second group")
    return step
