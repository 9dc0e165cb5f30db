"""``Engine(mesh=...)`` on 8 CPU shards (virtual shards: the port's form of
the reference's forced host device count) against the port's one-device
Engine and against the reference's ``Engine(mesh=parallel.make_mesh())`` on
its 8 virtual devices: fast_int8_pico at 80x160 / 32x64, trained weights,
16 streams (tests/torch_mesh_engines.py).

The scenario: every slot admitted with its background, a knob staged,
``process`` three times (at the first step every stream fires, more than
K = ceil(16 / 6) = 3: the face path takes the first three in slot order,
across the shards' boundary, which a per-shard selection would not),
``dispatch``/``collect``, an eviction and a readmission, a ``dispatch_range``
that takes the recovery snapshot and one that fails, so that the state is
restored from it, and ``process`` again.

Against the one-device port: bit for bit with the face path off; with it
on, ``face_applied`` and ``frame_idx`` exactly and the rest within the
reference's mesh bars.  Against the reference's mesh engine: the face
decisions and ``frame_idx`` exactly, and the rest within the bars
tests/test_torch_rounds.py holds the one-device engines to with the face
path on (the bf16 face models' boxes differ by fractions of a pixel, so a
stream the merged affine warps moves by a few pixels): new_prev within
2e-5 and frames within one u8 step on the streams no affine warps, alpha
IoU 0.99 on all.
"""

import dataclasses
from functools import lru_cache

import numpy as np
import pytest
import torch

from tests.torch_mesh_engines import (
    CPU8,
    FRAME_SHARE,
    FRAME_STEP,
    S,
    as_np,
    assert_mesh_close,
    backgrounds,
    frames,
    frames_close,
    jax_engine,
    port_engine,
)
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu_torch import parallel
from video_stream_segmenetation_tpu_torch.runtime import rollout
from video_stream_segmenetation_tpu_torch.runtime.presets import preset
from video_stream_segmenetation_tpu_torch.service.engine import Engine

KEYS = ("frame", "alpha", "face_applied", "det_score", "face_has_prior", "face_prior_params")


def _mesh():
    return parallel.make_mesh(8, devices=CPU8)


def _raise(*args, **kwargs):
    raise RuntimeError("injected failure")


def _state(eng) -> dict:
    """A copy of the state's fields (a one-device engine's are live)."""
    st = eng.state
    return {k: as_np(getattr(st, k)).copy() for k in ("prev_alpha", "affine", "has_affine",
                                                       "initialized", "frame_idx")}


def _scenario(eng) -> list:
    """The module docstring's calls; returns ``(label, result, state)`` a
    call."""
    fr, out = frames(), []
    eng.admit_all()
    for s, bg in enumerate(backgrounds()):
        eng.set_background(s, bg)
    eng.set_knobs(3, ema=0.5, gamma=1.3)
    for t in range(3):
        out.append((f"process {t}", eng.process(fr[t]), _state(eng)))
    out.append(("dispatch", eng.collect(eng.dispatch(fr[3])), _state(eng)))
    eng.evict(5)
    assert eng.admit() == 5
    out.append(("after readmission", eng.process(fr[0]), _state(eng)))
    eng.snapshot_every = 1
    out.append(("range", eng.collect_range(eng.dispatch_range(0, 11, fr[1][:11])),
                _state(eng)))
    eng._range_step = _raise
    failed = eng.collect_range(eng.dispatch_range(11, S, fr[2][11:]))
    del eng._range_step
    assert failed["passthrough"]
    out.append(("recovered", failed, _state(eng)))
    out.append(("after recovery", eng.process(fr[3]), _state(eng)))
    return out


@lru_cache(maxsize=None)
def _served(face: bool):
    mesh_eng, one_eng = port_engine(_mesh(), face), port_engine(None, face)
    return face, mesh_eng, _scenario(mesh_eng), _scenario(one_eng)


@pytest.fixture(scope="module", params=[False, True], ids=["face_off", "face_on"])
def served(request):
    return _served(request.param)


@pytest.fixture(scope="module")
def served_faces():
    return _served(True)


def test_mesh_state_lives_in_its_shards(served):
    _, eng, _, _ = served
    assert len(eng._states) == 8 and len(eng._knobs) == 8 and len(eng._bgs) == 8
    assert all(st.num_streams == 2 for st in eng._states)
    # the staged knob went to slot 3's shard: shard 1, row 1
    assert float(eng._knobs[1].ema[1]) == 0.5 and float(eng.knobs.ema[3]) == 0.5
    assert float(eng.knobs.gamma[2]) != 1.3
    assert eng.state.prev_alpha.shape == (S, 32, 64)


def test_mesh_matches_one_device(served):
    face, _, got, want = served
    assert [g[0] for g in got] == [w[0] for w in want]
    for (label, g, gs), (_, w, ws) in zip(got, want):
        assert g["passthrough"] == w["passthrough"], label
        np.testing.assert_array_equal(gs["frame_idx"], ws["frame_idx"], err_msg=label)
        np.testing.assert_array_equal(as_np(g["face_applied"]), as_np(w["face_applied"]),
                                      err_msg=label)
        if not face:  # bit for bit
            assert set(g) == set(w), label
            for k in KEYS:
                if k in w:
                    assert torch.equal(g[k], w[k]), (label, k)
            for k in gs:
                np.testing.assert_array_equal(gs[k], ws[k], err_msg=f"{label} {k}")
            continue
        if not g["passthrough"]:
            assert_mesh_close(g, w, label)
        np.testing.assert_allclose(gs["prev_alpha"], ws["prev_alpha"], rtol=0, atol=2e-2,
                                   err_msg=label)


def test_first_step_takes_the_first_k_fired_streams_over_all_shards(served_faces):
    """All 16 streams fire at the first step and K = 3: the first three in
    slot order (shards 0 and 1), where a per-shard selection (one a shard
    of two rows) would take slots 0, 2, 4, ..."""
    _, _, got, want = served_faces
    first = as_np(got[0][1]["det_score"]) > 0
    assert np.flatnonzero(first).tolist() == [0, 1, 2]
    assert np.array_equal(first, as_np(want[0][1]["det_score"]) > 0)
    assert sum(as_np(g["face_applied"]).sum() for _, g, _ in got) >= 2


def test_recovery_restores_the_snapshot_on_every_shard(served):
    _, _, got, _ = served
    before = dict((label, st) for label, _, st in got)
    rec = before["recovered"]
    # the cheap fields of the snapshot the failing dispatch took, a cold EMA
    np.testing.assert_array_equal(rec["frame_idx"], before["range"]["frame_idx"])
    np.testing.assert_array_equal(rec["affine"], before["range"]["affine"])
    assert not rec["initialized"].any() and not rec["prev_alpha"].any()


def test_mesh_matches_the_reference_mesh_engine(served_faces):
    """The port's and the reference's mesh engines over the same calls,
    the face path on (its decisions cross shards): process three times,
    then dispatch/collect."""
    _, _, got, _ = served_faces
    from video_stream_segmenetation_tpu import parallel as jparallel

    je = jax_engine(jparallel.make_mesh())
    je.admit_all()
    for s, bg in enumerate(backgrounds()):
        je.set_background(s, bg)
    je.set_knobs(3, ema=0.5, gamma=1.3)
    fr = frames()
    jouts = []
    for t in range(3):  # the reference reports the applied rounds through its clock
        before = je._last_face_at.copy()
        jouts.append((je.process(fr[t]), je._last_face_at != before))
    assert len(je.state.prev_alpha.sharding.device_set) == 8
    for (j, applied), (label, g, _) in zip(jouts, got):
        np.testing.assert_array_equal(as_np(g["face_applied"]).astype(bool), applied,
                                      err_msg=label)
        ja, ta = as_np(j["alpha"]) > 0.5, as_np(g["alpha"]) > 0.5
        assert (ja & ta).sum() / max((ja | ta).sum(), 1) >= 0.99, label
    jouts.append((je.collect(je.dispatch(fr[3])), None))
    jst = je.state
    np.testing.assert_array_equal(as_np(jst.frame_idx), got[3][2]["frame_idx"])
    np.testing.assert_array_equal(as_np(jst.has_affine), got[3][2]["has_affine"])
    still = ~as_np(jst.has_affine).astype(bool)
    np.testing.assert_allclose(got[3][2]["prev_alpha"][still], as_np(jst.prev_alpha)[still],
                               rtol=0, atol=2e-5)
    big, share = frames_close(got[3][1]["frame"][still],
                              np.asarray(jouts[3][0]["frame"])[still])
    assert big <= FRAME_STEP, (big, share)
    assert share < FRAME_SHARE or still.sum() < S, share


def _seeded(mesh=None):
    eng = Engine(S, preset("fast_int8_pico", frame_hw=(80, 160), mask_hw=(32, 64), fd_size=64,
                           lmk_size=48), device="cpu", mesh=mesh)
    eng.face_min_interval_s = 0.0
    eng.admit_all()
    return eng


def test_mesh_reads_refuse_writes():
    """On a mesh ``state``, ``knobs`` and ``backgrounds`` are copies gathered
    from the shards: a write through them raises, where it would be lost;
    a whole assignment splits over the shards.  A one-device engine's are
    its live trees."""
    eng = _seeded(_mesh())
    for write in (lambda: eng.state.frame_idx.__setitem__(0, 7),
                  lambda: eng.knobs.gamma.__setitem__(0, 2.0),
                  lambda: eng.backgrounds.__setitem__(0, 9)):
        with pytest.raises(RuntimeError, match="[Ii]nference"):
            write()
    st = eng.state
    eng.state = dataclasses.replace(st, frame_idx=torch.arange(S, dtype=torch.int32))
    assert [int(s.frame_idx[1]) for s in eng._states] == list(range(1, S, 2))
    eng.set_cadence_phases([3], [5])
    assert int(eng.state.frame_idx[3]) == 5 and int(eng._states[1].frame_idx[1]) == 5
    one = _seeded()
    one.state.frame_idx[0] = 7
    one.knobs.gamma[0] = 2.0
    assert int(one.state.frame_idx[0]) == 7 and float(one.knobs.gamma[0]) == 2.0


def test_mesh_snapshots_stay_on_their_shards():
    """The recovery snapshots are taken and restored shard by shard: the
    serving calls never gather the whole state (``_whole`` raises here),
    each shard's host copy holds its own rows, cheap and full alike."""
    eng = _seeded(_mesh())
    eng.snapshot_every = 1
    eng._whole = _raise
    fr = frames()
    assert not eng.collect(eng.dispatch(fr[0]))["passthrough"]
    res = eng.collect_round(eng.dispatch_round([11, 5], [fr[1][:11], fr[1][11:]]))
    assert not any(r["passthrough"] for r in res)
    snap = eng._snap_pending
    assert snap["kind"] == "cheap_packed" and len(snap["host"]) == 8
    assert all(tuple(t["packed"].shape)[0] == 2 for t in snap["host"])
    eng.state_snapshot_every = 1
    eng._range_step = _raise
    failed = eng.collect_range(eng.dispatch_range(3, 9, fr[2][3:9]))
    del eng._range_step, eng._whole
    assert failed["passthrough"]
    # the failing dispatch took a full snapshot and it was restored exactly
    assert eng._snap_pending is None and eng._snap["kind"] == "cheap_packed"
    st = eng.state
    assert st.initialized.all() and st.frame_idx.tolist() == [2] * S


def test_mesh_engine_refuses_streams_that_do_not_divide():
    with pytest.raises(ValueError, match="divide"):
        Engine(9, preset("fast_int8_pico", frame_hw=(80, 160), mask_hw=(32, 64), fd_size=64,
                         lmk_size=48), device="cpu", mesh=_mesh())


def test_rollouts_refuse_a_mesh_engine(served):
    _, eng, _, _ = served
    with pytest.raises(NotImplementedError, match="mesh"):
        rollout.engine_models(eng)
    with pytest.raises(NotImplementedError, match="mesh"):
        rollout.perturbed_models(eng)
