"""The production rotation over ``Engine(mesh=...)`` on 8 CPU shards: the
StreamScheduler with groups [11, 5], which do not align with the shards'
two rows (the reference's tests/test_mesh_rotation.py), per-group
``step_pipelined`` (``dispatch_range``) and fused rounds
(``dispatch_round``), 3 rounds, and the fast route's native FramePool
rounds, whose ``(packed, lanes)`` input splits on the lanes' stream axis 1.

Against the port's one-device engine: bit for bit with the face path off;
with it on, ``face_applied`` and ``frame_idx`` exactly, the rest within
the reference's mesh bars (tests/torch_mesh_engines.py).  Against the
reference's mesh engine over the same fused rounds (the per-group
rotation: tests/test_torch_mesh_pipelined.py): ``frame_idx``, the face
clock's stamped streams and ``has_affine`` exactly, ``prev_alpha`` within
the reference's mesh bar 2e-2 (tests/test_mesh_rotation.py:65) on the
streams no affine warps, and each group's alpha IoU 0.99 (a warped stream
moves by a few pixels between the two packages' bf16 face models, as
tests/test_torch_rounds.py finds on one device).
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

from tests.torch_mesh_engines import (
    CPU8,
    GEOM,
    ROUNDS,
    S,
    SIZES,
    STATE_TOL,
    as_np,
    assert_mesh_close,
    check_against_reference,
    port_engine,
    port_weights,
    rotate,
)
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu_torch import parallel
from video_stream_segmenetation_tpu_torch.runtime.presets import preset
from video_stream_segmenetation_tpu_torch.service.engine import Engine

FAST = dict(refine_alpha_src="lowres", guide_kernel_unfold=True, guide_source="host")


@lru_cache(maxsize=None)
def _pair(fused: bool, face: bool):
    mesh = parallel.make_mesh(8, devices=CPU8)
    got, want = port_engine(mesh, face), port_engine(None, face)
    return got, rotate(got, fused), want, rotate(want, fused)


@pytest.mark.parametrize("face", [False, True], ids=["face_off", "face_on"])
@pytest.mark.parametrize("fused", [False, True], ids=["pipelined", "fused"])
def test_rotation_matches_one_device(fused, face):
    eng, got, one, want = _pair(fused, face)
    assert len(got) == len(want) == ROUNDS * len(SIZES)
    assert len(eng._states) == 8
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["slots"] == w["slots"] and not g["passthrough"], i
        if face:
            assert_mesh_close(g, w, f"group result {i}")
        else:
            for k in ("frame", "alpha", "face_applied", "det_score", "face_prior_params"):
                assert torch.equal(g[k], w[k]), (i, k)
    st, st1 = eng.state, one.state
    assert torch.equal(st.frame_idx, st1.frame_idx) and int(st.frame_idx.min()) >= ROUNDS
    assert torch.equal(eng._face_last_dev > -1e8, one._face_last_dev > -1e8)
    if face:
        np.testing.assert_allclose(as_np(st.prev_alpha), as_np(st1.prev_alpha), rtol=0,
                                   atol=STATE_TOL)
        assert sum(as_np(g["face_applied"]).sum() for g in got) >= 2
    else:
        for k in ("prev_alpha", "affine", "has_affine", "initialized"):
            assert torch.equal(getattr(st, k), getattr(st1, k)), k


def test_pool_lanes_split_on_the_stream_axis():
    """The fast route over the native FramePool: each round's groups come
    as (packed, lanes [48, rows, 8, 16]) and every piece takes its streams'
    lanes; fused rounds equal one device's bit for bit (face path off)."""
    mesh = parallel.make_mesh(8, devices=CPU8)
    st = preset("fast_int8_pico", face_path=False, **FAST, **GEOM)
    engs = [Engine(S, st, device="cpu", mesh=m, **port_weights()) for m in (mesh, None)]
    assert all(e.host_lanes for e in engs)
    got, want = (rotate(e, fused=True, pool=True) for e in engs)
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g["frame"], w["frame"]) and torch.equal(g["alpha"], w["alpha"]), i
    assert torch.equal(engs[0].state.prev_alpha, engs[1].state.prev_alpha)
    assert torch.equal(engs[0].state.frame_idx, engs[1].state.frame_idx)


def test_fused_rounds_match_the_reference_mesh_engine():
    check_against_reference(*_pair(True, True)[:2], fused=True)
