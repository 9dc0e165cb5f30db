"""Engines and inputs of the mesh tests (tests/test_torch_mesh_engine.py,
tests/test_torch_mesh_rotation.py, tests/test_torch_mesh_pipelined.py):
fast_int8_pico at 80x160 / 32x64 with fd 64 and lmk 48, 16 streams, the trained pico and 128-pixel face trees
read once from checkpoints/ (the reference's engines get them as a
ModelBundle, so no flax init runs; the port's quantizes the same float tree,
bit for bit as the reference's quantizer), rendered people whose faces the
trained detector finds, the face path's wall-clock gate off.

The reference's own mesh bars (tests/test_parallel_train.py:90-91,
tests/test_mesh_rotation.py:65): composited frames within one u8 step with
fewer than 0.1 % of the pixels differing, prev_alpha and the refined alpha
within 2e-2.
"""

from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

S = 16
SIZES = [11, 5]  # unaligned with 8 shards of 2 rows (the reference's test)
GEOM = dict(frame_hw=(80, 160), mask_hw=(32, 64), fd_size=64, lmk_size=48)
ROOT = Path(__file__).resolve().parents[1]
CPU8 = [torch.device("cpu")] * 8
FRAME_STEP, FRAME_SHARE, STATE_TOL = 1, 1e-3, 2e-2
ROUNDS = 3


@lru_cache(maxsize=None)
def trees():
    """The trained float trees ``(pico, face, lmk)``, numpy leaves."""
    import jax

    from video_stream_segmenetation_tpu.utils.checkpoint import restore_params

    return tuple(jax.tree_util.tree_map(np.asarray, restore_params(str(ROOT / "checkpoints" / n)))
                 for n in ("mattenet_hd10_pico", "facefinder_128", "landmarknet_128"))


def port_weights() -> dict:
    from video_stream_segmenetation_tpu_torch import bridge

    matte, face, lmk = trees()
    return {"params": bridge.params_from_jax(matte, 10, "pico"),
            "face_params": {"face": bridge.float_tree(face), "lmk": bridge.float_tree(lmk)}}


def jax_engine(mesh, face_path: bool = True):
    """The reference's Engine on the same trees: the fused refine, as the
    port's, and the int8 decoder through XLA (the faster of its two routes
    on the CPU; tests/test_torch_trunk.py holds the port's trunk against
    it within 1e-5)."""
    from video_stream_segmenetation_tpu import models as jmodels
    from video_stream_segmenetation_tpu.runtime.pipeline import ModelBundle
    from video_stream_segmenetation_tpu.runtime.presets import preset as jax_preset
    from video_stream_segmenetation_tpu.service import Engine as JaxEngine

    matte, face, lmk = trees()
    bundle = ModelBundle(jmodels.MatteNetHD(stem_stride=10, head_upsample=4, decoder="pico"),
                         matte, jmodels.FaceFinder(input_size=GEOM["fd_size"]), face,
                         jmodels.LandmarkNet(), lmk)
    st = jax_preset("fast_int8_pico", use_fused_refine=True, int8_decoder_impl="xla",
                    face_path=face_path, **GEOM)
    eng = JaxEngine(num_streams=S, statics=st, bundle=bundle, donate_state=False, mesh=mesh)
    eng.face_min_interval_s = 0.0
    return eng


def port_engine(mesh=None, face_path: bool = True):
    from video_stream_segmenetation_tpu_torch.runtime.presets import preset
    from video_stream_segmenetation_tpu_torch.service.engine import Engine

    eng = Engine(S, preset("fast_int8_pico", face_path=face_path, **GEOM), device="cpu",
                 mesh=mesh, **port_weights())
    eng.face_min_interval_s = 0.0
    return eng


@lru_cache(maxsize=None)
def frames(rounds: int = 4) -> list:
    """Per step ``[S, 80, 160, 3]`` u8: stream s from clip s % 2 at frame
    t + s // 4, rendered people with faces."""
    from video_stream_segmenetation_tpu_torch.utils.clips import articulated_clip

    clips = [np.asarray(articulated_clip(n_frames=rounds + S // 4, hw=(80, 160), seed=sd,
                                         features=True, device="cpu").frames)
             for sd in (2, 1)]
    return [np.stack([clips[s % 2][t + s // 4] for s in range(S)]) for t in range(rounds)]


def backgrounds() -> list:
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, (80, 160, 3), dtype=np.uint8) for _ in range(S)]


def as_np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def frames_close(a, b) -> tuple[int, float]:
    """``(largest u8 difference, share of pixels that differ)``."""
    d = np.abs(as_np(a).astype(np.int32) - as_np(b).astype(np.int32))
    return int(d.max()), float((d > 0).mean())


def assert_mesh_close(got: dict, want: dict, what: str) -> None:
    """Two step results within the reference's mesh bars."""
    assert np.array_equal(as_np(got["face_applied"]), as_np(want["face_applied"])), what
    big, share = frames_close(got["frame"], want["frame"])
    assert big <= FRAME_STEP and share < FRAME_SHARE, (what, big, share)
    np.testing.assert_allclose(as_np(got["alpha"]), as_np(want["alpha"]), rtol=0,
                               atol=STATE_TOL, err_msg=what)


def rotate(eng, fused: bool, pool: bool = False, scheduler=None) -> list:
    """ROUNDS rounds of ``frames()`` through a StreamScheduler over
    ``eng`` in groups SIZES (the port's, or ``scheduler``: the
    reference's): fused rounds or per-group step_pipelined, the frames
    pushed into the native pool (``pool``) or handed over by a
    frame_source.  Returns every group's result, in the order collected."""
    from video_stream_segmenetation_tpu_torch.runtime.scheduler import StreamScheduler

    scheduler = scheduler or StreamScheduler
    fr = frames()
    at = {"t": 0}
    if pool:
        sched = scheduler(eng, group_sizes=SIZES, fused_rounds=fused)
        assert sched.pool is not None, sched.pool_error
    else:
        sched = scheduler(eng, use_native_pool=False, group_sizes=SIZES, fused_rounds=fused,
                          frame_source=lambda i0, i1: fr[at["t"]][i0:i1])
    sched.admit_all()
    outs = []
    for r in range(ROUNDS):
        at["t"] = r
        if pool:
            for s in range(S):
                sched.push_frame(s, fr[r][s])
        if fused:
            outs.extend(sched.step_round() or [])
        else:
            for _ in SIZES:
                got = sched.step_pipelined()
                if got is not None:
                    outs.append(got)
    tail = sched.drain()
    outs.extend(tail if isinstance(tail, list) else [tail])
    sched.stop()
    return outs


def check_against_reference(eng, got: list, fused: bool) -> None:
    """The same rotation on the reference's mesh engine (its 8 virtual
    devices), held as tests/test_torch_mesh_rotation.py's docstring says."""
    from video_stream_segmenetation_tpu import parallel as jparallel
    from video_stream_segmenetation_tpu.runtime.scheduler import StreamScheduler as JaxSched

    je = jax_engine(jparallel.make_mesh())
    want = rotate(je, fused, scheduler=JaxSched)
    assert len(je.state.prev_alpha.sharding.device_set) == 8
    assert len(want) == len(got) == ROUNDS * len(SIZES)
    for i, (g, j) in enumerate(zip(got, want)):
        assert g["slots"] == tuple(j["slots"]), i
        ja, ta = as_np(j["alpha"]) > 0.5, as_np(g["alpha"]) > 0.5
        assert (ja & ta).sum() / max((ja | ta).sum(), 1) >= 0.99, i
    jst, st = je.state, eng.state
    np.testing.assert_array_equal(as_np(st.frame_idx), as_np(jst.frame_idx))
    assert as_np(st.frame_idx).min() >= ROUNDS
    np.testing.assert_array_equal(as_np(eng._face_last_dev) > -1e8,
                                  as_np(je._face_last_dev) > -1e8)
    np.testing.assert_array_equal(as_np(st.has_affine), as_np(jst.has_affine))
    still = ~as_np(jst.has_affine).astype(bool)
    assert still.any()
    np.testing.assert_allclose(as_np(st.prev_alpha)[still], as_np(jst.prev_alpha)[still],
                               rtol=0, atol=STATE_TOL)
