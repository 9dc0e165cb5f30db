"""Shared runner of the natural layout's engine comparisons (the ``fast``
preset and ``active``'s options): the JAX Engine and the port's over the
same 8 steps of tests/test_torch_active.py (its frames, backgrounds, the
AFFINE0 state, stream 0 evicted and re-admitted at step 3), plus a
teacher-forced port run that starts each step from the JAX state and takes
the JAX step's face prior.  The JAX side gets a ``ModelBundle`` (no flax
init) and ``use_fused_refine=True, debug_face_outputs=True``, so that its
Pallas kernels run in interpret mode and its prior is exported."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_active import _drive
from video_stream_segmenetation_tpu import models
from video_stream_segmenetation_tpu.runtime.pipeline import ModelBundle
from video_stream_segmenetation_tpu.runtime.presets import preset as jax_preset
from video_stream_segmenetation_tpu.service import Engine as JaxEngine
from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.runtime import pipeline as TPL
from video_stream_segmenetation_tpu_torch.runtime.presets import preset
from video_stream_segmenetation_tpu_torch.runtime.state import StreamState
from video_stream_segmenetation_tpu_torch.service.engine import Engine

GEOM = dict(frame_hw=(80, 160), mask_hw=(32, 64), fd_size=64, lmk_size=48)
ENGINE_T = 8


def face_trees() -> dict:
    """The trained face models at fd 256 / lmk 192, from the committed
    exports (tests/test_torch_weights.py holds them equal to the
    checkpoints)."""
    return {n: bridge.load_export(bridge.WEIGHTS_DIR / f"{n}.npz")
            for n in ("facefinder", "landmarknet")}


@functools.lru_cache(maxsize=1)
def engine_frames() -> list:
    """tests/test_torch_active.py's frames: rendered people, stream 0 from
    one clip and stream 1 from another, ENGINE_T frames each (rendered once
    a process; callers must not write to them)."""
    from video_stream_segmenetation_tpu.utils.clips import articulated_clip

    clips = [articulated_clip(n_frames=ENGINE_T, hw=(80, 160), seed=sd, features=True).frames
             for sd in (2, 1)]
    return [np.stack([clips[s][t] for s in range(2)]) for t in range(ENGINE_T)]


def run_engines(name: str, over: dict, jax_model, tree: dict, frames: list):
    """``(jouts, touts, forced)``: the JAX Engine of preset ``name`` with
    ``over`` and ``jax_model`` over ``tree``, the port's Engine on the same
    tree, and the teacher-forced port run, each driven by ``_drive``."""
    faces = face_trees()
    jst = jax_preset(name, use_fused_refine=True, debug_face_outputs=True, **over, **GEOM)
    bundle = ModelBundle(jax_model, jax.tree_util.tree_map(jnp.asarray, tree),
                         models.FaceFinder(input_size=GEOM["fd_size"]), faces["facefinder"],
                         models.LandmarkNet(), faces["landmarknet"])
    je = JaxEngine(num_streams=2, statics=jst, bundle=bundle, donate_state=False)
    rng = np.random.default_rng(3)
    bgs = [rng.integers(0, 256, (80, 160, 3), dtype=np.uint8) for _ in range(2)]
    jouts = _drive(je, frames, bgs)
    kw = dict(params=tree, face_params={"face": faces["facefinder"],
                                        "lmk": faces["landmarknet"]}, device="cpu")
    st = preset(name, **over, **GEOM)
    touts = _drive(Engine(2, st, **kw), frames, bgs)

    tf = Engine(2, st, **kw)
    real = TPL.face_subpath_compact
    step_t = {}

    def forced_face(*args, **kwargs):
        _, _, aff, has_upd, score = real(*args, **kwargs)
        j = jouts[step_t["t"]]
        key = "face_prior_plane" if "face_prior_plane" in j else "face_prior_params"
        return (torch.tensor(np.asarray(j[key])), torch.tensor(np.asarray(j["face_has_prior"])),
                aff, has_upd, score)

    def set_state(t):
        step_t["t"] = t
        tf.state = StreamState(**{k: torch.tensor(v) for k, v in jouts[t]["state_in"].items()},
                               rec=tf.state.rec)

    TPL.face_subpath_compact = forced_face
    try:
        forced = _drive(tf, frames, bgs, before_step=set_state)
    finally:
        TPL.face_subpath_compact = real
    return jouts, touts, forced


def assert_face_decisions_match(jouts, touts) -> None:
    """face_applied and the prior's presence equal at every step, det_score
    within 1e-2, the affine state within 0.6 mask pixels in translation and
    3e-2 in its linear part (tests/test_torch_active.py's tolerances)."""
    for t, (j, g) in enumerate(zip(jouts, touts)):
        np.testing.assert_array_equal(g["applied"], j["applied"], err_msg=f"step {t}")
        np.testing.assert_allclose(g["det_score"].numpy(), np.asarray(j["det_score"]),
                                   rtol=0, atol=1e-2)
        ja, ga = j["state"]["affine"], g["state"]["affine"]
        np.testing.assert_allclose(ga[:, [2, 5]], ja[:, [2, 5]], rtol=0, atol=0.6)
        np.testing.assert_allclose(ga[:, [0, 1, 3, 4]], ja[:, [0, 1, 3, 4]], rtol=0,
                                   atol=3e-2)
        np.testing.assert_array_equal(g["face_has_prior"].numpy(),
                                      np.asarray(j["face_has_prior"]))
    assert np.stack([j["applied"] for j in jouts]).any()
