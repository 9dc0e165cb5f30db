"""The face path without compaction (``face_compact=False``: the face
models on all S streams, gated by the cadence) and ``affine_mode=
'reference'`` (the reference client's mask affine: tx and ty scaled only),
the port's Engine against the JAX Engine at 80x160 / mask 32x64, S=2, 8
steps: ``active`` (natural layout, seeded MatteNet, the trained face
models at fd 64 / lmk 48) and ``fast_int8_pico`` (s2d, trained weights).
Also the shared s2d runner of tests/test_torch_face_sources.py and
tests/test_torch_refface.py.

Each run is driven twice on the port: free-running, and teacher-forced
(every step starts from the JAX state and takes the JAX step's face prior),
so that the alpha is held to the refine stage's own tolerance.

Tolerances (tests/test_torch_face.py's for the same outputs), with their
reasons:
* face_applied, face_has_prior, has_affine, frame_idx (and with
  translation tracking the centre and has_center): equal;
* det_score within 1e-2 (one bf16 step of a logit in the sigmoid's
  steep middle; the reference graphs and the int8 models are closer);
* the prior scalars within one mask pixel (the floor/ceil box
  conversion);
* the affine state within 0.3 mask pixels in translation and 1e-2 in its
  linear part (bf16 landmarks through the Procrustes solve); the natural
  runs start from tests/test_torch_active.py's AFFINE0 and take its
  0.6 / 3e-2 (the low-pass mixes that start in);
* teacher-forced: the refined alpha within 4e-3 on s2d (bf16 out: one
  bf16 step near 1 plus exp/pow ulps) and 5e-3 on the natural layout
  (tests/test_torch_active.py's), new_prev within 1e-4 (s2d) and 1e-3
  (natural), the composited frame within one u8 step.
"""

import numpy as np
import pytest
import torch

from tests import torch_natural_engines as NE
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu import models as jm
from video_stream_segmenetation_tpu.runtime.pipeline import ModelBundle
from video_stream_segmenetation_tpu.runtime.presets import preset as jax_preset
from video_stream_segmenetation_tpu.service import Engine as JaxEngine
from video_stream_segmenetation_tpu.utils.checkpoint import restore_params
from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.models.modnet import init_mattenet_params
from video_stream_segmenetation_tpu_torch.runtime import pipeline as TPL
from video_stream_segmenetation_tpu_torch.runtime.presets import preset
from video_stream_segmenetation_tpu_torch.runtime.state import StreamState
from video_stream_segmenetation_tpu_torch.service.engine import Engine

S2D_GEOM = dict(frame_hw=(80, 160), mask_hw=(32, 64), fd_size=64, lmk_size=48)
PICO_CKPT = "checkpoints/mattenet_hd10_pico"
FACE_CKPTS = ("checkpoints/facefinder_128", "checkpoints/landmarknet_128")
STATE_KEYS = ("prev_alpha", "affine", "has_affine", "initialized", "frame_idx",
              "face_center", "has_center")


def _np(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _host_state(e):
    return {k: np.asarray(getattr(e.state, k)).copy() for k in STATE_KEYS}


def drive(e, frames, bgs, before_step=None):
    """8 steps; at step 3 stream 0 is evicted and re-admitted, so its
    cadence restarts."""
    e.face_min_interval_s = 0.0
    e.admit_all()
    for s in range(2):
        e.set_background(s, bgs[s])
    outs = []
    for t, f in enumerate(frames):
        if t == 3:
            e.evict(0)
            e.admit()
        if before_step is not None:
            before_step(t)
        state_in = _host_state(e)
        last = np.array(e._last_face_at)
        out = e.process(f)
        out["applied"] = np.array(e._last_face_at) != last
        out["state_in"], out["state"] = state_in, _host_state(e)
        outs.append(out)
    return outs


def run_s2d(over: dict, name: str = "fast_int8_pico", geom=None):
    """``(jouts, touts, forced)``: the JAX Engine of ``name`` with ``over``
    (the trained pico MatteNetHD, its trunk and refine in Pallas interpret
    mode; the trained 128 face models), the port's Engine on the same
    weights, and the teacher-forced port run, each driven by
    :func:`drive` over tests/torch_natural_engines.py's frames."""
    geom = S2D_GEOM if geom is None else geom
    restored = {c: restore_params(c) for c in (PICO_CKPT, *FACE_CKPTS)}
    jst = jax_preset(name, use_fused_refine=True, int8_decoder_impl="trunk", **over, **geom)
    bundle = ModelBundle(jm.MatteNetHD(stem_stride=10, head_upsample=4, decoder="pico"),
                         restored[PICO_CKPT], jm.FaceFinder(input_size=jst.fd_size),
                         restored[FACE_CKPTS[0]], jm.LandmarkNet(), restored[FACE_CKPTS[1]])
    je = JaxEngine(num_streams=2, statics=jst, bundle=bundle, donate_state=False)
    frames = NE.engine_frames()
    rng = np.random.default_rng(3)
    bgs = [rng.integers(0, 256, (80, 160, 3), dtype=np.uint8) for _ in range(2)]
    jouts = drive(je, frames, bgs)
    st = preset(name, **over, **geom)
    kw = dict(params=bridge.load_quantized(_np(je.bundle.matte_params)),
              face_params={"face": bridge.float_tree(_np(restored[FACE_CKPTS[0]])),
                           "lmk": bridge.float_tree(_np(restored[FACE_CKPTS[1]]))},
              device="cpu")
    touts = drive(Engine(2, st, **kw), frames, bgs)
    return jouts, touts, forced_run(Engine(2, st, **kw), st, jouts, frames, bgs)


def forced_run(tf, st, jouts, frames, bgs):
    """``tf`` driven with every step started from the JAX state before it
    and the JAX step's prior in place of its own (none with translation
    tracking: the prior is zero there)."""
    target = "face_subpath_compact" if st.face_compact else "face_subpath"
    real = getattr(TPL, target)
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

    setattr(TPL, target, forced_face)
    try:
        return drive(tf, frames, bgs, before_step=set_state)
    finally:
        setattr(TPL, target, real)


def assert_face_matches(jouts, touts, tr=0.3, lin=1e-2, prior_tol=1.0):
    """The free-running face outputs and state, step by step."""
    for t, (j, g) in enumerate(zip(jouts, touts)):
        msg = f"step {t}"
        np.testing.assert_array_equal(g["applied"], j["applied"], err_msg=msg)
        np.testing.assert_array_equal(g["face_applied"].numpy(), j["applied"], err_msg=msg)
        np.testing.assert_array_equal(g["face_has_prior"].numpy(),
                                      np.asarray(j["face_has_prior"]), err_msg=msg)
        np.testing.assert_allclose(g["det_score"].numpy(), np.asarray(j["det_score"]),
                                   rtol=0, atol=1e-2, err_msg=msg)
        if "face_prior_params" in j:
            np.testing.assert_allclose(g["face_prior_params"].numpy(),
                                       np.asarray(j["face_prior_params"]), rtol=0,
                                       atol=prior_tol, err_msg=msg)
        ja, ga = j["state"]["affine"], g["state"]["affine"]
        np.testing.assert_allclose(ga[:, [2, 5]], ja[:, [2, 5]], rtol=0, atol=tr, err_msg=msg)
        np.testing.assert_allclose(ga[:, [0, 1, 3, 4]], ja[:, [0, 1, 3, 4]], rtol=0, atol=lin,
                                   err_msg=msg)
        for k in ("has_affine", "frame_idx", "face_center", "has_center"):
            if k in j["state"]:
                np.testing.assert_array_equal(g["state"][k], j["state"][k], err_msg=msg)
    assert np.stack([j["applied"] for j in jouts]).any()


def assert_step_matches(j, g, alpha_tol, prev_tol):
    """One teacher-forced step: the refined alpha, new_prev, the frame."""
    np.testing.assert_allclose(g["alpha"].float().numpy(), np.asarray(j["alpha"], np.float32),
                               rtol=0, atol=alpha_tol)
    np.testing.assert_allclose(g["state"]["prev_alpha"], j["state"]["prev_alpha"], rtol=0,
                               atol=prev_tol)
    diff = np.abs(g["frame"].numpy().astype(np.int32) - np.asarray(j["frame"]).astype(np.int32))
    assert diff.max() <= 1


# ---- the runs ------------------------------------------------------------------

RUNS = {
    # (layout, overrides)
    "active_uncompacted": ("natural", {"face_compact": False}),
    # a mask of another aspect than the frame's (x0.5 across, x0.4 down),
    # where the two modes' affines differ
    "active_reference_affine": ("natural", {"affine_mode": "reference",
                                            "mask_hw": (32, 80)}),
    "pico_uncompacted": ("s2d", {"face_compact": False}),
}


@pytest.fixture(scope="module", params=sorted(RUNS))
def engines(request):
    layout, over = RUNS[request.param]
    if layout == "natural":
        runs = NE.run_engines("active", over, jm.MatteNet(), init_mattenet_params(0),
                              NE.engine_frames())
    else:
        runs = run_s2d(over)
    return (request.param, layout, *runs)


def test_face_outputs_match(engines):
    _, layout, jouts, touts, _ = engines
    if layout == "natural":
        assert_face_matches(jouts, touts, tr=0.6, lin=3e-2)
    else:
        assert_face_matches(jouts, touts)


def test_uncompacted_runs_every_firing_stream():
    """Without compaction both streams' cadence rounds run (step 0 serves
    stream 0 and stream 1 together; with compaction K=1 and stream 1
    overflows)."""
    frames = NE.engine_frames()
    st = preset("fast_int8_pico", face_compact=False, **S2D_GEOM)
    tree = {"face": bridge.load_export(bridge.WEIGHTS_DIR / "facefinder_128.npz"),
            "lmk": bridge.load_export(bridge.WEIGHTS_DIR / "landmarknet_128.npz")}
    e = Engine(2, st, face_params=tree, device="cpu")
    e.face_min_interval_s = 0.0
    e.admit_all()
    out = e.process(frames[0])
    assert out["face_has_prior"].tolist() == [True, True]


@pytest.mark.parametrize("step", range(NE.ENGINE_T))
def test_step_matches_teacher_forced(engines, step):
    _, layout, jouts, _, forced = engines
    if layout == "natural":
        assert_step_matches(jouts[step], forced[step], 5e-3, 1e-3)
    else:
        assert_step_matches(jouts[step], forced[step], 4e-3, 1e-4)


def test_reference_affine_differs_from_exact():
    """The reference client's mask affine keeps the linear part in video
    units: on a non-square scale its off-diagonal terms differ from the
    exact conjugation's, and tx, ty agree."""
    from video_stream_segmenetation_tpu_torch.ops.geometry import affine_video_to_mask

    a = torch.tensor([[0.9, -0.2, 10.0, 0.2, 0.9, -6.0]])
    ex = affine_video_to_mask(a, (720, 1280), (300, 512), "exact")
    ref = affine_video_to_mask(a, (720, 1280), (300, 512), "reference")
    torch.testing.assert_close(ex[:, [0, 2, 4, 5]], ref[:, [0, 2, 4, 5]])
    torch.testing.assert_close(ref[:, [1, 3]], a[:, [1, 3]])
    assert not torch.allclose(ex[:, [1, 3]], ref[:, [1, 3]])
    with pytest.raises(ValueError, match="mode"):
        affine_video_to_mask(a, (720, 1280), (288, 512), "bogus")
