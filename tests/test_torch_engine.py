"""The port's serving slice vs the JAX Engine: fast_int8_pico with the face
path off, 3 steps on the same frames, backgrounds, knobs and trained
weights (checkpoints/mattenet_hd10_pico).  The JAX engine runs both Pallas
kernels (trunk megakernel, fused temporal refine) in interpret mode.

Tolerances: refined alpha 4e-3 (bf16 out), the new_prev state 2e-5, the
composited frame at most one u8 step.
"""

import jax
import numpy as np
import pytest
import torch

from video_stream_segmenetation_tpu.runtime.presets import preset as jax_preset
from video_stream_segmenetation_tpu.service import Engine as JaxEngine
from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.runtime.presets import preset
from video_stream_segmenetation_tpu_torch.service.engine import Engine

S = 2
GEOM = dict(face_path=False, frame_hw=(80, 160), mask_hw=(32, 64))
PICO_CKPT = "checkpoints/mattenet_hd10_pico"


def _frames(rng, t):
    """A bright ellipse moving over noise, per stream."""
    f = (rng.random((S, 80, 160, 3)) * 120).astype(np.uint8)
    yy, xx = np.mgrid[0:80, 0:160]
    for s in range(S):
        cx, cy = 60 + 8 * t + 20 * s, 40 + 3 * t
        inside = ((xx - cx) / 28.0) ** 2 + ((yy - cy) / 30.0) ** 2 <= 1.0
        f[s][inside] = (220, 190, 170)
    return f


@pytest.fixture(scope="module")
def engines():
    rng = np.random.default_rng(0)
    jst = jax_preset("fast_int8_pico", int8_decoder_impl="trunk",
                     use_fused_refine=True, **GEOM)
    je = JaxEngine(num_streams=S, statics=jst, rng_seed=0, donate_state=False)
    je.load_matting_params(PICO_CKPT)
    q = jax.tree_util.tree_map(np.asarray, je.bundle.matte_params)
    te = Engine(S, preset("fast_int8_pico", **GEOM), params=bridge.load_quantized(q),
                device="cpu")
    for e in (je, te):
        e.admit_all()
    bgs = [rng.integers(0, 256, (80, 160, 3), dtype=np.uint8) for _ in range(S)]
    knobs = dict(ema=0.7, use_bilateral=False, gamma=0.6)
    outs = []
    for e in (je, te):
        for s in range(S):
            e.set_background(s, bgs[s])
        e.set_knobs(1, **knobs)
        frame_rng = np.random.default_rng(1)
        steps = [e.process(_frames(frame_rng, t)) for t in range(3)]
        outs.append(steps)
    return je, te, outs


def test_jax_engine_served_every_step(engines):
    """The reference's catch-all would hide a failed step: its health
    must be ok after the run."""
    je, _, outs = engines
    for out in outs[0]:
        assert out["metrics"]["health"]["state"] == "ok"
    assert je.health.total_failures == 0


@pytest.mark.parametrize("step", [0, 1, 2])
def test_alpha_matches_jax_engine(engines, step):
    _, _, (jouts, touts) = engines
    want = np.asarray(jouts[step]["alpha"], np.float32)
    got = touts[step]["alpha"].float().numpy()
    assert got.shape == want.shape == (S, 32, 64)
    assert touts[step]["alpha"].dtype == torch.bfloat16
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-3)
    assert 0.05 < got.mean() < 0.95  # not a constant plane


@pytest.mark.parametrize("step", [0, 1, 2])
def test_frame_matches_jax_engine(engines, step):
    _, _, (jouts, touts) = engines
    want = np.asarray(jouts[step]["frame"]).astype(np.int32)
    got = touts[step]["frame"].numpy().astype(np.int32)
    assert got.shape == want.shape == (S, 80, 160, 3)
    assert np.abs(got - want).max() <= 1


def test_state_matches_jax_engine(engines):
    je, te, _ = engines
    np.testing.assert_allclose(te.state.prev_alpha.numpy(),
                               np.asarray(je.state.prev_alpha), rtol=0, atol=2e-5)
    np.testing.assert_array_equal(te.state.frame_idx.numpy(), np.asarray(je.state.frame_idx))
    np.testing.assert_array_equal(te.state.affine.numpy(), np.asarray(je.state.affine))
    np.testing.assert_array_equal(te.state.initialized.numpy(), np.asarray(je.state.initialized))


def test_outputs_carry_reference_keys(engines):
    _, _, (jouts, touts) = engines
    # the reference's Engine keeps face_applied to itself; the port's
    # returns it beside the other face outputs
    assert set(touts[-1]) == set(jouts[-1]) | {"face_applied"}
    np.testing.assert_array_equal(touts[-1]["face_has_prior"].numpy(),
                                  np.asarray(jouts[-1]["face_has_prior"]))
    np.testing.assert_array_equal(touts[-1]["face_prior_params"].numpy(),
                                  np.asarray(jouts[-1]["face_prior_params"]))
    np.testing.assert_array_equal(touts[-1]["det_score"].numpy(),
                                  np.asarray(jouts[-1]["det_score"]))


def test_engine_cuda_without_card_raises():
    """Entry points default to the card and never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(1, preset("fast_int8_pico", **GEOM))


def test_engine_refuses_unported_statics():
    with pytest.raises(NotImplementedError):
        Engine(1, preset("fast_int8_pico", face_tracking="translation",
                         frame_hw=(80, 160), mask_hw=(32, 64)), device="cpu")


@pytest.mark.parametrize("override", [
    {"affine_mode": "reference"}, {"guide_kernel_unfold": "yes"}, {"refine_alpha_src": "half"},
    {"face_input": "frames"}, {"face_compact": False}, {"matting_decoder": "lite"},
    {"int8_conv_impl": "mosaic"}, {"int8_head_impl": "f32"}, {"warp_impl": "exact"},
    {"matting_precision": "bf16"}])
def test_engine_refuses_unserved_options(override):
    """The presets are served as they stand; any other value of a static
    the step reads is refused, not silently served another way."""
    for name in ("fast_int8_pico", "fast_int8_micro", "fast_int8", "fast_int8_lite"):
        with pytest.raises(NotImplementedError, match=next(iter(override))):
            Engine(1, preset(name, **override, **FACE_GEOM), device="cpu")


def test_engine_refuses_color_background():
    """Only per-stream image backgrounds are ported."""
    with pytest.raises(NotImplementedError, match="background"):
        Engine(1, preset("fast_int8_pico", background="color", **GEOM), device="cpu")


def test_failed_step_raises_and_is_recorded(monkeypatch):
    """No passthrough: a failing step raises every time; health counts the
    failures, reads 'down' after three in a row and 'ok' after a success."""
    eng = Engine(1, preset("fast_int8_pico", **GEOM), device="cpu")
    eng.admit_all()
    frames = np.zeros((1, 80, 160, 3), np.uint8)
    step = eng._step

    def broken(*args):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(eng, "_step", broken)
    for n in range(1, 4):
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            eng.process(frames)
        h = eng.stats()["health"]
        assert h["consecutive_failures"] == h["total_failures"] == n
        assert h["state"] == ("down" if n == 3 else "ok")
    monkeypatch.setattr(eng, "_step", step)
    eng.process(frames)
    h = eng.stats()["health"]
    assert (h["state"], h["consecutive_failures"], h["total_failures"]) == ("ok", 0, 3)
    assert h["last_error"] == "RuntimeError: kernel launch failed"


def test_engine_rejects_misshaped_frames():
    eng = Engine(2, preset("fast_int8_pico", **GEOM), device="cpu")
    with pytest.raises(ValueError, match="frames"):
        eng.process(np.zeros((2, 80, 150, 3), np.uint8))


# ---- the face path on: the presets as they stand ---------------------------

FACE_S, FACE_T = 2, 8
FACE_GEOM = dict(frame_hw=(80, 160), mask_hw=(32, 64), fd_size=64, lmk_size=48)
FACE_RUNS = {
    # run: (JAX overrides: the Pallas kernels 'auto' picks on the TPU,
    # in interpret mode; matting checkpoint; face checkpoints); a run's
    # preset is its name up to a '+', the overrides of both engines after
    # it (FACE_OVERRIDES)
    "fast_int8_pico": (dict(int8_decoder_impl="trunk"), PICO_CKPT,
                       ("checkpoints/facefinder_128", "checkpoints/landmarknet_128")),
    # the plane-prior body of the fused temporal refine (prior_impl='plane')
    "fast_int8_pico+plane": (dict(int8_decoder_impl="trunk", debug_face_outputs=True),
                             PICO_CKPT,
                             ("checkpoints/facefinder_128", "checkpoints/landmarknet_128")),
    "fast_int8_micro": (dict(int8_decoder_impl="pallas"), "checkpoints/mattenet_hd10_micro",
                        ("checkpoints/facefinder", "checkpoints/landmarknet")),
    # plans B and C: their decoder levels as the TPU runs them (plan C's
    # through the Pallas decoder kernel; plan B has none)
    "fast_int8": (dict(int8_decoder_impl="pallas"), "checkpoints/mattenet_hd10",
                  ("checkpoints/facefinder", "checkpoints/landmarknet")),
    "fast_int8_lite": (dict(int8_decoder_impl="pallas"), "checkpoints/mattenet_hd10_lite",
                       ("checkpoints/facefinder", "checkpoints/landmarknet")),
}


FACE_OVERRIDES = {"plane": {"prior_impl": "plane"}}


def _face_frames():
    """Rendered people whose faces the trained detectors find: stream 0
    from one clip, stream 1 from another, FACE_T frames each."""
    from video_stream_segmenetation_tpu.utils.clips import articulated_clip

    clips = [articulated_clip(n_frames=FACE_T, hw=(80, 160), seed=sd, features=True).frames
             for sd in (2, 1)]
    return [np.stack([clips[s][t] for s in range(FACE_S)]) for t in range(FACE_T)]


def _drive(e, frames, before_step=None):
    """8 steps; at step 3 stream 0 is evicted and re-admitted, so its
    cadence restarts.  With S=2 a round takes K=1 stream: step 0 serves
    stream 0 (stream 1 overflows and skips), step 3 stream 0 again, step 6
    stream 1.  Returns per-step outputs with ``applied`` (host) added."""
    e.face_min_interval_s = 0.0
    e.admit_all()
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


def _host_state(e):
    return {k: np.asarray(getattr(e.state, k)).copy() for k in
            ("prev_alpha", "affine", "has_affine", "initialized", "frame_idx")}


@pytest.fixture(scope="module", params=sorted(FACE_RUNS))
def face_engines(request):
    """The JAX Engine (Pallas kernels in interpret mode) and the port's,
    the face path on, trained weights, the wall-clock gate off; plus a
    teacher-forced port run that starts every step from the JAX state and
    takes the JAX step's face prior, so that its alpha is held to the
    refine stage's own tolerance."""
    from video_stream_segmenetation_tpu_torch.runtime import pipeline as TPL
    from video_stream_segmenetation_tpu_torch.runtime.state import StreamState

    run = request.param
    name, _, extra = run.partition("+")
    over = FACE_OVERRIDES.get(extra, {})
    jover, ckpt, (fd, lm) = FACE_RUNS[run]
    je = JaxEngine(num_streams=FACE_S, statics=jax_preset(
        name, use_fused_refine=True, **jover, **over, **FACE_GEOM), rng_seed=0,
        donate_state=False)
    je.load_matting_params(ckpt)
    je.load_face_params(fd, lm)
    npt = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    kw = dict(params=bridge.load_quantized(npt(je.bundle.matte_params)),
              face_params={"face": bridge.float_tree(npt(je.bundle.face_params)),
                           "lmk": bridge.float_tree(npt(je.bundle.lmk_params))},
              device="cpu")
    frames = _face_frames()
    jouts = _drive(je, frames)
    te = Engine(FACE_S, preset(name, **over, **FACE_GEOM), **kw)
    touts = _drive(te, frames)

    # teacher-forced: the JAX state before each step, the JAX step's prior
    tf = Engine(FACE_S, preset(name, **over, **FACE_GEOM), **kw)
    real = TPL.face_subpath_compact
    step_t = {}

    def forced_face(*args, **kwargs):
        prior, has_prior, aff, has_upd, score = real(*args, **kwargs)
        j = jouts[step_t["t"]]
        key = "face_prior_plane" if "face_prior_plane" in j else "face_prior_params"
        return (torch.tensor(np.asarray(j[key])),
                torch.tensor(np.asarray(j["face_has_prior"])), aff, has_upd, score)

    def set_state(t):
        step_t["t"] = t
        tf.state = StreamState(**{k: torch.tensor(v) for k, v in
                                  jouts[t]["state_in"].items()})

    TPL.face_subpath_compact = forced_face
    try:
        forced = _drive(tf, frames, before_step=set_state)
    finally:
        TPL.face_subpath_compact = real
    return name, jouts, touts, forced


def test_face_decisions_match_jax_engine(face_engines):
    """face_applied and face_has_prior equal at every step; the rounds go
    where the cadence and the overflow rule send them."""
    name, jouts, touts, _ = face_engines
    for t, (j, g) in enumerate(zip(jouts, touts)):
        np.testing.assert_array_equal(g["applied"], j["applied"], err_msg=f"step {t}")
        np.testing.assert_array_equal(g["face_applied"].numpy(), j["applied"])
        np.testing.assert_array_equal(g["face_has_prior"].numpy(),
                                      np.asarray(j["face_has_prior"]))
    has_prior = np.stack([np.asarray(j["face_has_prior"]) for j in jouts])
    assert has_prior[[0, 3], 0].all() and has_prior[6, 1]
    assert has_prior.sum() == 3  # no other round: stream 1 overflowed at step 0
    assert np.stack([j["applied"] for j in jouts]).any()


def test_face_outputs_match_jax_engine(face_engines):
    """det_score within 1e-2 (bf16 face models, scores clear of the 0.6
    threshold by 0.04 or more), the prior scalars within one mask pixel
    (the floor/ceil box conversion; the plane run has no scalars, its
    plane is held through the teacher-forced steps), the merged affine
    within 0.3 mask pixels in translation and 1e-2 in its linear part."""
    name, jouts, touts, _ = face_engines
    for j, g in zip(jouts, touts):
        js = np.asarray(j["det_score"])
        assert np.all((js == 0) | (np.abs(js - 0.6) > 0.04))
        np.testing.assert_allclose(g["det_score"].numpy(), js, rtol=0, atol=1e-2)
        assert ("face_prior_params" in g) == ("face_prior_params" in j)
        if "face_prior_params" in g:
            np.testing.assert_allclose(g["face_prior_params"].numpy(),
                                       np.asarray(j["face_prior_params"]), rtol=0, atol=1.0)
        ja, ga = j["state"]["affine"], g["state"]["affine"]
        np.testing.assert_allclose(ga[:, [2, 5]], ja[:, [2, 5]], rtol=0, atol=0.3)
        np.testing.assert_allclose(ga[:, [0, 1, 3, 4]], ja[:, [0, 1, 3, 4]], rtol=0,
                                   atol=1e-2)
        np.testing.assert_array_equal(g["state"]["has_affine"], j["state"]["has_affine"])
        np.testing.assert_array_equal(g["state"]["frame_idx"], j["state"]["frame_idx"])


@pytest.mark.parametrize("step", range(FACE_T))
def test_face_alpha_matches_jax_engine(face_engines, step):
    """Teacher-forced (the JAX state and prior fed in): new_prev within
    1e-4, the refined alpha within 4e-3 (pico: bf16 out; micro: f32 out,
    where the threshold/gamma stage's (a - 0.06)^0.4 turns a 1e-7 float32
    difference of the model alpha just above the noise cutoff into up to
    (1e-7 / 0.89)^0.4 ~ 2e-3), the composited frame within one u8 step.
    new_prev is 1e-7 apart at every step but one: at micro's step 5 it is
    6.3e-5 apart, 0.45 (one minus the EMA weight) of 1.4e-4, which is how
    far the reference's Pallas decoder departs from its own XLA graph on
    that frame (one u1 lattice step; the reference's XLA path inside the
    jitted step takes it too).  The port's plain trunk equals the
    standalone XLA graph there (tests/test_torch_micro.py)."""
    name, jouts, _, forced = face_engines
    j, g = jouts[step], forced[step]
    bf16 = name == "fast_int8_pico"
    assert g["alpha"].dtype == (torch.bfloat16 if bf16 else torch.float32)
    np.testing.assert_allclose(g["alpha"].float().numpy(), np.asarray(j["alpha"], np.float32),
                               rtol=0, atol=4e-3)
    np.testing.assert_allclose(g["state"]["prev_alpha"], j["state"]["prev_alpha"],
                               rtol=0, atol=1e-4)
    diff = np.abs(g["frame"].numpy().astype(np.int32) - np.asarray(j["frame"]).astype(np.int32))
    assert diff.max() <= 1
