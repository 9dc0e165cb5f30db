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
    assert set(touts[-1]) == set(jouts[-1])
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
        Engine(1, preset("fast_int8_pico", frame_hw=(80, 160), mask_hw=(32, 64)),
               device="cpu")


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
