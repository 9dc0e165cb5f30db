"""The port's step rollout (runtime/rollout.py) against the reference's
``make_step_rollout`` on the CPU, n=3 chained steps, the reference's
rollout jitted with its Pallas kernels in interpret mode, on the reference
test's natural float engine at 48x64 (tests/torch_rollout_engines.py,
face off, S=4) in both acc_modes and all three perturb modes
(fast_int8_pico: tests/test_torch_rollout_pico.py); also the harness
pieces (the frame tag, the accumulators' wrapping, the timer) against the
reference's, and the rollout against the port's own sequential steps; the
natural engine's round rollout against the reference's.

Tolerances: the per-step bars of the port's step-parity tests
(tests/test_torch_rounds.py and test_torch_s2d_options.py), times n: the
refined alpha 4e-3 a step (bf16 out on pico; 5e-3 on the natural layout's
f32), new_prev 2e-5 a step (1e-3 natural), a composited frame value one
u8 step a step (counted modulo 256: the buffers wrap); the 'reduce' sums
a stream's values, so their bars are those times the values a stream has
(the frame's at most 1 % of its values one step apart, as the s2d bars).
The state's integer and boolean fields are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_rollout_engines as RE
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu.runtime import rollout as JR
from video_stream_segmenetation_tpu_torch.runtime import make_step_rollout
from video_stream_segmenetation_tpu_torch.runtime import rollout as TR

N = RE.N
CASES = [("natural", acc, p) for acc in ("buffer", "reduce") for p in ("xor", "weights", False)]


@pytest.fixture(scope="module")
def pairs():
    return {}


@pytest.mark.parametrize("kind,acc,perturb", CASES)
def test_step_rollout_matches_reference(pairs, kind, acc, perturb):
    RE.assert_step_rollout_matches(RE.pair(pairs, kind), kind, acc, perturb)


def test_round_rollout_matches_reference(pairs):
    """The natural engine's round rollout (groups [3, 1], n=3, no
    perturbation), as tests/test_torch_rollout_round.py holds pico's."""
    RE.assert_round_rollout_matches(RE.pair(pairs, "natural"), "natural", "buffer", False)


def test_step_rollout_equals_sequential_steps(pairs):
    """n chained steps of the rollout are the port's own n sequential
    make_step calls on the tagged frames, bit for bit, in the state and
    both buffers."""
    _, te = RE.pair(pairs, "natural")
    frames = te._ingest(RE.frames_for("natural", 2))[1][0]
    RE.assert_rollout_equals_sequential_steps(te, frames)


def test_perturb_matches_reference():
    """The frame tag: u8 XORed (both arrays of a (packed, lanes) tuple),
    float arrays added to; iteration 0 and even iterations unchanged."""
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (2, 8, 16, 300), dtype=np.uint8)
    lanes = rng.integers(0, 256, (48, 2, 8, 16), dtype=np.uint8)
    f32 = rng.random((2, 4, 4)).astype(np.float32)
    for i in range(4):
        jp = JR._perturb((jnp.asarray(u8), jnp.asarray(lanes)), jnp.asarray(i))
        tp = TR._perturb((torch.from_numpy(u8), torch.from_numpy(lanes)), i)
        for j, t in zip(jp, tp):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        np.testing.assert_array_equal(TR._perturb(torch.from_numpy(f32), i).numpy(),
                                      np.asarray(JR._perturb(jnp.asarray(f32), jnp.asarray(i))))


def test_accumulators_wrap_as_the_reference():
    """The u8 buffer wraps modulo 256 and the int32 'reduce' frame sums wrap
    past 2^31 (a 720p frame sums to at most 705 M: four of them pass it),
    as the reference's; the alpha sums keep the alpha's dtype (bf16)."""
    frame = np.full((2, 720, 1280, 3), 255, np.uint8)
    frame[1] = 200
    alpha = np.full((2, 8, 16), 0.75, np.float32)
    jo = {"frame": jnp.asarray(frame), "alpha": jnp.asarray(alpha, jnp.bfloat16)}
    to = {"frame": torch.from_numpy(frame), "alpha": torch.from_numpy(alpha).to(torch.bfloat16)}
    for mode in ("buffer", "reduce"):
        jacc, tacc = JR._acc_init(jo, mode), TR._acc_init(to, mode)
        for _ in range(3):
            jacc, tacc = JR._acc_add(jacc, jo, mode), TR._acc_add(tacc, to, mode)
        assert tacc[0].dtype == (torch.uint8 if mode == "buffer" else torch.int32)
        assert tacc[1].dtype == torch.bfloat16
        np.testing.assert_array_equal(tacc[0].numpy(), np.asarray(jacc[0]))
        np.testing.assert_array_equal(RE.as_np(tacc[1]), RE.as_np(jacc[1]))
    assert int(tacc[0][0]) < 0  # 4 x 705 M wrapped


def test_time_rollout_on_the_cpu():
    """The timer's keys and its slope on the host clock (no events on the
    CPU); a card is refused where there is none."""
    calls = []

    def roll(x, n):
        calls.append(n)
        return x

    res = TR.time_rollout([roll, roll], (0,), 1, 3, reps=2, device="cpu")
    assert len(res) == 2 and res[0]["event_ms"] is None
    assert set(res[0]["host_ms"]) == {"slope", "fixed", "slopes"}
    assert len(res[0]["host_ms"]["slopes"]) == 2
    assert calls == [1, 1] + [1, 3, 1, 3] * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            TR.time_rollout(roll, (0,), 1, 3)


def test_rollout_refuses_unknown_modes(pairs):
    _, te = RE.pair(pairs, "natural")
    with pytest.raises(ValueError, match="acc_mode"):
        make_step_rollout(te.model, te.statics, acc_mode="sum")
    with pytest.raises(ValueError, match="perturb"):
        make_step_rollout(te.model, te.statics, perturb="noise")
    with pytest.raises(ValueError, match="perturbed"):
        make_step_rollout(te.model, te.statics, perturb="weights")
