"""The port's step rollout against the reference's ``make_step_rollout`` on
fast_int8_pico's fast route (refine_alpha_src='lowres',
guide_kernel_unfold=True, guide_source='host': the head-grid logits and
the host's guide lanes into the fast refine; 80x160, mask 32x64, the
trained pico weights, face off, S=4; tests/torch_rollout_engines.py), n=3,
the reference's rollout jitted with its Pallas kernels in interpret mode;
and against the port's own sequential steps, bit for bit.  Tolerances as
tests/test_torch_rollout.py's (the refined alpha 4e-3 a step, bf16;
new_prev 2e-5 a step; one u8 step a step).
"""

import pytest

from tests import torch_rollout_engines as RE
from tests.torch_threads import one_torch_thread  # noqa: F401

N = RE.N
CASES = [("pico_fast", "buffer", "weights"), ("pico_fast", "reduce", "xor")]


@pytest.fixture(scope="module")
def pairs():
    return {}


@pytest.mark.parametrize("kind,acc,perturb", CASES)
def test_step_rollout_matches_reference(pairs, kind, acc, perturb):
    RE.assert_step_rollout_matches(RE.pair(pairs, kind), kind, acc, perturb)


def test_step_rollout_equals_sequential_steps(pairs):
    """The fast route's rollout (frames a (packed, lanes) tuple, both
    tagged) is the port's own n sequential make_step calls, bit for bit."""
    _, te = RE.pair(pairs, "pico_fast")
    frames = te._ingest(RE.frames_for("pico_fast", 2))[1][0]
    assert isinstance(frames, tuple)
    RE.assert_rollout_equals_sequential_steps(te, frames)
