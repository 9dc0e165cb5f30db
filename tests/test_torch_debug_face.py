"""The face subpath's bench-only ``debug_stage`` tokens through the
compacted face path (tests/torch_rollout_engines.py's ``pico_face``:
fast_int8_pico, 80x160, mask 32x64, the trained pico and 128 face models,
S=4, at a step whose cadence fires): 'fd_stub' (a fixed box and score in
place of the detector's forward), 'fd_only' (the detector alone: no
prior, no update), 'fd_only,fd_stub' and 'no_lmk' (the detector and the
prior, no update); the port's make_step against the reference's, one step
from the reference engine's state, the reference jitted with its Pallas
kernels in interpret mode.  Tolerances: tests/torch_rollout_engines.py::
STEP_BARS (det_score 1e-2, the prior one mask pixel, the affine 0.3 mask
pixels and 1e-2, the refined alpha 4e-3).
"""

import pytest

from tests import torch_rollout_engines as RE
from tests.torch_threads import one_torch_thread  # noqa: F401

CASES = ("fd_stub", "fd_only", "fd_only,fd_stub", "no_lmk")


@pytest.fixture(scope="module")
def pairs():
    return {}


@pytest.mark.parametrize("debug_stage", CASES)
def test_face_token_matches_reference(pairs, debug_stage):
    jres, tres, fj = RE.step_both(RE.pair(pairs, "pico_face"), "pico_face", debug_stage)
    RE.assert_step_matches(jres, tres, fj, "pico_face", debug_stage)
    to = tres[1]
    fired = bool(to["det_score"].ne(0).any())
    assert fired  # the cadence fires at this step
    if "fd_only" in debug_stage:
        assert not to["face_applied"].any() and not to["face_has_prior"].any()
    if debug_stage == "no_lmk":
        assert not to["face_applied"].any() and to["face_has_prior"].any()
    if debug_stage == "fd_stub":
        # the fixed box passes the detector's threshold on the firing stream
        assert to["face_has_prior"].any()
