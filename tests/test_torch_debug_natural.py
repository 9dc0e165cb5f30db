"""The bench-only ``debug_stage`` tokens on the natural layout and with K
classes: the port's make_step against the reference's with the same
``debug_stage``, one step from the reference engine's state
(tests/torch_rollout_engines.py::step_both, S=4, face off): the natural
float MatteNet at 48x64 (the reference rollout test's engine; the refine
kernel's plain version against the reference's Pallas kernel in interpret
mode), multiclass_fast_pico (the int8 K=4 pico over packed frames, mask
at the 8x16 stem grid) and multiclass (the K=4 MatteNet at mask 32x64),
seed-0 trees.  With K classes 'model_only' serves the raw class maps (no
EMA, no renormalisation) and 'no_composite' the frames.  Tolerances:
tests/torch_rollout_engines.py::STEP_BARS.
"""

import pytest

from tests import torch_rollout_engines as RE
from tests.torch_threads import one_torch_thread  # noqa: F401

CASES = [("natural", ds) for ds in ("model_only", "no_composite", "model_only,no_composite",
                                    "no_morph", "no_bilateral", "no_guide")]
CASES += [("mc_pico", ds) for ds in ("model_only", "no_composite")]
CASES += [("mc_natural", ds) for ds in ("model_only", "model_only,no_composite")]


@pytest.fixture(scope="module")
def pairs():
    return {}


@pytest.mark.parametrize("kind,debug_stage", CASES)
def test_debug_step_matches_reference(pairs, kind, debug_stage):
    jres, tres, fj = RE.step_both(RE.pair(pairs, kind), kind, debug_stage)
    RE.assert_step_matches(jres, tres, fj, kind, debug_stage)
    tns, to = tres
    if kind.startswith("mc") and "model_only" in debug_stage:
        # the raw maps: not renormalised by the EMA, carried as the state
        assert to["class_alpha"].shape[-1] == RE.K
        assert bool((tns.rec[0] == to["class_alpha"]).all())
