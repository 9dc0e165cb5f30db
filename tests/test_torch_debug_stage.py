"""The bench-only ``debug_stage`` tokens (runtime/config.py::DEBUG_TOKENS)
on the s2d layout: the port's make_step against the reference's with the
same ``debug_stage``, one step from the reference engine's warm state
(tests/torch_rollout_engines.py::step_both), on fast_int8_pico (80x160,
mask 32x64, the trained pico weights, S=4, face off) as it stands:
'model_only', 'no_composite', both, and 'no_guide' here; the refine
kernel's tokens in tests/test_torch_debug_refine.py, the fast route's in
test_torch_debug_fast.py, the face tokens in test_torch_debug_face.py, the
natural layout and K classes in test_torch_debug_natural.py.  Also the
refusal of an unknown token.  The reference's steps are jitted with their
Pallas kernels in interpret mode.

Tolerances: tests/torch_rollout_engines.py::STEP_BARS, the port's one-step
bars (the refined alpha 4e-3 in bf16, the model's alpha under
'model_only' held to the same; new_prev 2e-5; the frame one u8 step on at
most 1 % of its values; det_score 1e-2, the prior one mask pixel, the
affine 0.3 mask pixels and 1e-2).
"""

import pytest
import torch

from tests import torch_rollout_engines as RE
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu_torch.runtime.config import DEBUG_TOKENS
from video_stream_segmenetation_tpu_torch.runtime.pipeline import check_statics
from video_stream_segmenetation_tpu_torch.runtime.presets import preset

CASES = [("pico", ds) for ds in ("model_only", "no_composite", "model_only,no_composite",
                                 "no_guide")]


@pytest.fixture(scope="module")
def pairs():
    return {}


@pytest.mark.parametrize("kind,debug_stage", CASES)
def test_debug_step_matches_reference(pairs, kind, debug_stage):
    pair = RE.pair(pairs, kind)
    jres, tres, fj = RE.step_both(pair, kind, debug_stage)
    RE.assert_step_matches(jres, tres, fj, kind, debug_stage)
    tns, to = tres
    if "model_only" in debug_stage:
        # the raw model alpha, f32, is the new state and (a copy) the output
        assert to["alpha"].dtype == torch.float32 and torch.equal(tns.prev_alpha, to["alpha"])
        assert to["alpha"] is not tns.prev_alpha


@pytest.mark.parametrize("bad", ["no_morh", "model_only,composite", "full"])
def test_unknown_token_is_refused(bad):
    with pytest.raises(ValueError, match="unknown token") as err:
        check_statics(preset("fast_int8_pico", debug_stage=bad))
    assert any(t in str(err.value) for t in bad.split(","))
    for ds in ("", " model_only , no_composite ", ",".join(DEBUG_TOKENS)):
        check_statics(preset("fast_int8_pico", debug_stage=ds))
