"""The bench-only ``debug_stage`` tokens on fast_int8_pico's fast route
(refine_alpha_src='lowres', guide_kernel_unfold=True, guide_source='host':
the head-grid logits and the host's guide lanes into the fast refine;
80x160, mask 32x64, the trained pico weights, S=4, face off): the port's
make_step against the reference's, one step from the reference engine's
state (tests/torch_rollout_engines.py::step_both), the reference jitted
with its Pallas kernels in interpret mode.  'model_only' must turn the
low-res alpha off (the composite then takes the mask's alpha),
'no_guide' hand the kernel zero lanes, 'no_morph' reach the fast form's
variant.  Tolerances: tests/torch_rollout_engines.py::STEP_BARS.
"""

import pytest
import torch

from tests import torch_rollout_engines as RE
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu_torch.runtime.pipeline import fast_routing
from video_stream_segmenetation_tpu_torch.runtime.presets import preset

CASES = ("model_only", "no_guide", "no_morph", "no_bilateral")


@pytest.fixture(scope="module")
def pairs():
    return {}


@pytest.mark.parametrize("debug_stage", CASES)
def test_debug_step_matches_reference(pairs, debug_stage):
    pair = RE.pair(pairs, "pico_fast")
    jres, tres, fj = RE.step_both(pair, "pico_fast", debug_stage)
    RE.assert_step_matches(jres, tres, fj, "pico_fast", debug_stage)
    assert isinstance(fj, tuple)
    if debug_stage == "model_only":
        assert tres[1]["alpha"].dtype == torch.float32


def test_model_only_turns_the_lowres_alpha_off(pairs):
    """On the fast route the head-grid logits go to the refine kernel; with
    'model_only' the refine is skipped, so the routing takes the full-mask
    alpha (the reference's runtime/pipeline.py:508) and the lanes stay."""
    _, te = RE.pair(pairs, "pico_fast")
    st = preset("fast_int8_pico", debug_stage="model_only", **RE.S2D, **RE.FAST)
    route, full = fast_routing(te.model, st), fast_routing(te.model, te.statics)
    assert full["use_lowres_alpha"] and not route["use_lowres_alpha"]
    assert route["host_lanes"] == full["host_lanes"] is True
