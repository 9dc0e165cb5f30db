"""The port's step rollout against the reference's ``make_step_rollout`` on
fast_int8_pico (80x160, mask 32x64, the trained pico weights, face off,
S=4; tests/torch_rollout_engines.py) as the preset stands, n=3, the
reference's rollout jitted with its Pallas kernels in interpret mode (the
fast route: tests/test_torch_rollout_fast.py); the weight epsilon on the
int8 serving dict against the reference's.  Tolerances as
tests/test_torch_rollout.py's (pico: the refined alpha 4e-3 a step, bf16;
new_prev 2e-5 a step; one u8 step a step).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tests import torch_rollout_engines as RE
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu.runtime import rollout as JR
from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.runtime import rollout as TR

N = RE.N
CASES = [("pico", "buffer", "xor"), ("pico", "reduce", "weights"), ("pico", "buffer", False)]


@pytest.fixture(scope="module")
def pairs():
    return {}


@pytest.mark.parametrize("kind,acc,perturb", CASES)
def test_step_rollout_matches_reference(pairs, kind, acc, perturb):
    RE.assert_step_rollout_matches(RE.pair(pairs, kind), kind, acc, perturb)


def test_perturb_params_matches_reference(pairs):
    """The weight epsilon on the int8 serving dict: every float leaf in its
    own dtype (the stem's bf16 weights rounded in bf16), the int8 weights
    unchanged, against the reference's tree (bf16 stem) perturbed by the
    reference."""
    je, te = RE.pair(pairs, "pico")
    jq = je.bundle.matte_params
    for i in (1, 2):
        jp = RE._np(JR._perturb_params(jq, jnp.asarray(i)))
        tp = TR._perturb_params(te.matte_params, i)
        want = bridge.load_quantized(jp)
        assert set(tp) == set(want)
        for name, leaf in want.items():
            got = tp[name]
            if isinstance(leaf, dict):
                for k in leaf:
                    np.testing.assert_array_equal(got[k], leaf[k], err_msg=f"{name}/{k}")
                    assert got[k].dtype == te.matte_params[name][k].dtype
            else:
                np.testing.assert_array_equal(got, leaf, err_msg=name)
    assert not np.array_equal(TR._perturb_params(te.matte_params, 1)["stem_b"],
                              te.matte_params["stem_b"])

