"""One step of the rvm job (train/realbg.py: the RecurrentMatteNet on the
two-way batch served down, unrolled over 2 rolled frames) against the
reference's tools/finetune_variants_realbg.py::finetune_rvm, in f32 and
bf16, at the bars and by the means of tests/test_torch_realbg_variants.py
(the tool's sources hand it the port's renders of the reference's draws).
"""

import pytest

from tests import torch_realbg_helpers as RH
from tests.torch_threads import one_torch_thread  # noqa: F401

GEOM = {"rvm": dict(hw=(32, 48), batch=4, unroll=2, render_hw=(40, 64))}


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    return RH.variant_steps(tmp_path_factory.mktemp("realbg"), GEOM)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rvm_step_matches_the_tool(steps, dtype):
    ref, got = steps["rvm", dtype]
    RH.assert_step_close(ref, got, dtype, ref_f32=steps["rvm", "f32"][0])
