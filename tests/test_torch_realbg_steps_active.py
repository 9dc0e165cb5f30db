"""One step of the active job (train/realbg.py: the natural layout's
MatteNet through the serving-chain loss on the three-way batch) against
the reference's tools/finetune_active_realbg.py, in f32 and bf16, at the
bars and by the means of tests/test_torch_realbg_steps.py.
"""

import pytest

from tests import torch_realbg_helpers as RH
from tests.torch_threads import one_torch_thread  # noqa: F401

# the MatteNet's encoder reaches stride 32: at least a 2x3 grid there
GEOM = {"active": dict(hw=(64, 96), batch=2, render_hw=(80, 128))}


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    return RH.job_steps(tmp_path_factory.mktemp("realbg"), GEOM)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_active_step_matches_the_tool(steps, dtype):
    ref, got = steps["active", dtype]
    RH.assert_step_close(ref, got, dtype, ref_f32=steps["active", "f32"][0])
