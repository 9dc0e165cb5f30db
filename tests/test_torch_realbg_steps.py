"""One step of the flagship and realbg jobs (train/realbg.py; the active job's:
tests/test_torch_realbg_steps_active.py)
against the reference's tools' own losses (tests/torch_realbg_helpers.py's
``run_tool``), on the same batch of the job's data (the reference's data
function at a key), the same tree (the tool's flax init) and a small
geometry, in f32 and bf16: the flagship's pico MatteNetHD and the active
MatteNet through the serving-chain loss (losses.make_pipeline_loss), the
realbg job's MatteNet at width 0.75 through the matting loss.  Bars
(tests/torch_realbg_helpers.py::assert_step_close): f32, the loss within
1e-5 relative and every leaf's gradient cosine at least 0.9999; bf16, the
loss within 1e-2 relative and each leaf's cosine at least ``min(0.99, 1 -
2 (1 - cos(reference bf16, reference f32)))``.
"""

import pytest

from tests import torch_realbg_helpers as RH
from tests.torch_threads import one_torch_thread  # noqa: F401

B = 2
# the MatteNet's encoder reaches stride 32: at least a 2x3 grid there
GEOM = {"flagship": dict(hw=(40, 80), batch=B), "realbg": dict(hw=(64, 96), batch=B)}


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    return RH.job_steps(tmp_path_factory.mktemp("realbg"), GEOM)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("job", list(GEOM))
def test_job_step_matches_the_tool(steps, job, dtype):
    ref, got = steps[job, dtype]
    RH.assert_step_close(ref, got, dtype, ref_f32=steps[job, "f32"][0])
