"""One step of the u2 and multiclass_pico jobs (train/realbg.py; the rvm
job's: tests/test_torch_realbg_rvm.py) against the reference's tools' own
losses (tests/torch_realbg_helpers.py::variant_steps), in f32 and bf16,
at the bars of
tests/torch_realbg_helpers.py::assert_step_close (f32: the loss within
1e-5 relative, every leaf's gradient cosine at least 0.9999; bf16: the
loss within 1e-2 relative, each leaf's cosine at least ``min(0.99, 1 - 2
(1 - cos(reference bf16, reference f32)))``), at a small geometry, on
photos the test writes.

- u2: the tool's L1 + 0.5 BCE closure on a batch of its three-way data
  function, the same batch to both sides;
- rvm and multiclass_pico: the tools' closures draw their batch inside the
  loss, so their sources (the photo-background data function, the
  procedural and face scenes) hand them the port's renders of the
  reference's draws of that key, and the port's loss gets
  realbg.render_mix of the same draws: both compose the same parts (the
  two-way batch served down and rolled over 2 frames; the class-mixed
  batch and its class simplex).
"""

import pytest

from tests import torch_realbg_helpers as RH
from tests.torch_threads import one_torch_thread  # noqa: F401

GEOM = {"u2": dict(hw=(32, 32), batch=4, render_hw=(40, 64)),
        "multiclass_pico": dict(hw=(40, 80), batch=4, small_hw=(40, 60), small_batch=4)}


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    return RH.variant_steps(tmp_path_factory.mktemp("realbg"), GEOM)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("job", list(GEOM))
def test_variant_job_step_matches_the_tool(steps, job, dtype):
    ref, got = steps[job, dtype]
    RH.assert_step_close(ref, got, dtype, ref_f32=steps[job, "f32"][0])
