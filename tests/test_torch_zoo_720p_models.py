"""The branch, rvm and u2 presets at 720p with the trained weights against
the JAX Engine, as tests/test_torch_zoo_720p.py holds the others (its
helpers and measure: u2's 320x320 alpha taken to the ground truth's
288x512 grid by nearest taps on both sides).  The reference's least IoU is
the bar chip_smoke.py holds the card to."""

import pytest

from tests.test_torch_zoo_720p import run_iou
from tests.torch_threads import one_torch_thread  # noqa: F401

RUNS = ("branch", "rvm", "u2")


@pytest.mark.parametrize("name", RUNS)
def test_trained_engine_iou_720p(name, record_property):
    assert min(run_iou(name, record_property)) > 0.5
