"""The flagship's plans A and B (train/flagship.py's ``mattenet_hd`` and
``mattenet_hd10`` jobs) on the port's ``fit`` against the reference's, at
80x160, batch 2 (tests/torch_flagship_jobs.py): one step's loss and
gradient in f32 and bf16, BatchNorm statistics included, and three steps
of ``fit`` in f32 at the job's learning rate.
"""

import pytest

from tests import torch_flagship_jobs as FJ
from tests.torch_threads import one_torch_thread  # noqa: F401

KEYS = ("plan_a", "full")


@pytest.fixture(scope="module")
def grads():
    return FJ.grads_of(KEYS)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("key", KEYS)
def test_gradients_match_reference(grads, key, dtype):
    FJ.check_grads(grads, key, dtype)


@pytest.mark.parametrize("key", KEYS)
def test_fit_f32_losses_match_reference(monkeypatch, key):
    FJ.check_fit(monkeypatch, key)
