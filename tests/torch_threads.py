"""A fixture for the port's heavier CPU test modules: one PyTorch
intra-op thread while the module runs, the previous count restored after.
The tier-1 run puts several test workers on the machine's cores, and
PyTorch's OpenMP threads spin under that load (tests/test_torch_active.py
ran four times slower with them).  A module takes it with
``from tests.torch_threads import one_torch_thread  # noqa: F401``."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
