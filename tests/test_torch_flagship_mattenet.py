"""The flagship's MatteNet job (train/flagship.py's ``mattenet``: one
class, with the semantic and detail heads the matting loss reads) on the
port's ``fit`` against the reference's at 96x160, batch 2
(tests/torch_flagship_jobs.py: one step's loss and gradient in f32 and
bf16, BatchNorm statistics included, three steps of ``fit`` in f32); the
three outputs' grids with one class and four, and the seeded tree given
back by ``tree()``.
"""

import numpy as np
import pytest
import torch

from tests import torch_flagship_jobs as FJ
from tests import torch_train_helpers as H
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu_torch.models.modnet import MatteNet


@pytest.fixture(scope="module")
def grads():
    return FJ.grads_of(["mattenet"])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gradients_match_reference(grads, dtype):
    FJ.check_grads(grads, "mattenet", dtype)


def test_fit_f32_losses_match_reference(monkeypatch):
    FJ.check_fit(monkeypatch, "mattenet")


@pytest.mark.parametrize("k", [1, 4])
def test_mattenet_outputs_and_tree(k):
    """The MatteNet's three outputs at their grids (their values are held
    by the fit and gradient tests), and tree() gives the loaded tree back."""
    from video_stream_segmenetation_tpu_torch.models.modnet import init_mattenet_params

    tree = init_mattenet_params(k, k)
    port = MatteNet(tree, device="cpu")
    out = port(torch.zeros((2, 96, 160, 3)))
    tail = () if k == 1 else (k,)
    assert {n: tuple(v.shape) for n, v in out.items()} == {
        "alpha": (2, 96, 160, *tail), "semantic": (2, 6, 10, *tail), "detail": (2, 24, 40, *tail)}
    back = H.leaves(port.tree())
    assert back.keys() == H.leaves(tree).keys()
    assert all(np.array_equal(back[p], v) for p, v in H.leaves(tree).items())
