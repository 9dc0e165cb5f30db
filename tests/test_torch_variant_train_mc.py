"""The port's saliency and K=4 MatteNet trainers (train/variants.py::u2_loss,
class_loss) against the reference's (tools/train_variants.py): the
SaliencyNet at 64x64 and the K=4 MatteNet at 96x160, batch 2
(tests/torch_variant_jobs.py): one step's loss and gradient, BatchNorm
statistics included, at the bars of tests/torch_train_helpers.py.
"""

import pytest

from tests import torch_variant_jobs as VJ
from tests.torch_threads import one_torch_thread  # noqa: F401

NAMES = ("u2", "multiclass")


@pytest.fixture(scope="module")
def grads():
    return VJ.grads_of(NAMES)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", NAMES)
def test_gradients_match_reference(grads, name, dtype):
    VJ.check_grads(grads, name, dtype)


@pytest.mark.parametrize("dilation", [1, 2, 4, 8])
def test_bf16_depthwise_kernel_gradient_on_cpu(dilation):
    """The e-ASPP's depthwise convs (models/backbones.py::conv2d_same) in
    bf16 on the CPU: the kernel's and the input's gradients within 1e-2
    relative L2 of the f32 conv's of the same bf16 values, at every rate
    (PyTorch's CPU bf16 depthwise kernel gradient at dilation > 1 is wrong
    unless conv2d_same routes around it)."""
    import numpy as np
    import torch

    from video_stream_segmenetation_tpu_torch.models.backbones import conv2d_same

    rng = np.random.default_rng(dilation)
    c = 64
    for _ in range(4):
        x = torch.tensor(rng.standard_normal((2, c, 18, 32)), dtype=torch.bfloat16)
        x = x.contiguous(memory_format=torch.channels_last)
        w = torch.tensor(rng.standard_normal((c, 1, 3, 3)), dtype=torch.float32)
        go = torch.tensor(rng.standard_normal((2, 2 * c, 18, 32)), dtype=torch.bfloat16)
        got, want = [], []
        for dt, out in ((torch.bfloat16, got), (torch.float32, want)):
            xs, ws = x.to(dt).requires_grad_(True), w.clone().requires_grad_(True)
            y = conv2d_same(xs, ws.to(dt), dilation=dilation, groups=c)
            # the gradient arrives as a channel slice of a concat's, as in EASPP
            y = torch.cat([y, y.detach()], dim=1)
            out += torch.autograd.grad(y, (xs, ws), go.to(dt))
        for g, r in zip(got, want):
            g = g.to(torch.float32)
            assert torch.isfinite(g).all()
            assert float((g - r).norm() / r.norm()) <= 1e-2
