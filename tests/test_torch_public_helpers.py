"""The reference's three small public helpers in the port, against the JAX
package on the CPU: ``runtime/pipeline.py::segment_once`` (the frames over
255 resized to the mask, the model's f32 alpha, no state),
``runtime/presets.py::describe`` (each preset's fields apart from the
defaults) and ``models/modnet.py::matting_alpha``.  Inputs are made from
seeds with numpy.

Tolerances: the seeded MatteNet's alpha within 2e-3 (bf16 layers rounded
apart by PyTorch and XLA, tests/test_torch_active.py); describe's fields
equal, over the fields the port's statics have (the reference's
TPU-lowering fields have no port field, ROADMAP.md).
"""

import ast

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu import models as jm
from video_stream_segmenetation_tpu.models import modnet as JMN
from video_stream_segmenetation_tpu.runtime import pipeline as JP
from video_stream_segmenetation_tpu.runtime import presets as JPR
from video_stream_segmenetation_tpu_torch.models.modnet import (
    MatteNet,
    init_mattenet_params,
    matting_alpha,
)
from video_stream_segmenetation_tpu_torch.runtime import presets as TPR
from video_stream_segmenetation_tpu_torch.runtime.config import PipelineStatics
from video_stream_segmenetation_tpu_torch.runtime.pipeline import segment_once


@pytest.fixture(scope="module")
def net():
    tree = init_mattenet_params(0)
    return tree, MatteNet(tree, device="cpu")


def test_segment_once_matches(net, rng):
    tree, model = net
    frames = rng.integers(0, 256, (2, 80, 160, 3), dtype=np.uint8)
    st = TPR.preset("active", frame_hw=(80, 160), mask_hw=(32, 64))
    bundle = JP.ModelBundle(jm.MatteNet(), jax.tree_util.tree_map(jnp.asarray, tree))
    want = np.asarray(JP.segment_once(bundle, JPR.preset("active", frame_hw=(80, 160),
                                                         mask_hw=(32, 64)))(
        {"matte": bundle.matte_params}, jnp.asarray(frames)))
    with torch.no_grad():
        got = segment_once(model, st)(torch.tensor(frames))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 32, 64) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)


def test_matting_alpha_matches(net, rng):
    tree, model = net
    x = rng.random((2, 32, 64, 3), dtype=np.float32)
    want = np.asarray(JMN.matting_alpha(jm.MatteNet(), jax.tree_util.tree_map(jnp.asarray, tree),
                                        jnp.asarray(x)))
    with torch.no_grad():
        got = matting_alpha(model, torch.tensor(x))
    assert tuple(got.shape) == want.shape == (2, 32, 64)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2e-3)


def _fields(line: str, name: str):
    head, _, body = line.partition(": ")
    assert head == name
    return body if body.startswith("defaults") else ast.literal_eval(body)


@pytest.mark.parametrize("name", JPR.list_presets())
def test_describe_matches(name):
    """The same preset name and the same fields apart from the defaults,
    with the same values, of those the port's statics have."""
    assert TPR.list_presets() == JPR.list_presets()
    got, want = _fields(TPR.describe(name), name), _fields(JPR.describe(name), name)
    if isinstance(want, str):
        assert got == want
        return
    ported = {f for f in PipelineStatics.__dataclass_fields__}
    assert got == {k: v for k, v in want.items() if k in ported}
