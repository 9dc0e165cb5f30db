"""The port's recurrent-net trainer (train/variants.py::train_rvm's loss)
against the reference's (tools/train_variants.py) at 48x80, batch 2,
unrolled over 2 rolled frames (tests/torch_variant_jobs.py): one step's
loss and gradient, BatchNorm statistics included, at the bars of
tests/torch_train_helpers.py; the roll, and the class simplex of the
multi-class trainers within 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_variant_jobs as VJ
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu.train.face import synthetic_face_batch as j_face_batch
from video_stream_segmenetation_tpu_torch.train import variants as PV

T = torch.as_tensor


@pytest.fixture(scope="module")
def grads():
    return VJ.grads_of(["rvm"])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rvm_gradients_match_reference(grads, dtype):
    VJ.check_grads(grads, "rvm", dtype)


def test_class_simplex_matches_reference():
    _, _, _, parts = j_face_batch(jax.random.PRNGKey(2), VJ.B, (96, 160), return_parts=True)
    want = np.asarray(VJ.TV._class_simplex(parts))
    got = PV._class_simplex({k: T(np.array(v)) for k, v in parts.items()}).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_roll_matches_jnp_roll():
    x = np.arange(2 * 3 * 7 * 2, dtype=np.float32).reshape(2, 3, 7, 2)
    for k in (-12, -3, 0, 5, 13):
        np.testing.assert_array_equal(PV._roll_w(T(x), torch.tensor(k)).numpy(),
                                      np.asarray(jnp.roll(x, k, axis=2)))
