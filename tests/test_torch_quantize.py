"""Port's pico parameter tree, quantizer and weight bridge vs the JAX
package: the seeded tree has flax's tree and shapes, the numpy quantizer
is bit-exact for the s8 weights (and equal for mult/bias), and the
trained checkpoint crosses the bridge unchanged."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stream_segmenetation_tpu import models
from video_stream_segmenetation_tpu.models import quantized as JQ
from video_stream_segmenetation_tpu.utils.checkpoint import restore_params
from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.models import quantized as TQ
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import init_pico_params

SS = 10
PICO_CKPT = "checkpoints/mattenet_hd10_pico"


def _shapes(tree):
    return jax.tree_util.tree_map(lambda x: tuple(np.shape(x)), tree)


def _flax_pico(seed=0):
    model = models.MatteNetHD(stem_stride=SS, head_upsample=4, decoder="pico")
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 80, 160, 3)))
    return model, jax.tree_util.tree_map(np.asarray, params)


def _assert_same_qparams(got, want):
    """Port serving dict vs the JAX quantizer's dict, over the port's keys."""
    # the port serves stem_w as torch bf16: same rounding as the reference's
    np.testing.assert_array_equal(
        torch.tensor(got["stem_w"]).to(torch.bfloat16).float().numpy(),
        np.asarray(want["stem_w"], np.float32))
    np.testing.assert_array_equal(got["stem_b"], np.asarray(want["stem_b"]))
    for name in ("d2dn", "d2b", "d3dn", "d3b", "ctx", "u2red", "u1red", "alpha_q"):
        assert got[name]["wq"].dtype == np.int8
        np.testing.assert_array_equal(got[name]["wq"], np.asarray(want[name]["wq"]))
        np.testing.assert_array_equal(got[name]["mult"], np.asarray(want[name]["mult"]))
        np.testing.assert_array_equal(got[name]["bias"], np.asarray(want[name]["bias"]))
    for name in ("ctxse/Dense_0", "ctxse/Dense_1"):
        for f in ("kernel", "bias"):
            np.testing.assert_array_equal(got[name][f], np.asarray(want[name][f]))


def test_seeded_tree_has_flax_tree_and_shapes():
    _, flax_tree = _flax_pico()
    assert _shapes(init_pico_params(0, SS)) == _shapes(flax_tree)


def test_seeded_tree_is_reproducible():
    a, b = init_pico_params(3, SS), init_pico_params(3, SS)
    jax.tree_util.tree_map(np.testing.assert_array_equal, a, b)
    c = init_pico_params(4, SS)
    assert not np.array_equal(a["params"]["ConvBN_1"]["Conv_0"]["kernel"],
                              c["params"]["ConvBN_1"]["Conv_0"]["kernel"])


@pytest.mark.parametrize("seed", [0, 7])
def test_quantizer_bit_exact_on_flax_tree(seed):
    model, tree = _flax_pico(seed)
    # non-trivial BatchNorm statistics, so the fold is exercised
    rng = np.random.default_rng(seed)
    for name, st in tree["batch_stats"].items():
        c = st["BatchNorm_0"]["mean"].shape[0]
        st["BatchNorm_0"]["mean"] = rng.normal(0, 0.2, c).astype(np.float32)
        st["BatchNorm_0"]["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        tree["params"][name]["BatchNorm_0"]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    want = JQ.quantize_mattenet_hd(model, tree)
    _assert_same_qparams(TQ.quantize_mattenet_hd(tree, SS), want)


def test_bridge_carries_trained_checkpoint():
    """checkpoints/mattenet_hd10_pico, restored by the JAX package on the
    CPU: both bridge routes give the JAX quantizer's weights."""
    tree = restore_params(PICO_CKPT)
    model = models.MatteNetHD(stem_stride=SS, head_upsample=4, decoder="pico")
    want = JQ.quantize_mattenet_hd(model, tree)
    from_float = bridge.params_from_jax(tree, SS)
    from_q = bridge.load_quantized(jax.tree_util.tree_map(np.asarray, want))
    _assert_same_qparams(from_float, want)
    _assert_same_qparams(from_q, want)
    tp = TQ.trunk_params(from_q)
    assert tuple(tp["d3b"]["w"].shape) == (192, 3, 3, 192)
    assert tuple(tp["u2red_up"]["w"].shape) == (128, 1, 1, 192)
    assert tuple(tp["u2red_skip"]["w"].shape) == (128, 1, 1, 128)
    assert tuple(tp["alpha"]["w"].shape) == (1, 3, 3, 128)
    assert float(tp["u1red_skip"]["bias"].abs().sum()) == 0.0
