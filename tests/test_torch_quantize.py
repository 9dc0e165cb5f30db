"""Port's pico and nano parameter trees (one class, and K=4 heads),
quantizer and weight bridge vs the JAX package: the seeded tree has flax's
tree and shapes, the numpy quantizer is bit-exact for the s8 weights (and
equal for mult/bias), and the trained checkpoints cross the bridge
unchanged."""

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
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import init_params, init_pico_params

SS = 10
PICO_CKPT = "checkpoints/mattenet_hd10_pico"
# (checkpoint, plan, classes, (c2, c3))
TRAINED = {"pico": (PICO_CKPT, "pico", 1, (128, 192)),
           "mc_pico": ("checkpoints/mattenet_hd10_mc_pico", "pico", 4, (128, 192)),
           "mc": ("checkpoints/mattenet_hd10_mc", "nano", 4, (192, 256))}


def _shapes(tree):
    return jax.tree_util.tree_map(lambda x: tuple(np.shape(x)), tree)


def _flax_pico(seed=0, decoder="pico", k=1):
    model = models.MatteNetHD(stem_stride=SS, head_upsample=4, num_classes=k, decoder=decoder)
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


@pytest.mark.parametrize("decoder,k", [("pico", 1), ("pico", 4), ("nano", 4)])
def test_seeded_tree_has_flax_tree_and_shapes(decoder, k):
    _, flax_tree = _flax_pico(0, decoder, k)
    mine = init_pico_params(0, SS) if (decoder, k) == ("pico", 1) else \
        init_params(decoder, 0, SS, k)
    assert _shapes(mine) == _shapes(flax_tree)


def test_seeded_tree_is_reproducible():
    a, b = init_pico_params(3, SS), init_pico_params(3, SS)
    jax.tree_util.tree_map(np.testing.assert_array_equal, a, b)
    c = init_pico_params(4, SS)
    assert not np.array_equal(a["params"]["ConvBN_1"]["Conv_0"]["kernel"],
                              c["params"]["ConvBN_1"]["Conv_0"]["kernel"])


@pytest.mark.parametrize("seed,decoder,k", [
    (0, "pico", 1), (7, "pico", 1), (0, "pico", 4), (7, "nano", 4), (0, "nano", 1)],
    ids=["0", "7", "pico-k4-0", "nano-k4-7", "nano-0"])
def test_quantizer_bit_exact_on_flax_tree(seed, decoder, k):
    model, tree = _flax_pico(seed, decoder, k)
    # non-trivial BatchNorm statistics, so the fold is exercised
    rng = np.random.default_rng(seed)
    for name, st in tree["batch_stats"].items():
        c = st["BatchNorm_0"]["mean"].shape[0]
        st["BatchNorm_0"]["mean"] = rng.normal(0, 0.2, c).astype(np.float32)
        st["BatchNorm_0"]["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        tree["params"][name]["BatchNorm_0"]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    want = JQ.quantize_mattenet_hd(model, tree)
    got = TQ.quantize_mattenet_hd(tree, SS, decoder)
    _assert_same_qparams(got, want)
    assert got["alpha_q"]["wq"].shape[-1] == k == TQ.num_classes_of(got)
    assert TQ.plan_of(got) == decoder


@pytest.mark.parametrize("which", sorted(TRAINED))
def test_bridge_carries_trained_checkpoint(which):
    """The trained checkpoints (mattenet_hd10_pico, and the K=4
    mattenet_hd10_mc_pico and mattenet_hd10_mc), restored by the JAX
    package on the CPU: both bridge routes give the JAX quantizer's
    weights, in the trunk layout of the plan's widths."""
    ckpt, plan, k, (c2, c3) = TRAINED[which]
    tree = restore_params(ckpt)
    model = models.MatteNetHD(stem_stride=SS, head_upsample=4, num_classes=k, decoder=plan)
    want = JQ.quantize_mattenet_hd(model, tree)
    from_float = bridge.params_from_jax(tree, SS, plan)
    from_q = bridge.load_quantized(jax.tree_util.tree_map(np.asarray, want))
    _assert_same_qparams(from_float, want)
    _assert_same_qparams(from_q, want)
    tp = TQ.trunk_params(from_q)
    assert TQ.plan_of(tp) == plan and TQ.num_classes_of(tp) == k
    assert tuple(tp["d3b"]["w"].shape) == (c3, 3, 3, c3)
    assert tuple(tp["u2red_up"]["w"].shape) == (c2, 1, 1, c3)
    assert tuple(tp["u2red_skip"]["w"].shape) == (c2, 1, 1, c2)
    assert tuple(tp["alpha"]["w"].shape) == (k, 3, 3, 128)
    assert tuple(tp["alpha"]["mult"].shape) == tuple(tp["alpha"]["bias"].shape) == (k,)
    assert float(tp["u1red_skip"]["bias"].abs().sum()) == 0.0


def test_trunk_params_broadcast_single_head_scale():
    """A K-class head with a single ``mult`` or ``bias`` gets it for every
    class (the reference's _alpha_head_consts), in the trunk layout."""
    q = TQ.quantize_mattenet_hd(init_params("nano", 0, SS, 4), SS, "nano")
    q["alpha_q"] = dict(q["alpha_q"], mult=q["alpha_q"]["mult"][:1],
                        bias=np.asarray([0.25], np.float32))
    tp = TQ.trunk_params(q)
    np.testing.assert_array_equal(tp["alpha"]["mult"].numpy(),
                                  np.full(4, q["alpha_q"]["mult"][0], np.float32))
    np.testing.assert_array_equal(tp["alpha"]["bias"].numpy(), np.full(4, 0.25, np.float32))
