"""The port's micro plan (fast_int8_micro's trunk) against the JAX package:
the numpy quantizer's dict, the seeded float tree's layout, and the plain
micro trunk (models/quantized.py::xla_micro_trunk_alpha, the CUDA trunk's
plain version) against the reference's int8 graph with its decoder levels
in XLA (``decoder_impl='xla'``) and through the Pallas decoder kernel in
interpret mode (``'pallas'``), on the same s8 stem output."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stream_segmenetation_tpu import models
from video_stream_segmenetation_tpu.models import quantized as JQ
from video_stream_segmenetation_tpu.utils.checkpoint import restore_params
from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.kernels import trunk_int8 as TK
from video_stream_segmenetation_tpu_torch.models import quantized as TQ
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import init_params

SS = 10
MICRO_CKPT = "checkpoints/mattenet_hd10_micro"


def _model():
    return models.MatteNetHD(stem_stride=SS, head_upsample=4, decoder="micro")


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def trees():
    model = _model()
    return {"trained": jax.tree_util.tree_map(np.asarray, restore_params(MICRO_CKPT)),
            "seeded": jax.tree_util.tree_map(np.asarray, model.init(
                jax.random.PRNGKey(1), jnp.zeros((1, 80, 160, 3))))}


@pytest.mark.parametrize("which", ["trained", "seeded"])
def test_micro_quantizer_matches_reference(trees, which):
    """Bit-exact dict: the same float64 fold and rounding in numpy.  The
    port keeps ``stem_w`` in f32 and serves it as bf16 (the reference
    stores the bf16 values), so that entry is compared as served."""
    want = _leaves(bridge.load_quantized(jax.tree_util.tree_map(
        np.asarray, JQ.quantize_mattenet_hd(_model(), trees[which]))))
    got = _leaves(bridge.params_from_jax(trees[which], SS, decoder="micro"))
    got["stem_w"] = torch.tensor(got["stem_w"]).to(torch.bfloat16).float().numpy()
    assert got.keys() == want.keys()
    assert "d2b/ConvBN_1/wq" in got and "d3b/SEBlock_0/Dense_0/kernel" in got
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_seeded_micro_tree_has_flax_layout(trees):
    mine = {k: v.shape for k, v in _leaves(init_params("micro", 0, SS)).items()}
    flax = {k: v.shape for k, v in _leaves(trees["seeded"]).items()}
    assert mine == flax
    a, b = _leaves(init_params("micro", 3, SS)), _leaves(init_params("micro", 3, SS))
    assert all(np.array_equal(a[k], b[k]) for k in a)


def _stem_x0(q, xp):
    """The reference's bf16 stem on packed frames -> s8 x0."""
    y = jnp.asarray(xp).astype(jnp.bfloat16) @ q["stem_w"]
    return np.asarray(JQ._requant(y.astype(jnp.float32) + q["stem_b"]))


def _packed(rng, s, fh, fw):
    x = rng.integers(0, 256, (s, fh // SS, fw // SS, SS * SS * 3), dtype=np.uint8)
    return x


def _reference_logits(q, xp, impl):
    jm = JQ.QuantizedMatteNetHD(SS, 4, decoder="micro", decoder_impl=impl, head_impl="int8")
    return np.asarray(jm.apply(q, jnp.asarray(xp))["alpha_logit_lr"])


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("which", ["trained", "seeded"])
def test_plain_micro_trunk_matches_reference(trees, rng, impl, which):
    """Exact logits at the 8x16 stem grid: exact s32 sums and the same f32
    epilogues on both sides; the SE means and dense layers (f32 in the
    reference, float64 in the port) picked no other lattice step here."""
    q = JQ.quantize_mattenet_hd(_model(), trees[which])
    xp = _packed(rng, 2, 80, 160)
    want = _reference_logits(q, xp, impl)
    tp = TQ.trunk_params(bridge.load_quantized(jax.tree_util.tree_map(np.asarray, q)))
    got = TK.micro_trunk_alpha(torch.tensor(_stem_x0(q, xp)), tp).numpy()
    assert got.shape == want.shape == (2, 8, 16) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_micro_model_alpha_matches_reference(trees, rng):
    """QuantizedMatteNetHD (micro) forward vs the reference's int8 graph on
    packed frames.  The stem's bf16 product may round a knife-edge x0 value
    to the other lattice step, so alpha is held to 1e-5, not bit-exact."""
    q = JQ.quantize_mattenet_hd(_model(), trees["trained"])
    xp = _packed(rng, 2, 80, 160)
    jm = JQ.QuantizedMatteNetHD(SS, 4, decoder="micro", decoder_impl="xla", head_impl="int8")
    want = np.asarray(jm.apply(q, jnp.asarray(xp))["alpha"])
    tm = TQ.QuantizedMatteNetHD(bridge.load_quantized(jax.tree_util.tree_map(np.asarray, q)),
                                SS, 4)
    assert tm.decoder == "micro"
    got = tm(torch.tensor(xp))["alpha"].numpy()
    assert got.shape == want.shape == (2, 32, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def full_grid(trees):
    """The main path's 72x128 stem grid: the committed 720p frames, the
    trained micro weights, S=1 each."""
    q = JQ.quantize_mattenet_hd(_model(), trees["trained"])
    frames, _ = bridge.load_frames()
    from video_stream_segmenetation_tpu.ops.layout import space_to_depth

    xp = np.asarray(space_to_depth(jnp.asarray(frames), SS))
    tp = TQ.trunk_params(bridge.load_quantized(jax.tree_util.tree_map(np.asarray, q)))
    return q, xp, tp


@pytest.mark.parametrize("frame", [0, 1])
def test_plain_micro_trunk_full_stem_grid_trained(full_grid, frame):
    """At the 72x128 grid the SEs average 2304 (d2b), 576 (d3b, ctx) values
    a channel; float64 against the reference's f32 could pick another
    lattice step.  Measured: none does.

    * Against the reference's XLA path the logits are bit-exact.
    * Against its Pallas decoder levels (interpret mode) a few logits
      differ (9 and 15 of 9216 on these frames, at most 0.0031): exactly
      where the reference's Pallas path departs from its own XLA path, by
      the reach of one u1 lattice step through the alpha head."""
    q, xp, tp = full_grid
    xs = xp[frame:frame + 1]
    want = _reference_logits(q, xs, "xla")
    got = TK.micro_trunk_alpha(torch.tensor(_stem_x0(q, xs)), tp).numpy()
    assert got.shape == want.shape == (1, 72, 128)
    np.testing.assert_array_equal(got, want)

    pallas = _reference_logits(q, xs, "pallas")
    np.testing.assert_array_equal(got != pallas, want != pallas)
    reach = 127 * float(np.max(np.asarray(q["alpha_q"]["mult"])))
    assert (got != pallas).sum() < 32
    np.testing.assert_allclose(got, pallas, rtol=0, atol=reach)
