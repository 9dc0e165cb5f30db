"""Port's int8 pico and nano trunks and model vs the JAX package.

The port's plain trunk (video_stream_segmenetation_tpu_torch/models/
quantized.py::xla_trunk_alpha, the CUDA kernel's plain version) against
the JAX Pallas megakernel fused_nano_trunk_alpha_rowfold run in interpret
mode, on the same s8 stem output and the same quantized weights: the pico
widths with one class, and the pico and nano widths with the K=4 head of
the multi-class presets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stream_segmenetation_tpu import models
from video_stream_segmenetation_tpu.kernels.trunk_int8 import (
    fused_nano_trunk,
    fused_nano_trunk_alpha_rowfold,
)
from video_stream_segmenetation_tpu.models import quantized as JQ
from video_stream_segmenetation_tpu.ops.layout import space_to_depth
from video_stream_segmenetation_tpu.utils.checkpoint import restore_params
from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.kernels import trunk_int8 as TK
from video_stream_segmenetation_tpu_torch.models import quantized as TQ

SS = 10  # s2d block of fast_int8_pico
FH, FW = 80, 160  # stem grid 8x16, the JAX engine tests' geometry
PICO_CKPT = "checkpoints/mattenet_hd10_pico"


def _jax_pico(seed, decoder="pico", k=1, head_upsample=4):
    model = models.MatteNetHD(stem_stride=SS, head_upsample=head_upsample, num_classes=k,
                              decoder=decoder)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, FH, FW, 3)))
    return model, params


def _x0(rng, s, q):
    """Stem output of random packed frames (the reference's bf16 stem)."""
    x = jnp.asarray(rng.integers(0, 256, (s, FH // SS, FW // SS, SS * SS * 3), dtype=np.uint8))
    y = x.astype(jnp.bfloat16) @ q["stem_w"]
    return np.asarray(JQ._requant(y.astype(jnp.float32) + q["stem_b"])), np.asarray(x)


@pytest.mark.parametrize("seed,decoder,k", [
    (0, "pico", 1), (1, "pico", 1), (0, "pico", 4), (0, "nano", 4), (1, "nano", 1)],
    ids=["0", "1", "pico-k4-0", "nano-k4-0", "nano-1"])
def test_plain_trunk_matches_pallas_rowfold(rng, seed, decoder, k):
    """Exact logits: the s32 sums are exact on both sides and the f32
    epilogues are the same operations.  The only inexact step is the SE
    mean and dense layers (f32 in the reference, float64 in the port); at
    these shapes it flipped no lattice step of ctx (the full 72x128 grid
    is held below).  One class gives [S, H, W], K classes [S, H, W, K] in
    the reference's unfolded class order."""
    model, params = _jax_pico(seed, decoder, k)
    q = JQ.quantize_mattenet_hd(model, params)
    x0, _ = _x0(rng, 2, q)
    s, h, w, c0 = x0.shape
    want = np.asarray(fused_nano_trunk_alpha_rowfold(
        jnp.asarray(x0).reshape(s, h // 4, 4, w, c0), q, interpret=True))
    tp = TQ.trunk_params(bridge.load_quantized(jax.tree_util.tree_map(np.asarray, q)))
    got = TK.fused_nano_trunk_alpha(torch.tensor(x0), tp).numpy()
    assert got.shape == ((s, h, w) if k == 1 else (s, h, w, k)) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("decoder,k,uf", [("pico", 1, 4), ("pico", 4, 1), ("nano", 4, 4)])
def test_model_alpha_matches_jax_xla_path(rng, decoder, k, uf):
    """QuantizedMatteNetHD forward (bf16 stem, trunk, x``uf`` half-pixel
    upsample -- none at uf=1 --, sigmoid, or softmax over K classes) vs
    the JAX int8 graph on packed frames.  The stem's bf16 product may
    round a knife-edge x0 value to the other lattice step, so alpha is
    held to 1e-5 rather than bit-exact."""
    model, params = _jax_pico(0, decoder, k, uf)
    q = JQ.quantize_mattenet_hd(model, params)
    _, xp = _x0(rng, 2, q)
    jm = JQ.QuantizedMatteNetHD(SS, uf, num_classes=k, decoder=decoder, decoder_impl="xla",
                                head_impl="int8")
    want = np.asarray(jm.apply(q, jnp.asarray(xp))["alpha"])
    tm = TQ.QuantizedMatteNetHD(bridge.load_quantized(jax.tree_util.tree_map(np.asarray, q)),
                                SS, uf, device="cpu")
    got = tm(torch.tensor(xp))["alpha"].numpy()
    hw = (8 * uf, 16 * uf)
    assert got.shape == want.shape == ((2, *hw) if k == 1 else (2, *hw, k))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_same_pads_match_xla_same():
    """'SAME' low/high pads of the strided, dilated and 1x1 convs."""
    assert TQ.same_pads(72, 3, 2, 1) == (0, 1)
    assert TQ.same_pads(36, 3, 1, 1) == (1, 1)
    assert TQ.same_pads(18, 3, 1, 3) == (3, 3)
    assert TQ.same_pads(72, 1, 1, 1) == (0, 0)



@pytest.fixture(scope="module")
def trained_q():
    model = models.MatteNetHD(stem_stride=SS, head_upsample=4, decoder="pico")
    return JQ.quantize_mattenet_hd(model, restore_params(PICO_CKPT))


def _jax_split_conv_up(small, skip, layer):
    ca = small.shape[-1]
    la = {"wq": layer["wq"][:, :, :ca], "mult": layer["mult"], "bias": layer["bias"]}
    lb = {"wq": layer["wq"][:, :, ca:], "mult": layer["mult"],
          "bias": jnp.zeros_like(layer["bias"])}
    return JQ._requant(JQ._nearest_x2(JQ._conv_i8(small, la)) + JQ._conv_i8(skip, lb))


@pytest.mark.parametrize("k", [0, 1, 2])
def test_plain_trunk_full_stem_grid_trained(trained_q, k):
    """The main path's 72x128 stem grid (a 720p frame), S=1, trained
    weights, a bright ellipse over noise: the SE mean runs over all 18x32
    ctx pixels.

    * Against the reference's XLA path (``_conv_i8``, ``_se_f32``, split
      convs): ctx (the SE output on the 6/127 lattice), u1 and the logits
      are bit-exact -- the port's float64 SE picked the same lattice step
      as the reference's f32 SE everywhere.
    * Against the Pallas megakernel in interpret mode: u1 within one
      lattice step (frames 0 and 1 exact; frame 2 has one u1 value one
      step off, where the kernel also departs from its own XLA path), and
      the logits within that step's reach through the alpha head plus
      float32 rounding."""
    q = trained_q
    rng = np.random.default_rng(k)
    yy, xx = np.mgrid[0:720, 0:1280]
    f = rng.integers(0, 90, (720, 1280, 3)).astype(np.uint8)
    f[((yy - 360 - 40 * k) / 250.0) ** 2 + ((xx - 640 - 100 * k) / 160.0) ** 2 < 1] = 230
    y = space_to_depth(jnp.asarray(f)[None], SS).astype(jnp.bfloat16) @ q["stem_w"]
    x0j = JQ._requant(y.astype(jnp.float32) + q["stem_b"])
    s, h, w, c0 = x0j.shape
    assert (h, w) == (72, 128)

    d2 = JQ._requant(JQ._conv_i8(x0j, q["d2dn"], strides=(2, 2)))
    d2 = JQ._qconv(d2, q["d2b"], "xla")
    d3 = JQ._requant(JQ._conv_i8(d2, q["d3dn"], strides=(2, 2)))
    d3 = JQ._qconv(d3, q["d3b"], "xla")
    ctx_f = jax.nn.relu6(JQ._conv_i8(d3, q["ctx"], dilation=(3, 3))
                         + d3.astype(jnp.float32) * JQ.ACT_SCALE)
    ctx_f = JQ._se_f32(ctx_f, q["ctxse/Dense_0"], q["ctxse/Dense_1"])
    ctx = jnp.round(jnp.clip(ctx_f, 0.0, 6.0) * (127.0 / 6.0)).astype(jnp.int8)
    u1 = _jax_split_conv_up(_jax_split_conv_up(ctx, d2, q["u2red"]), x0j, q["u1red"])
    logits = JQ._conv_i8(u1, q["alpha_q"])[..., 0]

    tp = TQ.trunk_params(bridge.load_quantized(jax.tree_util.tree_map(np.asarray, q)))
    x = torch.tensor(np.asarray(x0j))
    pd2 = TQ._requant(TQ._conv_i8(TQ._requant(TQ._conv_i8(x, tp["d2dn"], stride=2)), tp["d2b"]))
    pd3 = TQ._requant(TQ._conv_i8(TQ._requant(TQ._conv_i8(pd2, tp["d3dn"], stride=2)), tp["d3b"]))
    pctx = TQ._requant(TQ._se(torch.clamp(
        TQ._conv_i8(pd3, tp["ctx"], dilation=3) + pd3.float() * TQ.ACT_SCALE, 0.0, 6.0), tp["se"]))
    pu1 = TQ.split_conv_up(TQ.split_conv_up(pctx, pd2, tp["u2red_up"], tp["u2red_skip"]),
                           x, tp["u1red_up"], tp["u1red_skip"])
    got = TK.fused_nano_trunk_alpha(x, tp).numpy()
    np.testing.assert_array_equal(pctx.numpy(), np.asarray(ctx))
    np.testing.assert_array_equal(pu1.numpy(), np.asarray(u1))
    np.testing.assert_array_equal(got, np.asarray(logits))

    ku1 = np.asarray(fused_nano_trunk(x0j, q, interpret=True)).astype(np.int32)
    steps = np.abs(ku1 - pu1.numpy().astype(np.int32))
    assert steps.max() <= 1
    want = np.asarray(fused_nano_trunk_alpha_rowfold(
        x0j.reshape(s, h // 4, 4, w, c0), q, interpret=True))
    reach = int(steps.sum()) * 127 * float(np.max(np.asarray(q["alpha_q"]["mult"])))
    np.testing.assert_allclose(got, want, rtol=0, atol=reach + 1e-5)
