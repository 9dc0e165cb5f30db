"""The port's int8 decoder level (video_stream_segmenetation_tpu_torch/
kernels/decoder_int8.py, the CUDA kernel's plain version on the CPU)
against the JAX Pallas kernel fused_decoder_level run in interpret mode,
at both micro decoder levels' channel widths.  Bit-exact s8: the sums are
exact on both sides and the f32 epilogue runs the same operations in the
same order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stream_segmenetation_tpu import models
from video_stream_segmenetation_tpu.kernels.decoder_int8 import (
    fused_decoder_level as jax_decoder_level,
)
from video_stream_segmenetation_tpu.models import quantized as JQ
from video_stream_segmenetation_tpu.utils.checkpoint import restore_params
from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.kernels import decoder_int8 as DK
from video_stream_segmenetation_tpu_torch.models import quantized as TQ

MICRO_CKPT = "checkpoints/mattenet_hd10_micro"
# (level, small grid, Ca, Cb): micro's u2 (ctx 256 + d2 192 -> 192) and u1
# (u2 192 + stem 128 -> 128) levels, at a small grid
LEVELS = (("u2", (4, 8), 256, 192), ("u1", (8, 16), 192, 128))


@pytest.fixture(scope="module")
def micro_q():
    """Quantized micro dicts: the trained checkpoint and a flax init."""
    model = models.MatteNetHD(stem_stride=10, head_upsample=4, decoder="micro")
    trained = JQ.quantize_mattenet_hd(model, restore_params(MICRO_CKPT))
    seeded = JQ.quantize_mattenet_hd(
        model, model.init(jax.random.PRNGKey(0), jnp.zeros((1, 80, 160, 3))))
    return {"trained": trained, "seeded": seeded}


def _inputs(rng, s, grid, ca, cb):
    sh, sw = grid
    small = rng.integers(0, 128, (s, sh, sw, ca), dtype=np.int8)
    skip = rng.integers(0, 128, (s, 2 * sh, 2 * sw, cb), dtype=np.int8)
    return small, skip


@pytest.mark.parametrize("weights", ["trained", "seeded"])
@pytest.mark.parametrize("level,grid,ca,cb", LEVELS)
def test_plain_decoder_level_matches_pallas(micro_q, rng, weights, level, grid, ca, cb):
    q = micro_q[weights]
    small, skip = _inputs(rng, 2, grid, ca, cb)
    want = np.asarray(jax_decoder_level(jnp.asarray(small), jnp.asarray(skip),
                                        q[f"{level}red"], interpret=True))
    tp = TQ.trunk_params(bridge.load_quantized(jax.tree_util.tree_map(np.asarray, q)))
    assert tp[f"{level}red_up"]["w"].shape[-1] == ca
    got = DK.fused_decoder_level(torch.tensor(small), torch.tensor(skip),
                                 tp[f"{level}red_up"], tp[f"{level}red_skip"]).numpy()
    assert got.dtype == np.int8 and got.shape == want.shape
    assert 0 < (got == 0).mean() < 1 and got.max() > 0  # not a saturated plane
    np.testing.assert_array_equal(got, want)


def test_cpu_decoder_level_counts_no_launch(micro_q, rng):
    tp = TQ.trunk_params(bridge.load_quantized(
        jax.tree_util.tree_map(np.asarray, micro_q["seeded"])))
    small, skip = _inputs(rng, 1, (2, 4), 192, 128)
    n = DK.fused_decoder_level.launches
    a = DK.fused_decoder_level(torch.tensor(small), torch.tensor(skip),
                               tp["u1red_up"], tp["u1red_skip"])
    b = TQ.split_conv_up(torch.tensor(small), torch.tensor(skip),
                         tp["u1red_up"], tp["u1red_skip"])
    assert torch.equal(a, b)
    assert DK.fused_decoder_level.launches == n
