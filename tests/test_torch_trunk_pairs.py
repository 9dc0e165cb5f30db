"""The pico, nano and femto trunks' u2red and u1red levels, which the
trunk runs through the decoder kernel (video_stream_segmenetation_tpu_torch/
kernels/trunk_int8.py::_nano_u1 -> kernels/decoder_int8.py::launch_level):
the port's fused_decoder_level (its plain version on the CPU) against the
JAX Pallas kernel fused_decoder_level run in interpret mode, at each level's
widths, with each plan's trained checkpoint and a flax init.  Bit-exact s8:
the sums are exact on both sides and the f32 epilogue runs the same
operations in the same order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu import models
from video_stream_segmenetation_tpu.kernels.decoder_int8 import (
    fused_decoder_level as jax_decoder_level,
)
from video_stream_segmenetation_tpu.models import quantized as JQ
from video_stream_segmenetation_tpu.utils.checkpoint import restore_params
from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.kernels import decoder_int8 as DK
from video_stream_segmenetation_tpu_torch.models import quantized as TQ

CHECKPOINTS = {"pico": "checkpoints/mattenet_hd10_pico",
               "nano": "checkpoints/mattenet_hd10_nano",
               "femto": "checkpoints/mattenet_hd10_femto"}
# (level, small's grid, small's and skip's widths): u2red over ctx (c3) and
# d2 (c2) -> c2, u1red over u2 (c2) and the stem output (128) -> 128
WIDTHS = {"pico": (128, 192), "nano": (192, 256), "femto": (128, 128)}
GRIDS = {"u2": (4, 8), "u1": (8, 16)}


@pytest.fixture(scope="module")
def trunks():
    """Each plan's trunk layout: the trained checkpoint's and a flax init's,
    quantized by the reference and moved to the port."""
    out = {}
    for plan, ckpt in CHECKPOINTS.items():
        model = models.MatteNetHD(stem_stride=10, head_upsample=4, decoder=plan)
        init = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 40, 80, 3)))
        for weights, params in (("trained", restore_params(ckpt)), ("seeded", init)):
            q = jax.tree_util.tree_map(np.asarray, JQ.quantize_mattenet_hd(model, params))
            out[(plan, weights)] = (q, TQ.trunk_params(bridge.load_quantized(q)))
    return out


@pytest.mark.parametrize("weights", ["trained", "seeded"])
@pytest.mark.parametrize("level", ["u2", "u1"])
@pytest.mark.parametrize("plan", list(CHECKPOINTS))
def test_trunk_pair_matches_pallas(trunks, rng, plan, level, weights):
    q, tp = trunks[(plan, weights)]
    c2, c3 = WIDTHS[plan]
    ca, cb = (c3, c2) if level == "u2" else (c2, 128)
    up, skip_l = tp[f"{level}red_up"], tp[f"{level}red_skip"]
    assert up["w"].shape[-1] == ca and skip_l["w"].shape[-1] == cb
    sh, sw = GRIDS[level]
    small = rng.integers(0, 128, (2, sh, sw, ca), dtype=np.int8)
    skip = rng.integers(0, 128, (2, 2 * sh, 2 * sw, cb), dtype=np.int8)
    want = np.asarray(jax_decoder_level(jnp.asarray(small), jnp.asarray(skip),
                                        q[f"{level}red"], interpret=True))
    n = DK.fused_decoder_level.launches
    got = DK.fused_decoder_level(torch.tensor(small), torch.tensor(skip), up, skip_l).numpy()
    assert DK.fused_decoder_level.launches == n  # a CPU tensor launches nothing
    assert got.dtype == np.int8
    assert got.shape == want.shape == (2, 2 * sh, 2 * sw, up["w"].shape[0])
    assert 0 < (got == 0).mean() < 1 and got.max() > 0  # not a saturated plane
    np.testing.assert_array_equal(got, want)
