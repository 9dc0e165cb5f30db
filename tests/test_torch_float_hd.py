"""The float MatteNetHD at every plan in the port against the JAX package on
the CPU: the packed stem (models/backbones.py::PatchifiedConv), then plans
A (stem stride 5), B ('full'), C ('light') and D ('micro', and 'pico' of
its branch) with one class and K = 4, over natural and packed frames, on
seeded trees at the reference tests' geometry (frames 80x160: plan A's
stem grid 16x32 upsampled x2, the others' 8x16 upsampled x4, a 32x64
mask).  Trained trees: tests/test_torch_float_hd_trained.py.  Inputs are
made from seeds with numpy.

Tolerances, with their reasons:
* the packed stem's product: equal to the reference's at all but a few
  values, none more than one bf16 step (both multiply bf16 operands and
  round one f32 sum to bf16; the sums may round apart);
* the forwards (bf16 layers; PyTorch and XLA round the convolutions' and
  the SE's partial sums at other places, tests/test_torch_fast.py's
  bars): alpha and semantic within 2e-3, the detail logits within 2e-2
  (unbounded logits, a few bf16 steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu import models
from video_stream_segmenetation_tpu.models.backbones import PatchifiedConv as JaxPatchifiedConv
from video_stream_segmenetation_tpu.ops.layout import space_to_depth
from video_stream_segmenetation_tpu_torch.models.backbones import (
    ConvBN,
    PatchifiedConv,
    freeze,
    patch_weights,
)
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import MatteNetHD, init_params

FH, FW = 80, 160
# (decoder, stem stride, head upsample): plan A, B, C and D
PLANS = {"A": ("full", 5, 2), "B": ("full", 10, 4), "C": ("light", 10, 4),
         "D": ("micro", 10, 4), "pico": ("pico", 10, 4)}
T = torch.tensor


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.shape(v)
    return out


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(7)
    return rng.integers(0, 256, (2, FH, FW, 3), dtype=np.uint8)


@pytest.mark.parametrize("ss", [5, 10])
@pytest.mark.parametrize("u8", [True, False], ids=["u8", "float"])
def test_patchified_conv_matches(frames, ss, u8):
    """The packed stem's product at both input kinds: u8 lanes times the
    weights over 255 (f32, then bf16), or float lanes in [0, 1] times the
    weights; and the quantizer's stem matrix is the same fold."""
    rng = np.random.default_rng(ss)
    kernel = (rng.standard_normal((ss, ss, 3, 32)) * 0.2).astype(np.float32)
    xp = np.asarray(space_to_depth(jnp.asarray(frames), ss))
    x = xp if u8 else (xp / 255.0).astype(np.float32)
    want = np.asarray(JaxPatchifiedConv(32, (ss, ss)).apply(
        {"params": {"kernel": jnp.asarray(kernel)}}, jnp.asarray(x)).astype(jnp.float32))
    bn = {"Conv_0": {"kernel": kernel},
          "BatchNorm_0": {"scale": np.ones(32, np.float32), "bias": np.zeros(32, np.float32)}}
    stats = {"BatchNorm_0": {"mean": np.zeros(32, np.float32), "var": np.ones(32, np.float32)}}
    layer = freeze(PatchifiedConv(freeze(ConvBN(bn, stats, stride=ss))))
    got = layer(T(x)).permute(0, 2, 3, 1).float().numpy()
    assert got.shape == want.shape == (2, FH // ss, FW // ss, 32)
    step = np.abs(want) * 2.0 ** -7 + 1e-30
    assert (np.abs(got - want) <= step).all() and (got != want).mean() <= 1e-3
    np.testing.assert_array_equal(patch_weights(kernel.astype(np.float64), True),
                                  kernel.astype(np.float64).reshape(-1, 32) / 255.0)


def test_packed_u8_stem_is_not_the_natural_conv(frames):
    """The reference's packed u8 stem divides the weights by 255 and the
    natural one the frames (in bf16): the two are not the same numbers, so
    the packed forward must be the packed product, not the natural conv of
    the unpacked frames."""
    tree = init_params("full", 0, 5)
    m = MatteNetHD(5, 2, "full", params=tree, device="cpu")
    xp = T(np.asarray(space_to_depth(jnp.asarray(frames), 5)))
    with torch.no_grad():
        packed, natural = m.stem(xp), m.stem(T(frames))
    assert packed.shape == natural.shape and (packed != natural).any()


@pytest.mark.parametrize("plan", ["B", "C"])
def test_k_class_tree_has_flax_layout(plan):
    """Plans B's and C's K = 4 trees: the flax init's names and shapes."""
    dec, ss, uf = PLANS[plan]
    flax_tree = jax.eval_shape(lambda: models.MatteNetHD(
        stem_stride=ss, head_upsample=uf, num_classes=4, decoder=dec).init(
            jax.random.PRNGKey(0), jnp.zeros((1, FH, FW, 3))))
    assert _leaves(dict(flax_tree)) == _leaves(init_params(dec, 0, ss, 4))


@pytest.mark.parametrize("packed", [False, True], ids=["natural", "packed"])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_seeded_forward_matches(frames, plan, k, packed):
    """u8 frames, natural or packed by the plan's stem stride: alpha
    ``[2, 32, 64]`` (K: ``[2, 32, 64, 4]``, softmax), semantic at the
    context's grid, detail at the head's, against the reference's jitted
    forward on the same tree; the tree round-trips through the module."""
    dec, ss, uf = PLANS[plan]
    tree = init_params(dec, 0, ss, k)
    x = np.asarray(space_to_depth(jnp.asarray(frames), ss)) if packed else frames
    jm = models.MatteNetHD(stem_stride=ss, head_upsample=uf, num_classes=k, decoder=dec)
    want = jax.jit(jm.apply)(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x))
    m = MatteNetHD(ss, uf, dec, params=tree, device="cpu")
    assert m.num_classes == k
    with torch.no_grad():
        got = m(T(x))
    for name, tol in (("alpha", 2e-3), ("semantic", 2e-3), ("detail", 2e-2)):
        w = np.asarray(want[name])
        assert got[name].dtype == torch.float32 and tuple(got[name].shape) == w.shape, name
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0, atol=tol, err_msg=name)
    assert got["alpha"].shape[1:3] == (32, 64)
    if k > 1:
        np.testing.assert_allclose(got["alpha"].sum(-1).numpy(), 1.0, rtol=0, atol=1e-5)
    back = m.tree()
    assert _leaves(back) == _leaves(tree)
    np.testing.assert_array_equal(back["params"]["Conv_2"]["kernel"],
                                  tree["params"]["Conv_2"]["kernel"])


def test_plan_a_ignores_the_decoder_and_loads_by_classes():
    """Below stem stride 8 the net is plan A whatever the decoder says (as
    the reference's ``__call__``), and a tree of another class count does
    not load."""
    m = MatteNetHD(5, 2, "pico", device="cpu")
    assert m.plan_a and set(m.layers) == set(MatteNetHD(5, 2, "full", device="cpu").layers)
    with pytest.raises(ValueError, match="classes"):
        m.load_tree(init_params("full", 1, 5, 4))
