"""The two model families of the rvm and u2 presets, and the four new
exports, against the JAX package on the CPU: the seeded trees of
models/rvm.py::RecurrentMatteNet and models/u2net.py::SaliencyNet have the
flax modules' names and shapes; their forwards equal the flax forwards on
the same tree; the committed exports (``rvm``, ``u2net``,
``mattenet_hd10_nano``, ``mattenet_hd10_femto``) load into the port's
models and give the reference model's output on one input; the registry
builds both.

Tolerances, with their reasons: the models compute in bf16 and PyTorch and
XLA round their convolutions' partial sums at other places, so an output
is held within 4 bf16 steps (2**-8 relative) of the tensor's largest
magnitude plus one step at 1 (the alpha, RVM's state; :func:`_bf16_close`)
-- the RVM's full-resolution alpha within 1e-2 (its 3x3 refinement convs
on the upsampled alpha add their own bf16 rounding), the SaliencyNet's
within 4e-3 (the sigmoid of an f32 1x1 over bf16 side logits), all with
seeded weights.  The trained RVM and U2Net sit on bf16 knife edges (the
reference's own jitted and op-by-op forwards differ by up to 0.072 in
RVM's state and 0.018 in U2Net's alpha on these frames), so the exports'
outputs are held to the reference's jitted forward within twice that
spread (a weight loaded into the wrong place moves them by O(1)).  The
int8 MatteNetHD exports within 1e-5 (exact s32 sums, the bf16 stem on the
same lattice; the head-grid logits through the same f32 upsample).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu import models as jm
from video_stream_segmenetation_tpu import ops as jops
from video_stream_segmenetation_tpu.models.rvm import RecurrentState
from video_stream_segmenetation_tpu.models.rvm import init_state as jax_rvm_state
from video_stream_segmenetation_tpu.utils.checkpoint import restore_params
from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.models import rvm as TR
from video_stream_segmenetation_tpu_torch.models import u2net as TU
from video_stream_segmenetation_tpu_torch.models.quantized import QuantizedMatteNetHD
from video_stream_segmenetation_tpu_torch.models.registry import get_spec
from video_stream_segmenetation_tpu_torch.ops.layout import space_to_depth

ROOT = Path(__file__).resolve().parents[1]
T = torch.tensor
RVM_ALPHA_TOL = 1e-2
U2_ALPHA_TOL = 4e-3
INT8_TOL = 1e-5
# the trained nets on the committed frames: twice the distance between the
# reference's own jitted and op-by-op forwards there (RVM's alpha 0.053,
# its state 0.072; U2Net's alpha 0.018)
TRAINED_RVM_TOL = 0.15
TRAINED_U2_TOL = 0.04


def _shapes(t):
    return jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), t)


def _bf16_close(got, want, steps=4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    tol = steps * 2.0 ** -8 * np.abs(want).max() + 2.0 ** -8
    err = np.abs(got - want).max()
    assert err <= tol, f"max {err} > {tol}"


def test_rvm_tree_has_the_flax_names_and_shapes():
    flax_tree = jax.eval_shape(jm.RecurrentMatteNet().init, jax.random.PRNGKey(0),
                               jnp.zeros((1, 32, 64, 3)), jax_rvm_state(1, (32, 64)))
    assert _shapes(flax_tree) == _shapes(TR.init_rvm_params(0))
    want = [tuple(a.shape) for a in jax_rvm_state(3, (36, 60))]
    assert [tuple(t.shape) for t in TR.init_state(3, (36, 60))] == want


def test_u2net_tree_has_the_flax_names_and_shapes():
    flax_tree = jax.eval_shape(jm.SaliencyNet().init, jax.random.PRNGKey(0),
                               jnp.zeros((1, 40, 40, 3)))
    assert _shapes(flax_tree) == _shapes(TU.init_u2net_params(0))


def _rvm_case(rng, hw=(32, 64)):
    x = rng.random((2, *hw, 3), dtype=np.float32)
    state = [rng.standard_normal(tuple(a.shape)).astype(np.float32) * 0.5
             for a in jax_rvm_state(2, hw)]
    return x, state


def _rvm_both(tree, x, state):
    want = jax.jit(jm.RecurrentMatteNet().apply)(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x),
        RecurrentState(*[jnp.asarray(a) for a in state]))
    got = TR.RecurrentMatteNet(tree)(T(x), tuple(T(a) for a in state))
    return got, want


def test_rvm_forward_matches_flax(rng):
    """The alpha, alpha_small and the new state r1..r4 (f32 out) on a
    non-zero state; a size that is no multiple of 16 (odd stages)."""
    tree = TR.init_rvm_params(1)
    for hw in ((32, 64), (44, 52)):
        x, state = _rvm_case(rng, hw)
        got, want = _rvm_both(tree, x, state)
        np.testing.assert_allclose(got["alpha"].numpy(), np.asarray(want["alpha"]), rtol=0,
                                   atol=RVM_ALPHA_TOL)
        _bf16_close(got["alpha_small"], want["alpha_small"])
        for g, w in zip(got["state"], want["state"]):
            assert g.dtype == torch.float32
            _bf16_close(g, w)
        a = got["alpha"].numpy()
        assert a.min() >= 0 and a.max() <= 1 and a.std() > 1e-3


def test_saliencynet_forward_matches_flax(rng):
    """The alpha and the four side outputs, at an even size and at one
    whose pools pad (SAME) at every level."""
    tree = TU.init_u2net_params(2)
    apply = jax.jit(jm.SaliencyNet().apply)
    for hw in ((32, 64), (36, 44)):
        x = rng.random((2, *hw, 3), dtype=np.float32)
        want = apply(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x))
        got = TU.SaliencyNet(tree)(T(x))
        np.testing.assert_allclose(got["alpha"].numpy(), np.asarray(want["alpha"]), rtol=0,
                                   atol=U2_ALPHA_TOL)
        for g, w in zip(got["side"], want["side"]):
            _bf16_close(g, w)


def test_max_pool_same_pads_the_high_edge():
    x = torch.arange(2 * 3 * 5 * 7, dtype=torch.float32).reshape(2, 3, 5, 7) * -1.0
    want = np.asarray(jax.lax.reduce_window(jnp.asarray(x.numpy()), -jnp.inf, jax.lax.max,
                                            (1, 1, 2, 2), (1, 1, 2, 2), "SAME"))
    np.testing.assert_array_equal(TU.max_pool_same(x).numpy(), want)


# ---- the committed exports ----------------------------------------------------


def _restored(name):
    return jax.tree_util.tree_map(np.asarray, restore_params(str(ROOT / "checkpoints" / name)))


def _frames(hw):
    """The committed 720p frames resized to ``hw`` (f32 0..1): people, where
    the trained nets have something to find."""
    from video_stream_segmenetation_tpu_torch.ops.resize import resize_frames_u8

    frames, _ = bridge.load_frames()
    return resize_frames_u8(T(frames), hw).numpy()


def test_rvm_export_round_trips_and_matches_the_reference():
    """Two steps from the cold state on the committed frames, the second
    from the reference's state: the alpha and r1..r4."""
    tree = bridge.load_export(bridge.WEIGHTS_DIR / "rvm.npz")
    ref = _restored("rvm")
    assert _shapes(tree) == _shapes(bridge.float_tree(ref))
    x = _frames((72, 128))
    model = TR.RecurrentMatteNet(tree)
    apply = jax.jit(jm.RecurrentMatteNet().apply)
    state = jax_rvm_state(2, (72, 128))
    for t in range(2):
        xt = np.ascontiguousarray(x[::-1]) if t else x
        want = apply(ref, jnp.asarray(xt), state)
        got = model(T(xt), tuple(T(np.asarray(a)) for a in state))
        err = np.abs(got["alpha"].numpy() - np.asarray(want["alpha"])).max()
        assert err <= TRAINED_RVM_TOL, err
        for g, w in zip(got["state"], want["state"]):
            assert np.abs(g.numpy() - np.asarray(w)).max() <= TRAINED_RVM_TOL
        state = want["state"]


def test_u2net_export_round_trips_and_matches_the_reference():
    tree = bridge.load_export(bridge.WEIGHTS_DIR / "u2net.npz")
    ref = _restored("u2net")
    assert _shapes(tree) == _shapes(bridge.float_tree(ref))
    x = _frames((160, 160))
    want = jax.jit(jm.SaliencyNet().apply)(ref, jnp.asarray(x))
    got = TU.SaliencyNet(tree)(T(x))
    err = np.abs(got["alpha"].numpy() - np.asarray(want["alpha"])).max()
    assert err <= TRAINED_U2_TOL, err
    assert got["alpha"].numpy().std() > 0.1  # the person is found


@pytest.mark.parametrize("plan", ["nano", "femto"])
def test_trunk_export_round_trips_and_matches_the_reference(rng, plan):
    """The committed nano and femto exports serve the reference's int8
    model's alpha on one packed frame (the reference's XLA route)."""
    from video_stream_segmenetation_tpu.models.quantized import (
        QuantizedMatteNetHD as JQ,
        quantize_mattenet_hd,
    )

    name = bridge.EXPORTS[plan]
    q = bridge.load_export(bridge.WEIGHTS_DIR / f"{name}.npz")
    model = QuantizedMatteNetHD(q, 10, 4)
    assert model.decoder == plan and model.num_classes == 1
    hd = jm.MatteNetHD(stem_stride=10, head_upsample=4, decoder=plan)
    jq = quantize_mattenet_hd(hd, restore_params(str(ROOT / "checkpoints" / name)))
    frames = rng.integers(0, 256, (1, 80, 160, 3), dtype=np.uint8)
    xp = jops.space_to_depth(jnp.asarray(frames), 10)
    want = jax.jit(lambda p, f: JQ(10, 4, decoder=plan, decoder_impl="xla").apply(p, f))(jq, xp)
    got = model(space_to_depth(T(frames), 10))
    np.testing.assert_allclose(got["alpha"].numpy(), np.asarray(want["alpha"])[..., 0]
                               if np.asarray(want["alpha"]).ndim == 4
                               else np.asarray(want["alpha"]), rtol=0, atol=INT8_TOL)


def test_registry_builds_both_models():
    """recurrent_mattenet (stateful) and saliencynet are real entries at the
    reference's geometries; so are mattenet_hd (plan A: u8 frames, alpha at
    2x the stride-5 stem grid) and mattenet_multiclass (K=4 maps)."""
    rvm = get_spec("recurrent_mattenet")
    assert rvm.stateful and rvm.input_hw == (288, 512)
    model, tree = rvm.init_params(0, device="cpu")
    out = model(torch.zeros((1, 32, 64, 3)), TR.init_state(1, (32, 64)))
    assert out["alpha"].shape == (1, 32, 64) and len(out["state"]) == 4
    u2 = get_spec("saliencynet")
    assert not u2.stateful and u2.input_hw == (320, 320)
    model, _ = u2.init_params(0, device="cpu")
    assert model(torch.zeros((1, 40, 40, 3)))["alpha"].shape == (1, 40, 40)
    hd = get_spec("mattenet_hd")
    assert not hd.stateful and hd.input_hw == (720, 1280)
    model, _ = hd.init_params(0, device="cpu")
    assert model(torch.zeros((1, 40, 80, 3), dtype=torch.uint8))["alpha"].shape == (1, 16, 32)
    mc = get_spec("mattenet_multiclass")
    assert not mc.stateful and mc.input_hw == (288, 512)
    model, _ = mc.init_params(0, device="cpu")
    alpha = model(torch.zeros((1, 32, 64, 3)))["alpha"]
    assert alpha.shape == (1, 32, 64, 4)
    torch.testing.assert_close(alpha.sum(-1), torch.ones((1, 32, 64)))
