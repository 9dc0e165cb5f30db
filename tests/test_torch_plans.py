"""Plans B and C (fast_int8 and fast_int8_lite's trunks) and the int8
lowering switches of the port against the JAX package: the seeded float
trees' layout, the numpy quantizer's dict, ``plan_of`` on every plan, the
plain trunks against the reference's ``QuantizedMatteNetHD.apply`` with
``conv_impl`` 'xla' and 'pallas' and ``head_impl`` 'int8' and 'bf16', the
plain ``conv3x3_i8_fused`` against the Pallas kernel (interpret mode) in
all its forms, and the u1-out trunk against ``fused_nano_trunk``
(interpret mode).  Both engines' IoU at 720p with the trained weights:
tests/test_torch_plans_720p.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stream_segmenetation_tpu import models
from video_stream_segmenetation_tpu.kernels.conv_int8 import conv3x3_i8_fused as jax_conv3x3
from video_stream_segmenetation_tpu.kernels.trunk_int8 import fused_nano_trunk as jax_nano_trunk
from video_stream_segmenetation_tpu.models import quantized as JQ
from video_stream_segmenetation_tpu.utils.checkpoint import restore_params
from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.kernels import conv_int8 as TC
from video_stream_segmenetation_tpu_torch.kernels import trunk_int8 as TK
from video_stream_segmenetation_tpu_torch.models import quantized as TQ
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import init_params

SS = 10
FH, FW = 80, 160  # the reference's serving tests' geometry: stem grid 8x16
CKPT = {"full": "checkpoints/mattenet_hd10", "light": "checkpoints/mattenet_hd10_lite",
        "micro": "checkpoints/mattenet_hd10_micro", "pico": "checkpoints/mattenet_hd10_pico"}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _flax(decoder, width=1.0, seed=0, k=1):
    model = models.MatteNetHD(width=width, stem_stride=SS, head_upsample=4, num_classes=k,
                              decoder=decoder)
    return model, _np(model.init(jax.random.PRNGKey(seed), jnp.zeros((1, FH, FW, 3))))


@pytest.mark.parametrize("decoder", ["full", "light"])
def test_seeded_tree_has_flax_layout(decoder):
    """Module names and shapes of plan B's and C's flax trees at width 1,
    and a seed that reproduces."""
    _, tree = _flax(decoder)
    mine = {k: v.shape for k, v in _leaves(init_params(decoder, 0, SS)).items()}
    assert mine == {k: v.shape for k, v in _leaves(tree).items()}
    a, b = _leaves(init_params(decoder, 3, SS)), _leaves(init_params(decoder, 3, SS))
    assert all(np.array_equal(a[k], b[k]) for k in a)


def _with_bn_stats(tree, seed):
    """Non-trivial BatchNorm statistics and scales everywhere (the blocks'
    too), so that the fold is exercised."""
    rng = np.random.default_rng(seed)

    def walk(p, st):
        for name, sub in st.items():
            if "BatchNorm_0" in sub:
                c = sub["BatchNorm_0"]["mean"].shape[0]
                sub["BatchNorm_0"]["mean"] = rng.normal(0, 0.2, c).astype(np.float32)
                sub["BatchNorm_0"]["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
                p[name]["BatchNorm_0"]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            else:
                walk(p[name], sub)

    walk(tree["params"], tree["batch_stats"])
    return tree


def _trees(decoder, which, k=1):
    """The trained checkpoint, or a seeded flax tree with BatchNorm
    statistics: at width 0.5 where the plan is told by its keys, at width
    1 for pico and nano, which are told by their widths."""
    if which == "trained":
        return models.MatteNetHD(stem_stride=SS, head_upsample=4, decoder=decoder), \
            _np(restore_params(CKPT[decoder]))
    model, tree = _flax(decoder, width=1.0 if decoder in ("pico", "nano") else 0.5, k=k)
    return model, _with_bn_stats(tree, 1)


@pytest.mark.parametrize("which", ["seeded", "trained"])
@pytest.mark.parametrize("decoder", ["full", "light"])
def test_quantizer_matches_reference(decoder, which):
    """Bit for bit, over every key of the reference's dict the port keeps
    (all but the int8-stem variant and ``det_q``): seeded at width 0.5 with
    BatchNorm statistics, and the trained mattenet_hd10 (plan B) and
    mattenet_hd10_lite (plan C).  ``stem_w`` is compared as served
    (bf16); the reference stores the bf16 values."""
    model, tree = _trees(decoder, which)
    want = _leaves(bridge.load_quantized(_np(JQ.quantize_mattenet_hd(model, tree))))
    got_q = bridge.params_from_jax(tree, SS, decoder)
    got = _leaves(got_q)
    got["stem_w"] = torch.tensor(got["stem_w"]).to(torch.bfloat16).float().numpy()
    assert got.keys() == want.keys()
    blocks = ("b1", "d2b", "d3b") if decoder == "full" else ("d2b", "d3b")
    for pfx in blocks:
        assert f"{pfx}/ConvBN_1/wq" in got
    assert ("b1/SEBlock_0/Dense_0/kernel" in got) is False
    assert "alpha/kernel" in got and "sem/kernel" in got and "det/kernel" in got
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert TQ.plan_of(got_q) == decoder == TQ.plan_of(TQ.trunk_params(got_q))


@pytest.mark.parametrize("decoder,k", [("pico", 1), ("nano", 4), ("micro", 1), ("full", 1),
                                       ("light", 1)])
def test_plan_of_tells_all_five_plans_apart(decoder, k):
    """By keys first (B's ``b1`` block, C's ``b1c``, micro's ``d2b``
    block), then by widths (pico, nano): micro, B and C share nano's deep
    widths (192, 256).  The serving dict and its trunk layout both."""
    q = TQ.quantize_mattenet_hd(init_params(decoder, 0, SS, k), SS, decoder)
    assert TQ.plan_of(q) == decoder
    assert TQ.plan_of(TQ.trunk_params(q)) == decoder
    if decoder in ("micro", "full", "light"):
        assert (q["d2dn"]["wq"].shape[-1], q["d3dn"]["wq"].shape[-1]) == (192, 256)


def _x0(q, xp):
    """The reference's bf16 stem on packed frames -> s8 x0."""
    y = jnp.asarray(xp).astype(jnp.bfloat16) @ q["stem_w"]
    return np.asarray(JQ._requant(y.astype(jnp.float32) + q["stem_b"]))


def _bf16_steps(got, want):
    """|got - want| in bf16 steps (the spacing of bf16 at |want|)."""
    spacing = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    return np.abs(got.astype(np.float64) - want) / spacing


@pytest.mark.parametrize("head_impl", ["int8", "bf16"])
@pytest.mark.parametrize("conv_impl", ["xla", "pallas"])
@pytest.mark.parametrize("decoder,which,k", [
    ("full", "seeded", 1), ("full", "trained", 1), ("light", "seeded", 1),
    ("light", "trained", 1), ("micro", "trained", 1), ("pico", "trained", 1),
    ("nano", "seeded", 4)])
def test_plain_trunk_matches_reference(rng, decoder, which, k, conv_impl, head_impl):
    """The port's trunk and head (the plain versions on the CPU) against
    the reference's int8 graph at the 8x16 stem grid, on the same s8 stem
    output (the reference's): plans B and C, and the two switches on the
    plans that had them fixed before (micro, pico, nano with K=4 classes).
    With ``conv_impl='pallas'`` the reference runs its fused conv kernel
    in interpret mode; the port's CPU route is the same plain conv either
    way (its pico and nano trunk is one kernel either way, as the
    reference's megakernel route is on the TPU).  The int8 head's logits
    are exact (exact s32 sums, the same f32 epilogues; the SE in float64
    against the reference's f32 picked no other lattice step here).  The
    bf16 head is held to one bf16 step of each logit: XLA and PyTorch each
    sum the bf16 convolution in f32 and round once, but are free to round
    partial sums at other points (measured: exact).  With K classes the
    class maps at the head grid are held to 1e-6 (the softmax's float32
    rounding on the same logits)."""
    model, tree = _trees(decoder, which, k)
    q = JQ.quantize_mattenet_hd(model, tree)
    xp = rng.integers(0, 256, (2, FH // SS, FW // SS, SS * SS * 3), dtype=np.uint8)
    # K > 1: the reference returns no pre-upsample logits, so both sides
    # serve at the head grid (head_upsample=1) and their class maps (the
    # softmax of the f32 logits) are compared
    uf = 4 if k == 1 else 1
    jm = JQ.QuantizedMatteNetHD(SS, uf, num_classes=k, decoder=decoder, conv_impl=conv_impl,
                                head_impl=head_impl, decoder_impl="xla")
    out = jm.apply(q, jnp.asarray(xp))
    want = np.asarray(out["alpha_logit_lr"] if k == 1 else out["alpha"], np.float32)
    tm = TQ.QuantizedMatteNetHD(bridge.load_quantized(_np(q)), SS, uf, conv_impl=conv_impl,
                                head_impl=head_impl)
    logits = tm.trunk_logits(torch.tensor(_x0(q, xp)))
    got = (logits if k == 1 else tm.upsample(logits)).numpy()
    assert got.shape == want.shape == ((2, 8, 16) if k == 1 else (2, 8, 16, k))
    assert got.dtype == np.float32
    if head_impl == "int8" or k > 1:
        np.testing.assert_allclose(got, want, rtol=0, atol=0 if k == 1 else 1e-6)
    else:
        assert _bf16_steps(got, want).max() <= 1.0


def _conv_inputs(rng, cin=128, cout=128, h=16, w=32):
    """The reference's kernel test shapes (tests/test_kernels.py:95)."""
    x = rng.integers(0, 127, (2, h, w, cin)).astype(np.int8)
    wq = rng.integers(-127, 127, (3, 3, cin, cout)).astype(np.int8)
    mult = rng.random(cout).astype(np.float32) * 1e-3
    bias = rng.random(cout).astype(np.float32) - 0.5
    res = rng.integers(0, 127, (2, h, w, cout)).astype(np.int8)
    return x, wq, mult, bias, res


@pytest.mark.parametrize("dilation", [1, 2, 4])
@pytest.mark.parametrize("act", [True, False], ids=["act", "noact"])
@pytest.mark.parametrize("residual", [False, True], ids=["nores", "res"])
def test_conv3x3_plain_matches_pallas(rng, residual, act, dilation):
    """The port's plain conv3x3_i8_fused (its CPU route) against the
    Pallas kernel in interpret mode, exactly, in all four forms at
    dilations 1, 2 and 4: exact s32 sums, the same f32 epilogue, the same
    rounding.  ``mult`` is large enough that the no-act form's symmetric
    clip and the act form's relu6 both bind."""
    x, wq, mult, bias, res = _conv_inputs(rng)
    mult = mult * 20.0
    want = np.asarray(jax_conv3x3(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(mult),
                                  jnp.asarray(bias), residual=jnp.asarray(res) if residual
                                  else None, with_residual=residual, act=act,
                                  dilation=dilation, interpret=True))
    n = TC.conv3x3_i8_fused.launches
    got = TC.conv3x3_i8_fused(torch.tensor(x), torch.tensor(wq), torch.tensor(mult),
                              torch.tensor(bias), torch.tensor(res) if residual else None,
                              act=act, dilation=dilation).numpy()
    assert TC.conv3x3_i8_fused.launches == n  # a CPU tensor launches nothing
    assert got.dtype == np.int8 and got.shape == want.shape == (2, 16, 32, 128)
    np.testing.assert_array_equal(got, want)
    if act:
        assert got.min() == 0 and got.max() == 127
    else:
        assert got.min() == -127 and got.max() == 127


@pytest.mark.parametrize("decoder", ["nano", "pico"])
def test_u1_trunk_matches_reference(rng, decoder):
    """The u1-out trunk (the port's fused_nano_trunk; on the CPU its plain
    version models/quantized.py::xla_trunk) at the reference's kernel test
    geometry (tests/test_kernels.py:153: 240x320 frames, a 24x32 stem
    grid), seeded weights.  Against the XLA mirror (the reference's
    ``_conv_i8``/``_qconv``/``_se_f32``/split convs) u1 is exact.  Against
    the Pallas megakernel in interpret mode u1 is within one lattice step,
    at most 1 % of the values: the kernel takes the SE's f32 mean in
    another order (kernels/trunk_int8.py:34-37), which can flip a ctx value
    at a rounding knife edge (measured: exact here)."""
    fh, fw = 240, 320
    model = models.MatteNetHD(stem_stride=SS, head_upsample=4, decoder=decoder)
    q = JQ.quantize_mattenet_hd(model, model.init(jax.random.PRNGKey(0),
                                                  jnp.zeros((1, fh, fw, 3))))
    xp = rng.integers(0, 255, (2, fh // SS, fw // SS, SS * SS * 3)).astype(np.uint8)
    x0 = _x0(q, xp)
    d2 = JQ._requant(JQ._conv_i8(jnp.asarray(x0), q["d2dn"], strides=(2, 2)))
    d2 = JQ._qconv(d2, q["d2b"])
    d3 = JQ._requant(JQ._conv_i8(d2, q["d3dn"], strides=(2, 2)))
    d3 = JQ._qconv(d3, q["d3b"])
    ctx_f = jax.nn.relu6(JQ._conv_i8(d3, q["ctx"], dilation=(3, 3))
                         + d3.astype(jnp.float32) * JQ.ACT_SCALE)
    ctx_f = JQ._se_f32(ctx_f, q["ctxse/Dense_0"], q["ctxse/Dense_1"])
    ctx = jnp.round(jnp.clip(ctx_f, 0.0, 6.0) * (127.0 / 6.0)).astype(jnp.int8)

    def scu(small, skip, layer):
        ca = small.shape[-1]
        la = {"wq": layer["wq"][:, :, :ca], "mult": layer["mult"], "bias": layer["bias"]}
        lb = {"wq": layer["wq"][:, :, ca:], "mult": layer["mult"],
              "bias": jnp.zeros_like(layer["bias"])}
        return JQ._requant(JQ._nearest_x2(JQ._conv_i8(small, la)) + JQ._conv_i8(skip, lb))

    mirror = np.asarray(scu(scu(ctx, d2, q["u2red"]), jnp.asarray(x0), q["u1red"]))
    kernel = np.asarray(jax_nano_trunk(jnp.asarray(x0), q, interpret=True))
    tp = TQ.trunk_params(bridge.load_quantized(_np(q)))
    n = TK.fused_nano_trunk.launches
    got = TK.fused_nano_trunk(torch.tensor(x0), tp).numpy()
    assert TK.fused_nano_trunk.launches == n
    assert got.shape == (2, 24, 32, 128) and got.dtype == np.int8
    np.testing.assert_array_equal(got, mirror)
    steps = np.abs(got.astype(np.int32) - kernel.astype(np.int32))
    assert steps.max() <= 1 and (steps > 0).mean() <= 0.01
