"""int8 serving graph for MatteNetHD, the pico, nano, femto, micro, light
(plan C) and full (plan B) plans, one alpha class or K (port of
``models/quantized.py``).

* :func:`quantize_mattenet_hd`: numpy copy of the reference's quantizer --
  BatchNorm folded into the conv weights, symmetric per-output-channel
  int8 weights, static activations on the relu6 lattice (scale 6/127);
  the float heads kept for the bf16 head.
* :func:`trunk_params`: the quantized dict in the layout the trunk kernels
  take (weights OHWI; the 3x3 convs the reference routes through
  ``conv3x3_i8_fused`` also HWIO; the split decoder convs cut into their
  up-path and skip halves).
* The plain ("xla-style") trunks, :data:`PLAIN_TRUNKS` (stem output -> u1
  s8 for each plan) and :func:`xla_trunk_alpha` / :func:`xla_micro_trunk_alpha`
  (with the int8 alpha head), mirror the reference's XLA path
  (``_conv_i8``, ``_qconv``, ``_se_f32``, ``_block``, ``split_conv``,
  ``split_conv_up``) and are the plain versions of the CUDA trunks.
  Convolutions accumulate exactly, in float64 (a d3b/ctx sum can pass
  float32's exact 2**24; PyTorch has no int8 convolution on CUDA); the SE
  mean and dense layers run in float64 (the reference: f32).  At the main
  path's 72x128 stem grid with the trained pico weights this picks the
  reference's lattice step for every ctx value (tests/test_torch_trunk.py).
* :func:`bf16_head`: the reference's ``head_impl='bf16'`` alpha head on u1.
* :class:`QuantizedMatteNetHD`: bf16 stem patch product + requant, the
  plan's trunk (kernels/trunk_int8.py; the decoder levels of micro and
  plan C are kernels/decoder_int8.py, the routed 3x3 convs with
  ``conv_impl='pallas'`` kernels/conv_int8.py), the int8 or bf16 alpha
  head, half-pixel upsample (none at ``head_upsample=1``), sigmoid -- or,
  with K > 1 classes, softmax over the class axis.
  The ``det``/``sem`` heads are dead in serving and are not computed.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from video_stream_segmenetation_tpu_torch.models.backbones import conv2d_same, same_pads
from video_stream_segmenetation_tpu_torch.ops.resize import resize_bilinear_mxu

ACT_SCALE = 6.0 / 127.0  # relu6 output lattice
RELU6_SCALE = 127.0 / 6.0

# ---- quantizer (numpy) -------------------------------------------------


def _fold_bn(kernel, bn_scale, bn_bias, bn_mean, bn_var, eps=1e-5):
    inv = bn_scale / np.sqrt(bn_var + eps)
    w = np.asarray(kernel, np.float64) * inv[None, None, None, :]
    b = np.asarray(bn_bias, np.float64) - np.asarray(bn_mean, np.float64) * inv
    return w, b


def _quant_w(w):
    """Per-output-channel symmetric int8."""
    amax = np.maximum(np.abs(w).max(axis=(0, 1, 2)), 1e-12)
    sw = amax / 127.0
    q = np.clip(np.round(w / sw[None, None, None, :]), -127, 127).astype(np.int8)
    return q, sw


def _f64(x):
    return np.asarray(x, np.float64)


def _folded(p, st, name):
    bn, bst = p[name]["BatchNorm_0"], st[name]["BatchNorm_0"]
    return _fold_bn(
        _f64(p[name]["Conv_0"]["kernel"]), _f64(bn["scale"]), _f64(bn["bias"]),
        _f64(bst["mean"]), _f64(bst["var"]),
    )


def _qconvbn(p, st, name):
    w, b = _folded(p, st, name)
    wq, sw = _quant_w(w)
    return {"wq": wq, "mult": (ACT_SCALE * sw).astype(np.float32),
            "bias": b.astype(np.float32)}


def _dense(d):
    return {"kernel": np.asarray(d["kernel"], np.float32),
            "bias": np.asarray(d["bias"], np.float32)}


# serving key -> flax module, per plan (mattenet_hd.py module orders);
# nano and femto are pico's structure at other deep widths
_PLAN_EF = (("d2dn", "ConvBN_1"), ("d2b", "ConvBN_2"), ("d3dn", "ConvBN_3"),
            ("d3b", "ConvBN_4"), ("ctx", "ConvBN_5"), ("u2red", "ConvBN_6"),
            ("u1red", "ConvBN_7"))
PLAN_LAYERS = {
    "pico": _PLAN_EF,
    "nano": _PLAN_EF,
    "femto": _PLAN_EF,
    "micro": (("d2dn", "ConvBN_1"), ("d3dn", "ConvBN_2"), ("ctx", "ConvBN_3"),
              ("u2red", "ConvBN_4"), ("u1red", "ConvBN_5")),
    "light": (("b1c", "ConvBN_1"), ("d2dn", "ConvBN_2"), ("d3dn", "ConvBN_3"),
              ("ctx2", "ConvBN_4"), ("ctx4", "ConvBN_5"), ("u2red", "ConvBN_6"),
              ("u2", "ConvBN_7"), ("u1red", "ConvBN_8")),
    "full": (("d2dn", "ConvBN_1"), ("d3dn", "ConvBN_2"), ("ctx2", "ConvBN_3"),
             ("ctx4", "ConvBN_4"), ("u2", "ConvBN_5"), ("u1", "ConvBN_6")),
}
# residual blocks: serving prefix <- flax module (an SE where the module
# has one: plan B's b1 has none)
PLAN_BLOCKS = {
    "micro": (("d2b", "_Block_0"), ("d3b", "_Block_1")),
    "light": (("d2b", "_Block_0"), ("d3b", "_Block_1")),
    "full": (("b1", "_Block_0"), ("d2b", "_Block_1"), ("d3b", "_Block_2")),
}
# the decoder convs over concat(nearest_x2(small), skip), split into an
# up-path half and a skip half: the 1x1 reduce convs, plan B's 3x3 convs
SPLIT_LAYERS = {"full": ("u2", "u1")}
# (c2, c3) of the single-conv plans, as their d2dn and d3dn weights give
# them (the reference's NANO_WIDTHS)
_EF_WIDTHS = {(128, 192): "pico", (192, 256): "nano", (128, 128): "femto"}
# the single-conv plans: one trunk kernel serves them all, its widths
# read from the weights
NANO_PLANS = ("pico", "nano", "femto")
# the float heads (flax module), kept for head_impl='bf16'
FLOAT_HEADS = (("sem", "Conv_0"), ("det", "Conv_1"), ("alpha", "Conv_2"))


def quantize_mattenet_hd(float_tree: dict, stem_stride: int,
                         decoder: str = "pico") -> dict:
    """Float tree ``{"params", "batch_stats"}`` of the ``decoder`` plan
    (nested dicts of numpy arrays, flax module names) -> int8 serving dict
    with the reference's keys: ``stem_w`` (f32; served as bf16),
    ``stem_b``, the plan's convs (each ``wq`` s8 HWIO, ``mult``, ``bias``;
    :data:`PLAN_LAYERS`), its residual blocks (:data:`PLAN_BLOCKS`:
    ``<pfx>/ConvBN_0|1`` and, with an SE, ``<pfx>/SEBlock_0/Dense_0|1``),
    ``ctxse/Dense_0|1``, the float heads ``sem``, ``det`` and ``alpha``
    (``kernel``, ``bias`` f32) and ``alpha_q`` (K output channels, a
    ``mult`` and ``bias`` each).  The reference's int8-stem entries and
    ``det_q`` are not served and not made."""
    if stem_stride < 8:
        raise ValueError("int8 serving path targets plan B (stem_stride >= 8)")
    if decoder not in PLAN_LAYERS:
        raise ValueError(f"decoder {decoder!r}: the port has {sorted(PLAN_LAYERS)}")
    p, st = float_tree["params"], float_tree["batch_stats"]
    q = {}
    w, b = _folded(p, st, "ConvBN_0")
    wm = w.reshape(stem_stride * stem_stride * 3, -1) / 255.0
    q["stem_w"] = wm.astype(np.float32)
    q["stem_b"] = b.astype(np.float32)
    for name, mod in PLAN_LAYERS[decoder]:
        q[name] = _qconvbn(p, st, mod)
    for pfx, blk in PLAN_BLOCKS.get(decoder, ()):
        for conv in ("ConvBN_0", "ConvBN_1"):
            q[f"{pfx}/{conv}"] = _qconvbn(p[blk], st[blk], conv)
        if "SEBlock_0" in p[blk]:
            for d in ("Dense_0", "Dense_1"):
                q[f"{pfx}/SEBlock_0/{d}"] = _dense(p[blk]["SEBlock_0"][d])
    for d in ("Dense_0", "Dense_1"):
        q[f"ctxse/{d}"] = _dense(p["SEBlock_0"][d])
    for name, mod in FLOAT_HEADS:
        q[name] = _dense(p[mod])
    wq, sw = _quant_w(_f64(p["Conv_2"]["kernel"]))
    q["alpha_q"] = {"wq": wq, "mult": (ACT_SCALE * sw).astype(np.float32),
                    "bias": np.asarray(p["Conv_2"]["bias"], np.float32)}
    return q


# ---- kernel layout -----------------------------------------------------


def _layer(wq_hwio, mult, bias, device, hwio: bool = False):
    """One conv as {w: OHWI s8, mult: [Cout] f32, bias: [Cout] f32}, plus
    ``wq``, the HWIO s8 weights conv3x3_i8_fused takes, with ``hwio``."""
    wq = np.asarray(wq_hwio, np.int8)
    layer = {
        "w": torch.tensor(np.ascontiguousarray(np.transpose(wq, (3, 0, 1, 2))), device=device),
        "mult": torch.tensor(np.asarray(mult, np.float32).reshape(-1), device=device),
        "bias": torch.tensor(np.asarray(bias, np.float32).reshape(-1), device=device),
    }
    if hwio:
        layer["wq"] = torch.tensor(np.ascontiguousarray(wq), device=device)
    return layer


def _se_params(q: dict, pfx: str, device) -> dict:
    return {
        f"{short}{i}": torch.tensor(np.asarray(q[f"{pfx}/Dense_{i}"][field], np.float32),
                                    device=device)
        for i in (0, 1) for short, field in (("k", "kernel"), ("b", "bias"))
    }


def plan_of(q: dict) -> str:
    """The plan ('pico', 'nano', 'femto', 'micro', 'light' or 'full') of a
    serving dict or of its trunk layout.  By keys first, since plans B, C
    and micro all have residual blocks at d2b/d3b and share nano's deep
    widths: plan B's b1 is a block (``b1/ConvBN_0``), plan C's a single
    conv (``b1c``), micro has no b1; the single-conv plans pico, nano and
    femto by their widths."""
    if "b1/ConvBN_0" in q or "c0" in q.get("b1", {}):
        return "full"
    if "b1c" in q:
        return "light"
    if "d2b/ConvBN_0" in q or "c0" in q.get("d2b", {}):
        return "micro"
    if "wq" in q["d2dn"]:
        c2, c3 = q["d2dn"]["wq"].shape[-1], q["d3dn"]["wq"].shape[-1]
    else:
        c2, c3 = q["d2dn"]["w"].shape[0], q["d3dn"]["w"].shape[0]
    if (c2, c3) not in _EF_WIDTHS:
        raise ValueError(f"widths (c2, c3) = {(c2, c3)} are no plan of the port's: "
                         f"{_EF_WIDTHS}")
    return _EF_WIDTHS[(c2, c3)]


def num_classes_of(q: dict) -> int:
    """K, the alpha head's output channels, of a serving dict or its trunk
    layout."""
    return q["alpha_q"]["wq"].shape[-1] if "alpha_q" in q else q["alpha"]["w"].shape[0]


def trunk_params(q: dict, device="cpu") -> dict:
    """The quantized dict as the trunk takes it, on ``device``.  Residual
    blocks become ``{"c0", "c1"[, "se"]}`` under their prefix; the convs
    the reference routes through ``conv3x3_i8_fused`` with
    ``conv_impl='pallas'`` (every block's first conv, plan C's ``b1c`` and
    ``u2``, plans B's and C's ``ctx2``) also carry HWIO ``wq``; the split
    decoder convs become ``<name>_up`` and ``<name>_skip`` (the skip half
    with a zero bias).  The int8 alpha head's ``mult`` and ``bias`` are per
    class; a single value is broadcast to the K classes (the reference's
    _alpha_head_consts).  ``alpha_f``: the float alpha head as the bf16
    head takes it (OIHW ``w`` and ``b``, bf16), where the dict has it."""
    tp = {}
    plan = plan_of(q)
    blocks = PLAN_BLOCKS.get(plan, ())
    split = SPLIT_LAYERS.get(plan, ("u2red", "u1red"))
    routed = {"b1c", "ctx2", "u2"} if plan == "light" else {"ctx2"}
    for name, _ in PLAN_LAYERS[plan]:
        if name not in split:
            layer = q[name]
            tp[name] = _layer(layer["wq"], layer["mult"], layer["bias"], device,
                              hwio=name in routed)
    for pfx, _ in blocks:
        tp[pfx] = {f"c{i}": _layer(q[f"{pfx}/ConvBN_{i}"]["wq"],
                                   q[f"{pfx}/ConvBN_{i}"]["mult"],
                                   q[f"{pfx}/ConvBN_{i}"]["bias"], device, hwio=i == 0)
                   for i in (0, 1)}
        if f"{pfx}/SEBlock_0/Dense_0" in q:
            tp[pfx]["se"] = _se_params(q, f"{pfx}/SEBlock_0", device)
    # the up-path halves take the level below: c3 channels at u2, c2 at u1
    c2, c3 = q["d2dn"]["wq"].shape[-1], q["d3dn"]["wq"].shape[-1]
    for name, ca in zip(split, (c3, c2)):
        wq, mult, bias = q[name]["wq"], q[name]["mult"], q[name]["bias"]
        tp[name + "_up"] = _layer(wq[:, :, :ca], mult, bias, device)
        tp[name + "_skip"] = _layer(wq[:, :, ca:], mult, np.zeros_like(bias), device)
    tp["se"] = _se_params(q, "ctxse", device)
    k = num_classes_of(q)
    head = q["alpha_q"]
    tp["alpha"] = _layer(head["wq"], *(np.broadcast_to(np.asarray(head[f], np.float32)
                                                      .reshape(-1), (k,))
                                       for f in ("mult", "bias")), device)
    if "alpha" in q:
        kern = np.asarray(q["alpha"]["kernel"], np.float32)
        tp["alpha_f"] = {
            "w": torch.tensor(np.ascontiguousarray(np.transpose(kern, (3, 2, 0, 1))),
                              device=device).to(torch.bfloat16),
            "b": torch.tensor(np.asarray(q["alpha"]["bias"], np.float32),
                              device=device).to(torch.bfloat16)}
    return tp


# ---- plain (xla-style) trunk -------------------------------------------


def _requant(y: torch.Tensor) -> torch.Tensor:
    """relu6 + quantize onto the 6/127 lattice (round half to even)."""
    return torch.round(torch.clamp(y, 0.0, 6.0) * RELU6_SCALE).to(torch.int8)


def _conv_i8(x_i8: torch.Tensor, layer: dict, stride: int = 1, dilation: int = 1):
    """int8 'SAME' conv, exact (float64), then the f32 epilogue
    ``acc * mult + bias``.  x NHWC s8, layer["w"] OHWI s8 -> NHWC f32."""
    w = layer["w"]
    kh, kw = w.shape[1], w.shape[2]
    h, wd = x_i8.shape[1], x_i8.shape[2]
    pt, pb = same_pads(h, kh, stride, dilation)
    pl, pr = same_pads(wd, kw, stride, dilation)
    xd = F.pad(x_i8.permute(0, 3, 1, 2).to(torch.float64), (pl, pr, pt, pb))
    acc = F.conv2d(xd, w.permute(0, 3, 1, 2).to(torch.float64),
                   stride=stride, dilation=dilation)
    acc = torch.round(acc).to(torch.float32).permute(0, 2, 3, 1)
    return acc * layer["mult"] + layer["bias"]


def _se(x_f32: torch.Tensor, se: dict) -> torch.Tensor:
    """Squeeze-excitation gate over NHWC; mean and dense layers in float64."""
    s = x_f32.to(torch.float64).mean(dim=(1, 2))
    s = torch.relu(s @ se["k0"].to(torch.float64) + se["b0"].to(torch.float64))
    s = s @ se["k1"].to(torch.float64) + se["b1"].to(torch.float64)
    return x_f32 * torch.sigmoid(s).to(torch.float32)[:, None, None, :]


def _nearest_x2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def split_conv_up(small, skip, up_layer, skip_layer):
    """1x1 conv over concat(nearest_x2(small), skip), computed as the
    up-path conv at the low resolution, broadcast, plus the skip conv."""
    ya = _nearest_x2(_conv_i8(small, up_layer))
    return _requant(ya + _conv_i8(skip, skip_layer))


def split_conv(small, skip, up_layer, skip_layer):
    """Plan B's 3x3 conv over concat(nearest_x2(small), skip) as its two
    halves, in the reference's f32 order (quantized.py:388-394):
    ``(acc_a * mult + bias) + acc_b * mult``, then requant.  One conv over
    the channel concat would round differently."""
    return _requant(_conv_i8(_nearest_x2(small), up_layer) + _conv_i8(skip, skip_layer))


def _qconv(x_i8: torch.Tensor, layer: dict, dilation: int = 1) -> torch.Tensor:
    """int8 conv + relu6 requant (the reference's ``_qconv``; its Pallas
    route, kernels/conv_int8.py, computes the same)."""
    return _requant(_conv_i8(x_i8, layer, dilation=dilation))


def _block(x_i8: torch.Tensor, bp: dict) -> torch.Tensor:
    """The residual _Block: 3x3 requant conv, 3x3 f32 conv, SE on that f32
    output where the block has one, + residual, requant (the reference's
    ``_block``)."""
    y = _conv_i8(_qconv(x_i8, bp["c0"]), bp["c1"])
    if "se" in bp:
        y = _se(y, bp["se"])
    return _requant(y + x_i8.to(torch.float32) * ACT_SCALE)


def _context(d3: torch.Tensor, c3: torch.Tensor, se: dict) -> torch.Tensor:
    """relu6(c3 + d3), SE, requant: the context block's tail, ``c3`` its
    last conv's f32 output."""
    ctx_f = torch.clamp(c3 + d3.to(torch.float32) * ACT_SCALE, 0.0, 6.0)
    return _requant(_se(ctx_f, se))


def _down(x_i8: torch.Tensor, layer: dict) -> torch.Tensor:
    return _requant(_conv_i8(x_i8, layer, stride=2))


def xla_trunk(x0: torch.Tensor, tp: dict) -> torch.Tensor:
    """Pico, nano and femto (plans F, E, G): d2dn -> d2b -> d3dn -> d3b -> ctx (dil
    3) + residual -> SE -> u2red -> u1red.  x0 [S, H, W, C0] s8 -> u1
    [S, H, W, C0] s8 (the reference's ``fused_nano_trunk`` output)."""
    d2 = _qconv(_down(x0, tp["d2dn"]), tp["d2b"])
    d3 = _qconv(_down(d2, tp["d3dn"]), tp["d3b"])
    ctx = _context(d3, _conv_i8(d3, tp["ctx"], dilation=3), tp["se"])
    u2 = split_conv_up(ctx, d2, tp["u2red_up"], tp["u2red_skip"])
    return split_conv_up(u2, x0, tp["u1red_up"], tp["u1red_skip"])


def xla_micro_trunk(x0: torch.Tensor, tp: dict) -> torch.Tensor:
    """Micro (plan D): d2dn -> d2b block -> d3dn -> d3b block -> ctx (dil
    3) + residual -> SE -> u2red -> u1red.  x0 -> u1 s8."""
    d2 = _block(_down(x0, tp["d2dn"]), tp["d2b"])
    d3 = _block(_down(d2, tp["d3dn"]), tp["d3b"])
    ctx = _context(d3, _conv_i8(d3, tp["ctx"], dilation=3), tp["se"])
    u2 = split_conv_up(ctx, d2, tp["u2red_up"], tp["u2red_skip"])
    return split_conv_up(u2, x0, tp["u1red_up"], tp["u1red_skip"])


def _deep(b1: torch.Tensor, tp: dict):
    """Plans B and C below b1: d2dn -> d2b block -> d3dn -> d3b block ->
    ctx2 (dil 2, relu6 requant) -> ctx4 (dil 4, no act) + residual -> SE.
    Returns (d2, ctx) s8."""
    d2 = _block(_down(b1, tp["d2dn"]), tp["d2b"])
    d3 = _block(_down(d2, tp["d3dn"]), tp["d3b"])
    c4 = _conv_i8(_qconv(d3, tp["ctx2"], dilation=2), tp["ctx4"], dilation=4)
    return d2, _context(d3, c4, tp["se"])


def xla_light_trunk(x0: torch.Tensor, tp: dict) -> torch.Tensor:
    """Plan C: b1c (one 3x3) -> the deep stages -> u2red (split 1x1) ->
    u2 (3x3) -> u1red (split 1x1, over b1).  x0 -> u1 s8."""
    b1 = _qconv(x0, tp["b1c"])
    d2, ctx = _deep(b1, tp)
    u2 = _qconv(split_conv_up(ctx, d2, tp["u2red_up"], tp["u2red_skip"]), tp["u2"])
    return split_conv_up(u2, b1, tp["u1red_up"], tp["u1red_skip"])


def xla_full_trunk(x0: torch.Tensor, tp: dict) -> torch.Tensor:
    """Plan B: b1 block (no SE) -> the deep stages -> u2 and u1, each a
    split 3x3 conv over the nearest-x2 level below and the skip (d2, b1).
    x0 -> u1 s8."""
    b1 = _block(x0, tp["b1"])
    d2, ctx = _deep(b1, tp)
    u2 = split_conv(ctx, d2, tp["u2_up"], tp["u2_skip"])
    return split_conv(u2, b1, tp["u1_up"], tp["u1_skip"])


# the plain u1-out trunk of each plan
PLAIN_TRUNKS = {"pico": xla_trunk, "nano": xla_trunk, "femto": xla_trunk,
                "micro": xla_micro_trunk,
                "light": xla_light_trunk, "full": xla_full_trunk}


def alpha_head(u1: torch.Tensor, head: dict) -> torch.Tensor:
    """The int8 3x3 alpha head: logits ``[S, H, W]`` for one class,
    ``[S, H, W, K]`` for K."""
    logits = _conv_i8(u1, head)
    return logits[..., 0] if logits.shape[-1] == 1 else logits


def xla_trunk_alpha(x0: torch.Tensor, tp: dict) -> torch.Tensor:
    """The pico, nano or femto trunk and its int8 alpha head: x0 [S, H, W, C0] s8
    -> logits [S, H, W] f32 for one class, [S, H, W, K] for K."""
    return alpha_head(xla_trunk(x0, tp), tp["alpha"])


def xla_micro_trunk_alpha(x0: torch.Tensor, tp: dict) -> torch.Tensor:
    """The micro trunk and its int8 alpha head -> logits [S, H, W] f32."""
    return alpha_head(xla_micro_trunk(x0, tp), tp["alpha"])


# bf16(6/127) = 0.04736328125, the value jnp.bfloat16(ACT_SCALE) gives
_ACT_SCALE_BF16 = torch.tensor(ACT_SCALE, dtype=torch.bfloat16)


def bf16_head(u1: torch.Tensor, head: dict) -> torch.Tensor:
    """The reference's ``head_impl='bf16'`` alpha head (quantized.py:486-
    498): ``u1f = bf16(u1) * bf16(6/127)``, a bf16 3x3 'SAME' conv with
    the float head's kernel, plus its bias in bf16.  ``head``: trunk
    layout ``alpha_f``.  u1 [S, H, W, C] s8 -> bf16 logits ``[S, H, W]``
    for one class, ``[S, H, W, K]`` for K.  The reference runs this in XLA
    outside any kernel; here it is PyTorch's bf16 convolution (cuDNN on
    the card), under the step's pinned precision."""
    u1f = u1.to(torch.bfloat16) * _ACT_SCALE_BF16.to(u1.device)
    y = conv2d_same(u1f.permute(0, 3, 1, 2), head["w"])
    logits = (y + head["b"][None, :, None, None]).permute(0, 2, 3, 1)
    return logits[..., 0] if logits.shape[-1] == 1 else logits


# ---- serving module ----------------------------------------------------


class QuantizedMatteNetHD(torch.nn.Module):
    """Packed u8 frames ``[S, H/b, W/b, b*b*3]`` -> ``{"alpha": [S, mh, mw]
    f32}`` (sigmoid), or ``[S, mh, mw, K]`` class maps (softmax) with K > 1
    classes; the plan and K follow the serving dict's keys and widths.

    The reference's two int8 lowering switches (``PipelineStatics.
    int8_conv_impl`` and ``int8_head_impl``):
    * ``conv_impl`` 'xla' | 'pallas': with 'pallas' the 3x3 stride-1 convs
      the reference's ``_qconv`` routes (micro, light, full) run through
      kernels/conv_int8.py::conv3x3_i8_fused on the card.  The pico, nano
      and femto trunk is one kernel either way, as the reference's megakernel
      route is on the TPU.
    * ``head_impl`` 'int8' | 'bf16': the int8 alpha head on u1 (in the
      trunk kernel), or the trunk's u1 out and :func:`bf16_head`.
    """

    # forward(lowres=True) gives the head-grid logits (refine_alpha_src=
    # 'lowres': the refine kernel upsamples them itself)
    supports_lowres_alpha = True

    def __init__(self, q: dict, stem_stride: int, head_upsample: int, device="cpu",
                 conv_impl: str = "xla", head_impl: str = "int8"):
        super().__init__()
        if conv_impl not in ("xla", "pallas") or head_impl not in ("int8", "bf16"):
            raise ValueError(f"conv_impl {conv_impl!r} / head_impl {head_impl!r}: "
                             "'xla' or 'pallas' / 'int8' or 'bf16'")
        if head_impl == "bf16" and "alpha" not in q:
            raise ValueError("head_impl='bf16' needs the float alpha head ('alpha')")
        self.stem_stride = stem_stride
        self.head_upsample = head_upsample
        self.conv_impl = conv_impl
        self.head_impl = head_impl
        self.decoder = plan_of(q)
        self.num_classes = num_classes_of(q)
        if self.decoder not in ("pico", "nano") and self.num_classes > 1:
            raise NotImplementedError(f"the {self.decoder} plan serves one class only")
        self.register_buffer(
            "stem_w", torch.tensor(np.asarray(q["stem_w"], np.float32), device=device)
            .to(torch.bfloat16))
        self.register_buffer(
            "stem_b", torch.tensor(np.asarray(q["stem_b"], np.float32), device=device))
        self.trunk = trunk_params(q, device)

    def stem(self, frames_p: torch.Tensor) -> torch.Tensor:
        """bf16 patch product + folded BN -> x0 on the relu6 lattice, s8."""
        y = torch.matmul(frames_p.to(torch.bfloat16), self.stem_w)
        return _requant(y.to(torch.float32) + self.stem_b).contiguous()

    def trunk_logits(self, x0: torch.Tensor) -> torch.Tensor:
        """The plan's trunk and alpha head -> f32 logits (the bf16 head's
        logits widened)."""
        from video_stream_segmenetation_tpu_torch.kernels import trunk_int8 as TK

        int8_head = self.head_impl == "int8"
        if self.decoder in NANO_PLANS:
            fn = TK.fused_nano_trunk_alpha if int8_head else TK.fused_nano_trunk
            out = fn(x0, self.trunk)
        else:
            out = TK.PLAN_TRUNKS[self.decoder](x0, self.trunk, conv_impl=self.conv_impl,
                                               head=int8_head)
        return out if int8_head else bf16_head(out, self.trunk["alpha_f"]).float()

    def upsample(self, logits: torch.Tensor) -> torch.Tensor:
        """Half-pixel x``head_upsample`` bilinear upsample of each class
        plane (none at ``head_upsample=1``, as the reference), then
        sigmoid (one class, ``[S, H, W]``) or softmax over the class axis
        (``[S, H, W, K]``)."""
        uf = self.head_upsample
        if self.num_classes == 1:
            h0, w0 = logits.shape[-2:]
            if uf > 1:
                logits = resize_bilinear_mxu(logits, (uf * h0, uf * w0), "half_pixel",
                                             channel_last=False)
            return torch.sigmoid(logits)
        h0, w0 = logits.shape[-3:-1]
        if uf > 1:
            planes = resize_bilinear_mxu(logits.permute(0, 3, 1, 2), (uf * h0, uf * w0),
                                         "half_pixel", channel_last=False)
            logits = planes.permute(0, 2, 3, 1)
        return torch.softmax(logits, dim=-1).contiguous()

    def forward(self, frames_p: torch.Tensor, lowres: bool = False) -> dict:
        """``{"alpha": ...}``; with ``lowres`` (one class) instead
        ``{"alpha_logit_lr": [S, h0, w0] f32}``, the head-grid logits, and
        no upsample or sigmoid is computed (the reference's
        ``alpha_logit_lr``, there an output beside ``alpha`` that XLA drops
        when unread)."""
        logits = self.trunk_logits(self.stem(frames_p))
        if lowres:
            if self.num_classes != 1:
                raise ValueError("lowres: the head-grid logits are served with one class")
            return {"alpha_logit_lr": logits}
        return {"alpha": self.upsample(logits)}
