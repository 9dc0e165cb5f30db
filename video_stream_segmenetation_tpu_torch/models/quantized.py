"""int8 serving graph for MatteNetHD, the pico, nano and micro plans, one
alpha class or K (port of ``models/quantized.py``).

* :func:`quantize_mattenet_hd`: numpy copy of the reference's quantizer --
  BatchNorm folded into the conv weights, symmetric per-output-channel
  int8 weights, static activations on the relu6 lattice (scale 6/127).
* :func:`trunk_params`: the quantized dict in the layout the trunk kernel
  takes (weights OHWI, the split 1x1 decoder convs cut into their up-path
  and skip halves).
* The plain ("xla-style") trunks, :func:`xla_trunk_alpha` (pico, nano) and
  :func:`xla_micro_trunk_alpha` (micro: residual ``_block``s with SE),
  mirror the reference's XLA path (``_conv_i8``, ``_se_f32``, ``_block``,
  ``split_conv_up``) and are the plain versions of the CUDA trunks.  Convolutions accumulate exactly,
  in float64 (a d3b/ctx sum can pass float32's exact 2**24; PyTorch has
  no int8 convolution on CUDA); the SE mean and dense layers run in
  float64 (the reference: f32).  At the main path's 72x128 stem grid
  with the trained pico weights this picks the reference's lattice step
  for every ctx value (tests/test_torch_trunk.py).
* :class:`QuantizedMatteNetHD`: bf16 stem patch product + requant, the
  plan's trunk (kernels/trunk_int8.py; micro's decoder levels are
  kernels/decoder_int8.py), half-pixel upsample (none at
  ``head_upsample=1``), sigmoid -- or, with K > 1 classes, softmax over
  the class axis.
  The ``det``/``sem`` heads are dead in serving and are left out.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from video_stream_segmenetation_tpu_torch.models.backbones import same_pads
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
# nano is pico's structure at deeper widths
_PLAN_EF = (("d2dn", "ConvBN_1"), ("d2b", "ConvBN_2"), ("d3dn", "ConvBN_3"),
            ("d3b", "ConvBN_4"), ("ctx", "ConvBN_5"), ("u2red", "ConvBN_6"),
            ("u1red", "ConvBN_7"))
PLAN_LAYERS = {
    "pico": _PLAN_EF,
    "nano": _PLAN_EF,
    "micro": (("d2dn", "ConvBN_1"), ("d3dn", "ConvBN_2"), ("ctx", "ConvBN_3"),
              ("u2red", "ConvBN_4"), ("u1red", "ConvBN_5")),
}
# (c2, c3) of the single-conv plans, as their d2dn and d3dn weights give
# them (the reference's NANO_WIDTHS)
_EF_WIDTHS = {(128, 192): "pico", (192, 256): "nano"}
# micro's residual blocks: serving prefix <- flax module
MICRO_BLOCKS = (("d2b", "_Block_0"), ("d3b", "_Block_1"))


def quantize_mattenet_hd(float_tree: dict, stem_stride: int,
                         decoder: str = "pico") -> dict:
    """Float tree ``{"params", "batch_stats"}`` of the ``decoder`` plan
    (nested dicts of numpy arrays, flax module names) -> int8 serving dict
    with the reference's keys: ``stem_w`` (f32; served as bf16),
    ``stem_b``, the plan's convs (each ``wq`` s8 HWIO, ``mult``, ``bias``:
    pico and nano ``d2dn``, ``d2b``, ``d3dn``, ``d3b``, ``ctx``, ``u2red``,
    ``u1red``; micro the same with ``d2b``/``d3b`` as blocks
    ``d2b/ConvBN_0|1`` and ``d2b/SEBlock_0/Dense_0|1``), ``ctxse/Dense_0|1``
    and ``alpha_q`` (K output channels, a ``mult`` and ``bias`` each)."""
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
    if decoder == "micro":
        for pfx, blk in MICRO_BLOCKS:
            for conv in ("ConvBN_0", "ConvBN_1"):
                q[f"{pfx}/{conv}"] = _qconvbn(p[blk], st[blk], conv)
            for d in ("Dense_0", "Dense_1"):
                q[f"{pfx}/SEBlock_0/{d}"] = _dense(p[blk]["SEBlock_0"][d])
    for d in ("Dense_0", "Dense_1"):
        q[f"ctxse/{d}"] = _dense(p["SEBlock_0"][d])
    wq, sw = _quant_w(_f64(p["Conv_2"]["kernel"]))
    q["alpha_q"] = {"wq": wq, "mult": (ACT_SCALE * sw).astype(np.float32),
                    "bias": np.asarray(p["Conv_2"]["bias"], np.float32)}
    return q


# ---- kernel layout -----------------------------------------------------


def _layer(wq_hwio, mult, bias, device):
    """One conv as {w: OHWI s8, mult: [Cout] f32, bias: [Cout] f32}."""
    w = np.ascontiguousarray(np.transpose(np.asarray(wq_hwio, np.int8), (3, 0, 1, 2)))
    return {
        "w": torch.tensor(w, device=device),
        "mult": torch.tensor(np.asarray(mult, np.float32).reshape(-1), device=device),
        "bias": torch.tensor(np.asarray(bias, np.float32).reshape(-1), device=device),
    }


def _se_params(q: dict, pfx: str, device) -> dict:
    return {
        f"{short}{i}": torch.tensor(np.asarray(q[f"{pfx}/Dense_{i}"][field], np.float32),
                                    device=device)
        for i in (0, 1) for short, field in (("k", "kernel"), ("b", "bias"))
    }


def plan_of(q: dict) -> str:
    """The plan ('pico', 'nano' or 'micro') of a serving dict or of its
    trunk layout, by its keys (micro's residual blocks) and its widths."""
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
    """The quantized dict as the trunk takes it, on ``device``.  Micro's
    blocks become ``{"c0", "c1", "se"}`` under ``d2b``/``d3b``.  The alpha
    head's ``mult`` and ``bias`` are per class; a single value is
    broadcast to the K classes (the reference's _alpha_head_consts)."""
    tp = {}
    micro = plan_of(q) == "micro"
    for name in ("d2dn", "d3dn", "ctx") + (() if micro else ("d2b", "d3b")):
        tp[name] = _layer(q[name]["wq"], q[name]["mult"], q[name]["bias"], device)
    if micro:
        for pfx, _ in MICRO_BLOCKS:
            tp[pfx] = {f"c{i}": _layer(q[f"{pfx}/ConvBN_{i}"]["wq"],
                                       q[f"{pfx}/ConvBN_{i}"]["mult"],
                                       q[f"{pfx}/ConvBN_{i}"]["bias"], device)
                       for i in (0, 1)}
            tp[pfx]["se"] = _se_params(q, f"{pfx}/SEBlock_0", device)
    for name, ca in (("u2red", q["ctx"]["wq"].shape[-1]),
                     ("u1red", q["u2red"]["wq"].shape[-1])):
        wq, mult, bias = q[name]["wq"], q[name]["mult"], q[name]["bias"]
        tp[name + "_up"] = _layer(wq[:, :, :ca], mult, bias, device)
        tp[name + "_skip"] = _layer(wq[:, :, ca:], mult, np.zeros_like(bias), device)
    tp["se"] = _se_params(q, "ctxse", device)
    k = num_classes_of(q)
    head = q["alpha_q"]
    tp["alpha"] = _layer(head["wq"], *(np.broadcast_to(np.asarray(head[f], np.float32)
                                                      .reshape(-1), (k,))
                                       for f in ("mult", "bias")), device)
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


def _block(x_i8: torch.Tensor, bp: dict) -> torch.Tensor:
    """Micro's _Block: 3x3 requant conv, 3x3 f32 conv, SE on that f32
    output, + residual, requant (the reference's ``_block``)."""
    h = _requant(_conv_i8(x_i8, bp["c0"]))
    y = _se(_conv_i8(h, bp["c1"]), bp["se"])
    return _requant(y + x_i8.to(torch.float32) * ACT_SCALE)


def xla_micro_trunk_alpha(x0: torch.Tensor, tp: dict) -> torch.Tensor:
    """Micro (plan D): d2dn -> d2b block -> d3dn -> d3b block -> ctx
    (dil 3) + residual -> SE -> u2red -> u1red -> int8 alpha head.
    x0 [S, H, W, C0] s8 -> logits [S, H, W] f32."""
    d2 = _block(_requant(_conv_i8(x0, tp["d2dn"], stride=2)), tp["d2b"])
    d3 = _block(_requant(_conv_i8(d2, tp["d3dn"], stride=2)), tp["d3b"])
    c3 = _conv_i8(d3, tp["ctx"], dilation=3)
    ctx_f = torch.clamp(c3 + d3.to(torch.float32) * ACT_SCALE, 0.0, 6.0)
    ctx = _requant(_se(ctx_f, tp["se"]))
    u2 = split_conv_up(ctx, d2, tp["u2red_up"], tp["u2red_skip"])
    u1 = split_conv_up(u2, x0, tp["u1red_up"], tp["u1red_skip"])
    return alpha_head(u1, tp["alpha"])


def alpha_head(u1: torch.Tensor, head: dict) -> torch.Tensor:
    """The int8 3x3 alpha head: logits ``[S, H, W]`` for one class,
    ``[S, H, W, K]`` for K."""
    logits = _conv_i8(u1, head)
    return logits[..., 0] if logits.shape[-1] == 1 else logits


def xla_trunk_alpha(x0: torch.Tensor, tp: dict) -> torch.Tensor:
    """d2dn -> d2b -> d3dn -> d3b -> ctx(dil 3) + residual -> SE ->
    u2red -> u1red -> int8 alpha head, pico or nano widths.  x0 [S, H, W,
    C0] s8 -> logits [S, H, W] f32 for one class, [S, H, W, K] for K."""
    d2 = _requant(_conv_i8(x0, tp["d2dn"], stride=2))
    d2 = _requant(_conv_i8(d2, tp["d2b"]))
    d3 = _requant(_conv_i8(d2, tp["d3dn"], stride=2))
    d3 = _requant(_conv_i8(d3, tp["d3b"]))
    c3 = _conv_i8(d3, tp["ctx"], dilation=3)
    ctx_f = torch.clamp(c3 + d3.to(torch.float32) * ACT_SCALE, 0.0, 6.0)
    ctx = _requant(_se(ctx_f, tp["se"]))
    u2 = split_conv_up(ctx, d2, tp["u2red_up"], tp["u2red_skip"])
    u1 = split_conv_up(u2, x0, tp["u1red_up"], tp["u1red_skip"])
    return alpha_head(u1, tp["alpha"])


# ---- serving module ----------------------------------------------------


class QuantizedMatteNetHD(torch.nn.Module):
    """Packed u8 frames ``[S, H/b, W/b, b*b*3]`` -> ``{"alpha": [S, mh, mw]
    f32}`` (sigmoid), or ``[S, mh, mw, K]`` class maps (softmax) with K > 1
    classes; the plan (pico, nano or micro) and K follow the serving
    dict's keys and widths."""

    def __init__(self, q: dict, stem_stride: int, head_upsample: int, device="cpu"):
        super().__init__()
        self.stem_stride = stem_stride
        self.head_upsample = head_upsample
        self.decoder = plan_of(q)
        self.num_classes = num_classes_of(q)
        if self.decoder == "micro" and self.num_classes > 1:
            raise NotImplementedError("the micro plan serves one class only")
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
        from video_stream_segmenetation_tpu_torch.kernels import trunk_int8

        if self.decoder == "micro":
            return trunk_int8.micro_trunk_alpha(x0, self.trunk)
        return trunk_int8.fused_nano_trunk_alpha(x0, self.trunk)

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

    def forward(self, frames_p: torch.Tensor) -> dict:
        return {"alpha": self.upsample(self.trunk_logits(self.stem(frames_p)))}
