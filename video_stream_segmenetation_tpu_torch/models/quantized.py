"""int8 serving graph for MatteNetHD, pico plan (port of
``models/quantized.py``).

* :func:`quantize_mattenet_hd`: numpy copy of the reference's quantizer --
  BatchNorm folded into the conv weights, symmetric per-output-channel
  int8 weights, static activations on the relu6 lattice (scale 6/127).
* :func:`trunk_params`: the quantized dict in the layout the trunk kernel
  takes (weights OHWI, the split 1x1 decoder convs cut into their up-path
  and skip halves).
* The plain ("xla-style") trunk, :func:`xla_trunk_alpha`, mirrors the
  reference's XLA path (``_conv_i8``, ``_se_f32``, ``split_conv_up``) and
  is the trunk kernel's plain version.  Convolutions accumulate exactly,
  in float64 (a d3b/ctx sum can pass float32's exact 2**24; PyTorch has
  no int8 convolution on CUDA); the SE mean and dense layers run in
  float64 (the reference: f32).  At the main path's 72x128 stem grid
  with the trained pico weights this picks the reference's lattice step
  for every ctx value (tests/test_torch_trunk.py).
* :class:`QuantizedMatteNetHD`: bf16 stem patch product + requant, the
  trunk kernel (kernels/trunk_int8.py), half-pixel upsample, sigmoid.
  The ``det``/``sem`` heads are dead in serving and are left out.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from video_stream_segmenetation_tpu_torch.ops.resize import interp_matrix

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


def quantize_mattenet_hd(float_tree: dict, stem_stride: int) -> dict:
    """Float pico tree ``{"params", "batch_stats"}`` (nested dicts of numpy
    arrays, flax module names) -> int8 serving dict with the reference's
    keys: ``stem_w`` (f32; served as bf16), ``stem_b``, ``d2dn``, ``d2b``,
    ``d3dn``, ``d3b``, ``ctx``, ``u2red``, ``u1red`` (each ``wq`` s8 HWIO,
    ``mult``, ``bias``), ``ctxse/Dense_0|1`` and ``alpha_q``."""
    if stem_stride < 8:
        raise ValueError("int8 serving path targets plan B (stem_stride >= 8)")
    p, st = float_tree["params"], float_tree["batch_stats"]
    q = {}
    w, b = _folded(p, st, "ConvBN_0")
    wm = w.reshape(stem_stride * stem_stride * 3, -1) / 255.0
    q["stem_w"] = wm.astype(np.float32)
    q["stem_b"] = b.astype(np.float32)
    for name, mod in (("d2dn", "ConvBN_1"), ("d2b", "ConvBN_2"),
                      ("d3dn", "ConvBN_3"), ("d3b", "ConvBN_4"),
                      ("ctx", "ConvBN_5"), ("u2red", "ConvBN_6"),
                      ("u1red", "ConvBN_7")):
        w, b = _folded(p, st, mod)
        wq, sw = _quant_w(w)
        q[name] = {"wq": wq, "mult": (ACT_SCALE * sw).astype(np.float32),
                   "bias": b.astype(np.float32)}
    for d in ("Dense_0", "Dense_1"):
        dd = p["SEBlock_0"][d]
        q[f"ctxse/{d}"] = {"kernel": np.asarray(dd["kernel"], np.float32),
                           "bias": np.asarray(dd["bias"], np.float32)}
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


def trunk_params(q: dict, device="cpu") -> dict:
    """The quantized dict as the trunk takes it, on ``device``."""
    tp = {}
    for name in ("d2dn", "d2b", "d3dn", "d3b", "ctx"):
        tp[name] = _layer(q[name]["wq"], q[name]["mult"], q[name]["bias"], device)
    for name, ca in (("u2red", q["ctx"]["wq"].shape[-1]),
                     ("u1red", q["u2red"]["wq"].shape[-1])):
        wq, mult, bias = q[name]["wq"], q[name]["mult"], q[name]["bias"]
        tp[name + "_up"] = _layer(wq[:, :, :ca], mult, bias, device)
        tp[name + "_skip"] = _layer(wq[:, :, ca:], mult, np.zeros_like(bias), device)
    tp["se"] = {
        f"{short}{i}": torch.tensor(np.asarray(q[f"ctxse/Dense_{i}"][field], np.float32),
                                    device=device)
        for i in (0, 1) for short, field in (("k", "kernel"), ("b", "bias"))
    }
    tp["alpha"] = _layer(q["alpha_q"]["wq"], q["alpha_q"]["mult"], q["alpha_q"]["bias"], device)
    return tp


# ---- plain (xla-style) trunk -------------------------------------------


def same_pads(size: int, k: int, stride: int, dil: int) -> tuple[int, int]:
    """XLA/TF 'SAME' padding (low, high) along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dil + 1 - size, 0)
    return total // 2, total - total // 2


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


def xla_trunk_alpha(x0: torch.Tensor, tp: dict) -> torch.Tensor:
    """d2dn -> d2b -> d3dn -> d3b -> ctx(dil 3) + residual -> SE ->
    u2red -> u1red -> int8 alpha head.  x0 [S, H, W, C0] s8 -> logits
    [S, H, W] f32."""
    d2 = _requant(_conv_i8(x0, tp["d2dn"], stride=2))
    d2 = _requant(_conv_i8(d2, tp["d2b"]))
    d3 = _requant(_conv_i8(d2, tp["d3dn"], stride=2))
    d3 = _requant(_conv_i8(d3, tp["d3b"]))
    c3 = _conv_i8(d3, tp["ctx"], dilation=3)
    ctx_f = torch.clamp(c3 + d3.to(torch.float32) * ACT_SCALE, 0.0, 6.0)
    ctx = _requant(_se(ctx_f, tp["se"]))
    u2 = split_conv_up(ctx, d2, tp["u2red_up"], tp["u2red_skip"])
    u1 = split_conv_up(u2, x0, tp["u1red_up"], tp["u1red_skip"])
    return _conv_i8(u1, tp["alpha"])[..., 0]


# ---- serving module ----------------------------------------------------


class QuantizedMatteNetHD(torch.nn.Module):
    """Packed u8 frames ``[S, H/b, W/b, b*b*3]`` -> ``{"alpha": [S, mh, mw]
    f32}``."""

    def __init__(self, q: dict, stem_stride: int, head_upsample: int, device="cpu"):
        super().__init__()
        self.stem_stride = stem_stride
        self.head_upsample = head_upsample
        self.register_buffer(
            "stem_w", torch.tensor(np.asarray(q["stem_w"], np.float32), device=device)
            .to(torch.bfloat16))
        self.register_buffer(
            "stem_b", torch.tensor(np.asarray(q["stem_b"], np.float32), device=device))
        self.trunk = trunk_params(q, device)

    def forward(self, frames_p: torch.Tensor) -> dict:
        from video_stream_segmenetation_tpu_torch.kernels.trunk_int8 import (
            fused_nano_trunk_alpha,
        )

        y = torch.matmul(frames_p.to(torch.bfloat16), self.stem_w)
        x0 = _requant(y.to(torch.float32) + self.stem_b)
        logits = fused_nano_trunk_alpha(x0.contiguous(), self.trunk)
        h0, w0 = logits.shape[-2:]
        uf = self.head_upsample
        dev = logits.device
        a_h = interp_matrix(uf * h0, h0, "half_pixel", device=dev)
        a_w = interp_matrix(uf * w0, w0, "half_pixel", device=dev)
        al = torch.matmul(torch.matmul(a_h, logits), a_w.t())
        return {"alpha": torch.sigmoid(al)}
