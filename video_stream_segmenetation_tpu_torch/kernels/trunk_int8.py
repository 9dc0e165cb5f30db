"""The int8 pico, nano and micro trunks as CUDA kernels
(``csrc/trunk_int8.cu``).

Replaces the Pallas megakernel
``video_stream_segmenetation_tpu/kernels/trunk_int8.py`` (pallas_call at
``_run``, line 297) in its one-class form ``fused_nano_trunk_alpha_rowfold``
and its K-class form ``fused_nano_trunk_alpha_q``/``fused_nano_trunk_alpha``
(the multi-class presets, K = 4): d2dn -> d2b -> d3dn -> d3b -> ctx
(dilation 3) + residual -> SE -> u2red/u1red split 1x1 convs -> int8 3x3
alpha head with K output channels.  It takes the stem output in its
natural NHWC layout; the TPU's quad-parity folds are not carried over, so
the K-class logits come out as ``[S, H, W, K]`` directly (the reference
unfolds its quad columns ``qo*K + k`` to the same layout).

Bound on an H100: operations (about 1.44 G int8 multiply-adds a stream at
720p at the pico widths, 2.6 G at nano's) -- see the source's header for
the design.  One call of
:func:`fused_nano_trunk_alpha` is 11 launches (one per layer, SE, head)
and counts once in ``fused_nano_trunk_alpha.launches``.

:func:`micro_trunk_alpha` runs the micro plan, which the reference serves
as XLA convolutions plus two Pallas decoder levels: the same conv, SE and
head kernels (the blocks' SE adds the residual before its requant), and
kernels/decoder_int8.py for the u2 and u1 levels.  One call counts once in
``micro_trunk_alpha.launches`` (and twice in the decoder's count).
"""

from __future__ import annotations

import torch

from video_stream_segmenetation_tpu_torch.kernels import _build
from video_stream_segmenetation_tpu_torch.kernels.decoder_int8 import fused_decoder_level
from video_stream_segmenetation_tpu_torch.models import quantized as Q


def _ptr(t):
    return None if t is None else t.data_ptr()


def _conv(lib, stream, x, layer, out_dtype, stride=1, dil=1, mode=0,
          res=None, up=None):
    s, h, w, cin = x.shape
    wt = layer["w"]
    cout, kh, kw = wt.shape[0], wt.shape[1], wt.shape[2]
    if cin % 32 or wt.shape[3] != cin:
        raise ValueError(f"conv_i8: input channels {cin} must match the weights "
                         f"and be a multiple of 32")
    pt, _ = Q.same_pads(h, kh, stride, dil)
    pl, _ = Q.same_pads(w, kw, stride, dil)
    ho, wo = -(-h // stride), -(-w // stride)
    out = torch.empty((s, ho, wo, cout), dtype=out_dtype, device=x.device)
    _build.check(lib, lib.vst_conv_i8(
        x.data_ptr(), wt.data_ptr(), layer["mult"].data_ptr(),
        layer["bias"].data_ptr(), _ptr(res), _ptr(up), out.data_ptr(),
        s, h, w, cin, ho, wo, cout, kh, kw, stride, dil, pt, pl, mode, stream,
    ), "conv_i8")
    return out


# the K the head kernel takes (csrc/trunk_int8.cu ALPHA_HEAD_MAX_K)
ALPHA_HEAD_MAX_K = 16


def fused_nano_trunk_alpha(x0: torch.Tensor, tp: dict) -> torch.Tensor:
    """x0 [S, H, W, C0] s8 (stem output; H, W even twice over) + the trunk
    params of models/quantized.py::trunk_params (pico or nano widths, K
    head classes) -> alpha logits [S, H, W] f32 for K = 1, [S, H, W, K]
    for 1 < K <= ALPHA_HEAD_MAX_K.  A CPU tensor takes the plain version
    (the xla-style trunk models/quantized.py::xla_trunk_alpha); a CUDA
    tensor launches the kernels or raises."""
    if x0.device.type == "cpu":
        return Q.xla_trunk_alpha(x0, tp)
    if x0.dtype != torch.int8 or x0.dim() != 4 or not x0.is_contiguous():
        raise ValueError("fused_nano_trunk_alpha: x0 must be contiguous s8 [S,H,W,C]")
    s, h, w, c0 = x0.shape
    if h % 4 or w % 4:
        raise ValueError(f"fused_nano_trunk_alpha: H, W ({h}, {w}) must be multiples of 4")
    lib = _build.library()
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    f32, i8 = torch.float32, torch.int8
    d2 = _conv(lib, stream, x0, tp["d2dn"], i8, stride=2)
    d2 = _conv(lib, stream, d2, tp["d2b"], i8)
    d3 = _conv(lib, stream, d2, tp["d3dn"], i8, stride=2)
    d3 = _conv(lib, stream, d3, tp["d3b"], i8)
    ctx_f = _conv(lib, stream, d3, tp["ctx"], f32, dil=3, mode=2, res=d3)
    ctx = _se_requant(lib, stream, ctx_f, tp["se"])
    ya = _conv(lib, stream, ctx, tp["u2red_up"], f32, mode=1)
    u2 = _conv(lib, stream, d2, tp["u2red_skip"], i8, up=ya)
    ya = _conv(lib, stream, u2, tp["u1red_up"], f32, mode=1)
    u1 = _conv(lib, stream, x0, tp["u1red_skip"], i8, up=ya)
    logits = _alpha_head(lib, stream, u1, tp["alpha"])
    fused_nano_trunk_alpha.launches += 1
    return logits


fused_nano_trunk_alpha.launches = 0


def _se_requant(lib, stream, x_f, se, res=None):
    """SE gate over each stream's [H, W, C] f32 plane, + res * 6/127 where
    given, requant to s8."""
    ns, hs, ws, c = x_f.shape
    out = torch.empty_like(x_f, dtype=torch.int8)
    _build.check(lib, lib.vst_se_requant(
        x_f.data_ptr(), se["k0"].data_ptr(), se["b0"].data_ptr(),
        se["k1"].data_ptr(), se["b1"].data_ptr(), _ptr(res), out.data_ptr(),
        ns, hs * ws, c, se["b0"].shape[0], stream,
    ), "se_requant")
    return out


def _alpha_head(lib, stream, u1, head):
    s, h, w, c = u1.shape
    k = head["w"].shape[0]
    if not 1 <= k <= ALPHA_HEAD_MAX_K:
        raise ValueError(f"alpha_head_i8: {k} classes; the kernel takes 1 to "
                         f"{ALPHA_HEAD_MAX_K}")
    if head["mult"].numel() != k or head["bias"].numel() != k:
        raise ValueError(f"alpha_head_i8: mult and bias need one value a class ({k})")
    logits = torch.empty((s, h, w) if k == 1 else (s, h, w, k), dtype=torch.float32,
                         device=u1.device)
    _build.check(lib, lib.vst_alpha_head_i8(
        u1.data_ptr(), head["w"].data_ptr(), head["mult"].data_ptr(),
        head["bias"].data_ptr(), logits.data_ptr(), s, h, w, c, k, stream,
    ), "alpha_head_i8")
    return logits


def _block(lib, stream, x, bp):
    """Micro's _Block: 3x3 requant conv, 3x3 f32 conv, SE, + x, requant."""
    h = _conv(lib, stream, x, bp["c0"], torch.int8)
    y = _conv(lib, stream, h, bp["c1"], torch.float32, mode=1)
    return _se_requant(lib, stream, y, bp["se"], res=x)


def micro_encoder(x0: torch.Tensor, tp: dict):
    """The micro trunk's convolutions on the card: d2dn, d2b block, d3dn,
    d3b block, ctx (dilation 3) + residual, SE.  Returns (d2, ctx) s8."""
    lib = _build.library()
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    i8 = torch.int8
    d2 = _block(lib, stream, _conv(lib, stream, x0, tp["d2dn"], i8, stride=2), tp["d2b"])
    d3 = _block(lib, stream, _conv(lib, stream, d2, tp["d3dn"], i8, stride=2), tp["d3b"])
    ctx_f = _conv(lib, stream, d3, tp["ctx"], torch.float32, dil=3, mode=2, res=d3)
    return d2, _se_requant(lib, stream, ctx_f, tp["se"])


def micro_decoder(x0: torch.Tensor, d2: torch.Tensor, ctx: torch.Tensor,
                  tp: dict) -> torch.Tensor:
    """The micro trunk's u2 and u1 decoder levels and its int8 alpha head
    on the card -> alpha logits [S, H, W] f32."""
    u2 = fused_decoder_level(ctx, d2, tp["u2red_up"], tp["u2red_skip"])
    u1 = fused_decoder_level(u2, x0, tp["u1red_up"], tp["u1red_skip"])
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    return _alpha_head(_build.library(), stream, u1, tp["alpha"])


def micro_trunk_alpha(x0: torch.Tensor, tp: dict) -> torch.Tensor:
    """x0 [S, H, W, 128] s8 (stem output; H, W multiples of 4) + the micro
    trunk params of models/quantized.py::trunk_params -> alpha logits
    [S, H, W] f32.  A CPU tensor takes the plain version (the xla-style
    micro trunk models/quantized.py::xla_micro_trunk_alpha); a CUDA tensor
    launches the kernels (:func:`micro_encoder`, then
    :func:`micro_decoder`) or raises."""
    if x0.device.type == "cpu":
        return Q.xla_micro_trunk_alpha(x0, tp)
    if x0.dtype != torch.int8 or x0.dim() != 4 or not x0.is_contiguous():
        raise ValueError("micro_trunk_alpha: x0 must be contiguous s8 [S,H,W,C]")
    if x0.shape[1] % 4 or x0.shape[2] % 4:
        raise ValueError(f"micro_trunk_alpha: H, W {tuple(x0.shape[1:3])} must be "
                         "multiples of 4")
    logits = micro_decoder(x0, *micro_encoder(x0, tp), tp)
    micro_trunk_alpha.launches += 1
    return logits


micro_trunk_alpha.launches = 0
