"""The int8 pico trunk as CUDA kernels (``csrc/trunk_int8.cu``).

Replaces the Pallas megakernel
``video_stream_segmenetation_tpu/kernels/trunk_int8.py::
fused_nano_trunk_alpha_rowfold`` (pallas_call at ``_run``, line 297):
d2dn -> d2b -> d3dn -> d3b -> ctx (dilation 3) + residual -> SE ->
u2red/u1red split 1x1 convs -> int8 3x3 alpha head.  It takes the stem
output in its natural NHWC layout; the TPU's quad-parity folds are not
carried over.

Bound on an H100: operations (about 1.44 G int8 multiply-adds a stream at
720p) -- see the source's header for the design.  One call of
:func:`fused_nano_trunk_alpha` is 11 launches (one per layer, SE, head)
and counts once in ``fused_nano_trunk_alpha.launches``.
"""

from __future__ import annotations

import torch

from video_stream_segmenetation_tpu_torch.kernels import _build
from video_stream_segmenetation_tpu_torch.models import quantized as Q


def fused_nano_trunk_alpha_plain(x0: torch.Tensor, tp: dict) -> torch.Tensor:
    """Plain PyTorch version: the xla-style trunk of models/quantized.py."""
    return Q.xla_trunk_alpha(x0, tp)


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


def fused_nano_trunk_alpha(x0: torch.Tensor, tp: dict) -> torch.Tensor:
    """x0 [S, H, W, C0] s8 (stem output; H, W even twice over) + the trunk
    params of models/quantized.py::trunk_params -> alpha logits [S, H, W]
    f32.  A CPU tensor takes the plain version; a CUDA tensor launches the
    kernels or raises."""
    if x0.device.type == "cpu":
        return fused_nano_trunk_alpha_plain(x0, tp)
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
    se = tp["se"]
    ns, hs, ws, c3 = ctx_f.shape
    ctx = torch.empty_like(ctx_f, dtype=i8)
    _build.check(lib, lib.vst_se_requant(
        ctx_f.data_ptr(), se["k0"].data_ptr(), se["b0"].data_ptr(),
        se["k1"].data_ptr(), se["b1"].data_ptr(), ctx.data_ptr(),
        ns, hs * ws, c3, se["b0"].shape[0], stream,
    ), "se_requant")
    ya = _conv(lib, stream, ctx, tp["u2red_up"], f32, mode=1)
    u2 = _conv(lib, stream, d2, tp["u2red_skip"], i8, up=ya)
    ya = _conv(lib, stream, u2, tp["u1red_up"], f32, mode=1)
    u1 = _conv(lib, stream, x0, tp["u1red_skip"], i8, up=ya)
    head = tp["alpha"]
    logits = torch.empty((s, h, w), dtype=f32, device=x0.device)
    _build.check(lib, lib.vst_alpha_head_i8(
        u1.data_ptr(), head["w"].data_ptr(), head["mult"].data_ptr(),
        head["bias"].data_ptr(), logits.data_ptr(), s, h, w, c0, stream,
    ), "alpha_head_i8")
    fused_nano_trunk_alpha.launches += 1
    return logits


fused_nano_trunk_alpha.launches = 0
