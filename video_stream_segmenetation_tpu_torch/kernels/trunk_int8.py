"""The int8 trunks as CUDA kernels (``csrc/trunk_int8.cu``): pico, nano and
femto, micro, light (plan C) and full (plan B).

Replaces the Pallas megakernel
``video_stream_segmenetation_tpu/kernels/trunk_int8.py`` (pallas_call at
``_run``, line 297) in its one-class form ``fused_nano_trunk_alpha_rowfold``,
its K-class form ``fused_nano_trunk_alpha_q``/``fused_nano_trunk_alpha``
(the multi-class presets, K = 4) and its u1-out form ``fused_nano_trunk``
(``int8_head_impl='bf16'``): d2dn -> d2b -> d3dn -> d3b -> ctx
(dilation 3) + residual -> SE -> u2red/u1red split 1x1 convs [-> int8 3x3
alpha head with K output channels].  It takes the stem output in its
natural NHWC layout; the TPU's quad-parity folds are not carried over, so
the K-class logits come out as ``[S, H, W, K]`` directly (the reference
unfolds its quad columns ``qo*K + k`` to the same layout).

Bound on an H100: operations (about 1.44 G int8 multiply-adds a stream at
720p at the pico widths, 2.6 G at nano's, 1.18 G at femto's, counted from
the shapes) -- see the source's header for the design.  The kernels read
the widths from the weights: femto runs every level at 128 channels.  One
call of :func:`fused_nano_trunk_alpha` is 11 launches (one per layer, SE,
head) and counts once in
``fused_nano_trunk_alpha.launches``; one call of :func:`fused_nano_trunk`
is the same launches but the head and counts once in
``fused_nano_trunk.launches``.

The micro, light and full plans, which the reference serves as XLA
convolutions plus Pallas decoder levels (and, with
``int8_conv_impl='pallas'``, its fused 3x3 conv kernel), run on the same
conv, SE and head kernels (a block's SE adds the residual before its
requant; plan B's b1 block, which has no SE, adds it in the conv's
epilogue), kernels/decoder_int8.py for their 1x1 decoder levels, and
kernels/conv_int8.py for their routed 3x3 convs with ``conv_impl='pallas'``.
Plan B's 3x3 decoder convs over ``concat(nearest_x2(small), skip)`` run as
their two halves: the up-path conv reads ``small`` through a nearest x2
upsample into an f32 addend, the skip conv adds it in the reference's
order.  :func:`micro_trunk_alpha`, :func:`light_trunk_alpha` and
:func:`full_trunk_alpha` count one call each, in their own counters (and
in the decoder's and the conv kernel's counts, where those launch); with
``head=False`` they return u1.
"""

from __future__ import annotations

import torch

from video_stream_segmenetation_tpu_torch.kernels import _build
from video_stream_segmenetation_tpu_torch.kernels.conv_int8 import conv3x3_i8_fused
from video_stream_segmenetation_tpu_torch.kernels.decoder_int8 import fused_decoder_level
from video_stream_segmenetation_tpu_torch.models import quantized as Q


def _ptr(t):
    return None if t is None else t.data_ptr()


def _conv(lib, stream, x, layer, out_dtype, stride=1, dil=1, mode=0,
          res=None, up=None, in_up=False):
    """One launch of ``vst_conv_i8``.  ``in_up``: ``x`` is read through a
    nearest x2 upsample (the conv runs on twice its grid).  ``up``: an f32
    addend at the output's grid or at half of it (broadcast nearest x2)."""
    s, h, w, cin = x.shape
    if in_up:
        h, w = 2 * h, 2 * w
    wt = layer["w"]
    cout, kh, kw = wt.shape[0], wt.shape[1], wt.shape[2]
    if cin % 32 or wt.shape[3] != cin:
        raise ValueError(f"conv_i8: input channels {cin} must match the weights "
                         f"and be a multiple of 32")
    if cout % 64 or not 64 <= cout <= 256:
        raise ValueError(f"conv_i8: {cout} output channels; the kernel takes a multiple "
                         f"of 64 up to 256")
    mult, bias = layer["mult"], layer["bias"]
    if not all(t.is_contiguous() for t in (x, wt, mult, bias)) or \
            (x.data_ptr() | wt.data_ptr() | mult.data_ptr() | bias.data_ptr()) % 16:
        raise ValueError("conv_i8: x, the weights, mult and bias must be contiguous and "
                         "16-byte aligned")
    pt, _ = Q.same_pads(h, kh, stride, dil)
    pl, _ = Q.same_pads(w, kw, stride, dil)
    ho, wo = -(-h // stride), -(-w // stride)
    up_shift = 0
    if up is not None:
        up_shift = 0 if tuple(up.shape[1:3]) == (ho, wo) else 1
        if tuple(up.shape) != (s, ho >> up_shift, wo >> up_shift, cout) or (
                up_shift and (ho | wo) & 1):
            raise ValueError(f"conv_i8: addend {tuple(up.shape)} is at neither the "
                             f"output grid {(ho, wo)} nor half of it")
    out = torch.empty((s, ho, wo, cout), dtype=out_dtype, device=x.device)
    _build.check(lib, lib.vst_conv_i8(
        x.data_ptr(), wt.data_ptr(), mult.data_ptr(), bias.data_ptr(), _ptr(res), _ptr(up),
        out.data_ptr(),
        s, h, w, cin, ho, wo, cout, kh, kw, stride, dil, pt, pl, mode, int(in_up),
        up_shift, stream,
    ), "conv_i8")
    return out


# the K the head kernel takes (csrc/trunk_int8.cu ALPHA_HEAD_MAX_K)
ALPHA_HEAD_MAX_K = 16


def _check_x0(x0: torch.Tensor, what: str) -> None:
    if x0.dtype != torch.int8 or x0.dim() != 4 or not x0.is_contiguous():
        raise ValueError(f"{what}: x0 must be contiguous s8 [S,H,W,C]")
    if x0.shape[1] % 4 or x0.shape[2] % 4:
        raise ValueError(f"{what}: H, W {tuple(x0.shape[1:3])} must be multiples of 4")


def _launcher(x0):
    return _build.library(), torch.cuda.current_stream(x0.device).cuda_stream


def _nano_u1(lib, stream, x0, tp):
    """The pico/nano/femto trunk's 10 launches: x0 -> u1 s8."""
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
    return _conv(lib, stream, x0, tp["u1red_skip"], i8, up=ya)


def fused_nano_trunk_alpha(x0: torch.Tensor, tp: dict) -> torch.Tensor:
    """x0 [S, H, W, C0] s8 (stem output; H, W even twice over) + the trunk
    params of models/quantized.py::trunk_params (pico, nano or femto widths, K
    head classes) -> alpha logits [S, H, W] f32 for K = 1, [S, H, W, K]
    for 1 < K <= ALPHA_HEAD_MAX_K.  A CPU tensor takes the plain version
    (the xla-style trunk models/quantized.py::xla_trunk_alpha); a CUDA
    tensor launches the kernels or raises."""
    if x0.device.type == "cpu":
        return Q.xla_trunk_alpha(x0, tp)
    _check_x0(x0, "fused_nano_trunk_alpha")
    lib, stream = _launcher(x0)
    logits = _alpha_head(lib, stream, _nano_u1(lib, stream, x0, tp), tp["alpha"])
    fused_nano_trunk_alpha.launches += 1
    return logits


fused_nano_trunk_alpha.launches = 0


def fused_nano_trunk(x0: torch.Tensor, tp: dict) -> torch.Tensor:
    """The u1-out form (the reference's ``fused_nano_trunk``,
    trunk_int8.py:341): the pico, nano or femto trunk without its head, x0 [S, H,
    W, C0] s8 -> u1 [S, H, W, C0] s8, the bf16 head's input.  A CPU tensor
    takes the plain version (models/quantized.py::xla_trunk); a CUDA tensor
    launches the kernels or raises."""
    if x0.device.type == "cpu":
        return Q.xla_trunk(x0, tp)
    _check_x0(x0, "fused_nano_trunk")
    lib, stream = _launcher(x0)
    u1 = _nano_u1(lib, stream, x0, tp)
    fused_nano_trunk.launches += 1
    return u1


fused_nano_trunk.launches = 0


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


def _qconv(lib, stream, x, layer, conv_impl, dil=1):
    """A 3x3 stride-1 conv + relu6 requant that the reference routes by
    ``conv_impl`` (its ``_qconv``): kernels/conv_int8.py with 'pallas',
    the trunk's conv kernel with 'xla' (the same numerics)."""
    if conv_impl == "pallas":
        return conv3x3_i8_fused(x, layer["wq"], layer["mult"], layer["bias"], dilation=dil,
                                w_ohwi=layer["w"])
    return _conv(lib, stream, x, layer, torch.int8, dil=dil)


def _block(lib, stream, x, bp, conv_impl="xla"):
    """The residual _Block: 3x3 requant conv, 3x3 conv, SE where the block
    has one, + x, requant."""
    h = _qconv(lib, stream, x, bp["c0"], conv_impl)
    if "se" not in bp:  # plan B's b1: the residual in the conv's epilogue
        return _conv(lib, stream, h, bp["c1"], torch.int8, res=x)
    y = _conv(lib, stream, h, bp["c1"], torch.float32, mode=1)
    return _se_requant(lib, stream, y, bp["se"], res=x)


def _down_block(lib, stream, x, layer, bp, conv_impl):
    """A stride-2 conv, then a residual block."""
    d = _conv(lib, stream, x, layer, torch.int8, stride=2)
    return _block(lib, stream, d, bp, conv_impl)


def micro_encoder(x0: torch.Tensor, tp: dict, conv_impl: str = "xla"):
    """The micro trunk's convolutions on the card: d2dn, d2b block, d3dn,
    d3b block, ctx (dilation 3) + residual, SE.  Returns (d2, ctx) s8."""
    lib, stream = _launcher(x0)
    d2 = _down_block(lib, stream, x0, tp["d2dn"], tp["d2b"], conv_impl)
    d3 = _down_block(lib, stream, d2, tp["d3dn"], tp["d3b"], conv_impl)
    ctx_f = _conv(lib, stream, d3, tp["ctx"], torch.float32, dil=3, mode=2, res=d3)
    return d2, _se_requant(lib, stream, ctx_f, tp["se"])


def micro_decoder(x0: torch.Tensor, d2: torch.Tensor, ctx: torch.Tensor,
                  tp: dict, head: bool = True) -> torch.Tensor:
    """The micro trunk's u2 and u1 decoder levels and its int8 alpha head
    on the card -> alpha logits [S, H, W] f32 (u1 s8 without ``head``)."""
    u2 = fused_decoder_level(ctx, d2, tp["u2red_up"], tp["u2red_skip"])
    u1 = fused_decoder_level(u2, x0, tp["u1red_up"], tp["u1red_skip"])
    if not head:
        return u1
    return _alpha_head(*_launcher(x0), u1, tp["alpha"])


def micro_trunk_alpha(x0: torch.Tensor, tp: dict, conv_impl: str = "xla",
                      head: bool = True) -> torch.Tensor:
    """x0 [S, H, W, 128] s8 (stem output; H, W multiples of 4) + the micro
    trunk params of models/quantized.py::trunk_params -> alpha logits
    [S, H, W] f32, or u1 s8 without ``head``.  A CPU tensor takes the plain
    version (models/quantized.py::xla_micro_trunk and the int8 head); a
    CUDA tensor launches the kernels (:func:`micro_encoder`, then
    :func:`micro_decoder`) or raises."""
    if x0.device.type == "cpu":
        u1 = Q.xla_micro_trunk(x0, tp)
        return Q.alpha_head(u1, tp["alpha"]) if head else u1
    _check_x0(x0, "micro_trunk_alpha")
    out = micro_decoder(x0, *micro_encoder(x0, tp, conv_impl), tp, head)
    micro_trunk_alpha.launches += 1
    return out


micro_trunk_alpha.launches = 0


def _deep(lib, stream, b1, tp, conv_impl):
    """Plans B and C below b1: d2dn, d2b block, d3dn, d3b block, ctx2
    (dilation 2, requant), ctx4 (dilation 4) + residual, SE.  Returns
    (d2, ctx) s8."""
    d2 = _down_block(lib, stream, b1, tp["d2dn"], tp["d2b"], conv_impl)
    d3 = _down_block(lib, stream, d2, tp["d3dn"], tp["d3b"], conv_impl)
    c2 = _qconv(lib, stream, d3, tp["ctx2"], conv_impl, dil=2)
    ctx_f = _conv(lib, stream, c2, tp["ctx4"], torch.float32, dil=4, mode=2, res=d3)
    return d2, _se_requant(lib, stream, ctx_f, tp["se"])


def light_trunk_alpha(x0: torch.Tensor, tp: dict, conv_impl: str = "xla",
                      head: bool = True) -> torch.Tensor:
    """Plan C (``matting_decoder='light'``): x0 [S, H, W, 128] s8 (H, W
    multiples of 4) -> b1c -> the deep stages -> u2red (decoder kernel) ->
    u2 (3x3) -> u1red (decoder kernel, over b1) -> alpha logits [S, H, W]
    f32, or u1 s8 without ``head``.  A CPU tensor takes the plain version
    (models/quantized.py::xla_light_trunk and the int8 head); a CUDA tensor
    launches the kernels or raises."""
    if x0.device.type == "cpu":
        u1 = Q.xla_light_trunk(x0, tp)
        return Q.alpha_head(u1, tp["alpha"]) if head else u1
    _check_x0(x0, "light_trunk_alpha")
    lib, stream = _launcher(x0)
    b1 = _qconv(lib, stream, x0, tp["b1c"], conv_impl)
    d2, ctx = _deep(lib, stream, b1, tp, conv_impl)
    u2 = fused_decoder_level(ctx, d2, tp["u2red_up"], tp["u2red_skip"])
    u2 = _qconv(lib, stream, u2, tp["u2"], conv_impl)
    out = fused_decoder_level(u2, b1, tp["u1red_up"], tp["u1red_skip"])
    if head:
        out = _alpha_head(lib, stream, out, tp["alpha"])
    light_trunk_alpha.launches += 1
    return out


light_trunk_alpha.launches = 0


def _split_conv(lib, stream, small, skip, up, skip_layer):
    """Plan B's 3x3 conv over concat(nearest_x2(small), skip): the up-path
    half reads ``small`` through the upsample into ``acc_a * mult + bias``
    (f32), the skip half adds its ``acc_b * mult`` to that, then requant."""
    ya = _conv(lib, stream, small, up, torch.float32, mode=1, in_up=True)
    return _conv(lib, stream, skip, skip_layer, torch.int8, up=ya)


def full_trunk_alpha(x0: torch.Tensor, tp: dict, conv_impl: str = "xla",
                     head: bool = True) -> torch.Tensor:
    """Plan B (``matting_decoder='full'``): x0 [S, H, W, 128] s8 (H, W
    multiples of 4) -> b1 block (no SE) -> the deep stages -> u2 and u1
    split 3x3 convs -> alpha logits [S, H, W] f32, or u1 s8 without
    ``head``.  A CPU tensor takes the plain version
    (models/quantized.py::xla_full_trunk and the int8 head); a CUDA tensor
    launches the kernels or raises."""
    if x0.device.type == "cpu":
        u1 = Q.xla_full_trunk(x0, tp)
        return Q.alpha_head(u1, tp["alpha"]) if head else u1
    _check_x0(x0, "full_trunk_alpha")
    lib, stream = _launcher(x0)
    b1 = _block(lib, stream, x0, tp["b1"], conv_impl)
    d2, ctx = _deep(lib, stream, b1, tp, conv_impl)
    u2 = _split_conv(lib, stream, ctx, d2, tp["u2_up"], tp["u2_skip"])
    out = _split_conv(lib, stream, u2, b1, tp["u1_up"], tp["u1_skip"])
    if head:
        out = _alpha_head(lib, stream, out, tp["alpha"])
    full_trunk_alpha.launches += 1
    return out


full_trunk_alpha.launches = 0

# the counted trunk of each plan with residual blocks
PLAN_TRUNKS = {"micro": micro_trunk_alpha, "light": light_trunk_alpha,
               "full": full_trunk_alpha}
