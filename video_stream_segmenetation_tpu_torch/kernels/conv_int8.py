"""The int8 fused 3x3 convolution as a CUDA kernel (``csrc/conv_int8.cu``).

Replaces the Pallas kernel
``video_stream_segmenetation_tpu/kernels/conv_int8.py::conv3x3_i8_fused``
(pallas_call at line 116): an int8 3x3 'SAME' conv at stride 1 and
dilation d, the per-channel dequant ``acc * mult + bias``, an optional
int8 residual, then relu6 and requant onto the 6/127 lattice (or, without
``act``, the symmetric clip of the linear output), s8 in and s8 out.  The
trunks of the micro, light and full plans route their 3x3 stride-1
``_qconv`` layers through it with ``int8_conv_impl='pallas'``, as the
reference's ``models/quantized.py::_qconv`` does.

Bound on an H100: operations (86.9 G int8 multiply-adds for plan B's b1
conv at S=64, 720p, against 151 MB moved).  The kernel is the trunk's
implicit GEMM on the int8 tensor cores (``csrc/wgmma_i8.cuh``, wgmma
m64n64k32 over a cp.async ring of 128-byte-swizzled stages): the act
forms at the trunk's widths (``Cout`` 64 to 256 in steps of 64) launch the
trunk's own instantiation, the rest its routed ones, where the no-act
forms are one more epilogue, a ``Cout`` that is not a multiple of 64 zero
fills the tile's missing weight rows and masks their stores, and a
``Cout`` above 256 takes more than one N tile.  wgmma takes the s8 weights
only K-major, so
the kernel reads them OHWI ``[Cout, 3, 3, Cin]``: the caller passes that
copy (``models/quantized.py::trunk_params`` keeps it as ``layer["w"]``
beside the HWIO ``wq``), or the wrapper makes one contiguous transpose of
``wq``.  One call is one launch and counts once in
``conv3x3_i8_fused.launches``.
"""

from __future__ import annotations

import torch

from video_stream_segmenetation_tpu_torch.kernels import _build
from video_stream_segmenetation_tpu_torch.models import quantized as Q


def conv3x3_i8_plain(x_i8: torch.Tensor, wq: torch.Tensor, mult: torch.Tensor,
                     bias: torch.Tensor, residual: torch.Tensor | None = None,
                     act: bool = True, dilation: int = 1) -> torch.Tensor:
    """The plain version: models/quantized.py's exact conv (float64 sums,
    the f32 epilogue) of the HWIO ``wq``, ``+ residual * 6/127`` in f32,
    then the requant of the Pallas kernel's epilogue (conv_int8.py:62-74)."""
    y = Q._conv_i8(x_i8, {"w": wq.permute(3, 0, 1, 2), "mult": mult, "bias": bias},
                   dilation=dilation)
    if residual is not None:
        y = y + residual.to(torch.float32) * Q.ACT_SCALE
    if act:
        return Q._requant(y)
    return torch.clamp(torch.round(y * Q.RELU6_SCALE), -127, 127).to(torch.int8)


def conv3x3_i8_fused(x_i8: torch.Tensor, wq: torch.Tensor, mult: torch.Tensor,
                     bias: torch.Tensor, residual: torch.Tensor | None = None,
                     act: bool = True, dilation: int = 1,
                     w_ohwi: torch.Tensor | None = None) -> torch.Tensor:
    """x ``[S, H, W, Cin]`` s8, wq ``[3, 3, Cin, Cout]`` s8 (HWIO, as the
    reference's), mult and bias ``[Cout]`` f32, residual ``[S, H, W,
    Cout]`` s8 or None -> ``[S, H, W, Cout]`` s8.  ``w_ohwi``: the same
    weights as ``[Cout, 3, 3, Cin]``, which must equal
    ``wq.permute(3, 0, 1, 2)``; where given, the kernel reads it and takes
    only its shape from ``wq``, and without it the wrapper makes that copy.
    A CPU tensor takes :func:`conv3x3_i8_plain` of ``wq``, after checking
    that ``w_ohwi``, where given, equals it; a CUDA tensor launches the
    kernel or raises (its copy is not compared there: that would cost a
    pass over the weights and a host sync a call)."""
    if x_i8.device.type == "cpu":
        if w_ohwi is not None and not torch.equal(w_ohwi, wq.permute(3, 0, 1, 2)):
            raise ValueError("conv3x3_i8_fused: w_ohwi is not wq.permute(3, 0, 1, 2)")
        return conv3x3_i8_plain(x_i8, wq, mult, bias, residual, act, dilation)
    s, h, w, cin = x_i8.shape
    cout = wq.shape[-1]
    if w_ohwi is None:
        w_ohwi = wq.permute(3, 0, 1, 2).contiguous()
    tensors = (x_i8, w_ohwi, mult, bias) + (() if residual is None else (residual,))
    checks = (
        (x_i8.dtype == wq.dtype == w_ohwi.dtype == torch.int8, "s8 activations and weights"),
        (tuple(wq.shape) == (3, 3, cin, cout), "weights [3, 3, Cin, Cout]"),
        (tuple(w_ohwi.shape) == (cout, 3, 3, cin), "OHWI weights [Cout, 3, 3, Cin]"),
        (cin % 32 == 0 and cout % 4 == 0, "Cin a multiple of 32, Cout of 4"),
        (mult.dtype == bias.dtype == torch.float32 and mult.numel() == bias.numel() == cout,
         "f32 mult and bias [Cout]"),
        (residual is None or (residual.dtype == torch.int8
                              and tuple(residual.shape) == (s, h, w, cout)),
         "an s8 residual [S, H, W, Cout]"),
        (dilation >= 1, "dilation >= 1"),
        (all(t.is_contiguous() and t.device == x_i8.device for t in tensors),
         "contiguous tensors on one device"),
        (all(t.data_ptr() % 16 == 0 for t in tensors[:4])
         and (residual is None or residual.data_ptr() % 2 == 0),
         "x, the weights, mult and bias 16-byte aligned, the residual 2-byte"),
    )
    for ok, what in checks:
        if not ok:
            raise ValueError(f"conv3x3_i8_fused: needs {what}; got x {tuple(x_i8.shape)} "
                             f"{x_i8.dtype}, wq {tuple(wq.shape)} {wq.dtype}, w_ohwi "
                             f"{tuple(w_ohwi.shape)}")
    lib = _build.library()
    out = torch.empty((s, h, w, cout), dtype=torch.int8, device=x_i8.device)
    stream = torch.cuda.current_stream(x_i8.device).cuda_stream
    _build.check(lib, lib.vst_conv3x3_i8_fused(
        x_i8.data_ptr(), w_ohwi.data_ptr(), mult.data_ptr(), bias.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        s, h, w, cin, cout, dilation, int(act), stream,
    ), "conv3x3_i8_fused")
    conv3x3_i8_fused.launches += 1
    return out


conv3x3_i8_fused.launches = 0
