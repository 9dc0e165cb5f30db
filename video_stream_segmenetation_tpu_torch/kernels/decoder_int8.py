"""One int8 decoder level as a CUDA kernel (``csrc/decoder_int8.cu``).

Replaces the Pallas kernel
``video_stream_segmenetation_tpu/kernels/decoder_int8.py::
fused_decoder_level`` (pallas_call at line 100): the split 1x1 decoder
conv ``requant(nearest_x2(small @ Wa * mult + bias) + skip @ Wb * mult)``
of the micro and light (plan C) trunks' u2 and u1 levels, s8 in and s8
out.

Bound on an H100: bytes (179 MB at micro's u1 level at S=64, 66 MB at
u2).  The kernel runs both products of a level in one block on the int8
tensor cores (wgmma): a tile of 64 parents' up product, whose f32 result
stays in registers, then the skip products of their 256 children, each
child's row in the same accumulator row as its parent's, so the epilogue
adds the parent's value without an exchange; both weight halves staged in
shared memory once a persistent block, the activations streamed through
a cp.async ring (see the source's header).  One call is one launch and
counts once in ``fused_decoder_level.launches``.
"""

from __future__ import annotations

import torch

from video_stream_segmenetation_tpu_torch.kernels import _build
from video_stream_segmenetation_tpu_torch.models import quantized as Q


def fused_decoder_level(small: torch.Tensor, skip: torch.Tensor, up: dict,
                        skip_layer: dict) -> torch.Tensor:
    """small ``[S, sh, sw, Ca]`` s8, skip ``[S, 2sh, 2sw, Cb]`` s8; ``up`` and
    ``skip_layer`` the up-path and skip halves of the level's 1x1 conv
    (models/quantized.py::trunk_params: ``w`` ``[Cout, 1, 1, C]`` s8,
    ``mult``, ``bias``; the skip half's bias is zero and unused here).
    Returns ``[S, 2sh, 2sw, Cout]`` s8.  A CPU tensor takes the plain
    version (models/quantized.py::split_conv_up: float64 1x1 products
    rounded to integers before the f32 epilogue); a CUDA tensor launches
    the kernel or raises.  Input channels so wide that both weight halves
    of a 64-channel tile do not fit in shared memory beside the ring are
    refused by the C entry point (csrc/decoder_int8.cu::decoder_smem), the
    one place that limit is worked out, and raise too."""
    if small.device.type == "cpu":
        return Q.split_conv_up(small, skip, up, skip_layer)
    s, sh, sw, ca = small.shape
    cb = skip.shape[-1]
    wa, wb = up["w"], skip_layer["w"]
    mult, bias = up["mult"], up["bias"]
    cout = wa.shape[0]
    tensors = (small, skip, wa, wb, mult, bias)
    checks = (
        (small.dtype == skip.dtype == wa.dtype == wb.dtype == torch.int8, "s8 operands"),
        (tuple(skip.shape[:3]) == (s, 2 * sh, 2 * sw), "skip at twice small's grid"),
        (tuple(wa.shape) == (cout, 1, 1, ca) and tuple(wb.shape) == (cout, 1, 1, cb),
         "1x1 weights [Cout, 1, 1, C]"),
        (ca % 32 == 0 and cb % 32 == 0, "input channels multiples of 32"),
        (mult.dtype == bias.dtype == torch.float32 and mult.numel() == bias.numel() == cout,
         "f32 mult and bias [Cout]"),
        (all(t.is_contiguous() and t.device == small.device for t in tensors),
         "contiguous tensors on one device"),
        (all(t.data_ptr() % 16 == 0 for t in tensors[:4]), "16-byte aligned s8 operands"),
    )
    for ok, what in checks:
        if not ok:
            raise ValueError(f"fused_decoder_level: needs {what}; got small "
                             f"{tuple(small.shape)} {small.dtype}, skip "
                             f"{tuple(skip.shape)}, weights {tuple(wa.shape)}/"
                             f"{tuple(wb.shape)}")
    lib = _build.library()
    out = torch.empty((s, 2 * sh, 2 * sw, cout), dtype=torch.int8, device=small.device)
    stream = torch.cuda.current_stream(small.device).cuda_stream
    _build.check(lib, lib.vst_decoder_level_i8(
        small.data_ptr(), skip.data_ptr(), wa.data_ptr(), wb.data_ptr(),
        mult.data_ptr(), bias.data_ptr(), out.data_ptr(),
        s, sh, sw, ca, cb, cout, stream,
    ), "decoder_level_i8")
    fused_decoder_level.launches += 1
    return out


fused_decoder_level.launches = 0
