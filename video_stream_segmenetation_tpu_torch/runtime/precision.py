"""The precision the serving step's products run at, pinned.

The step's f32 products (the letterbox and ROI resizes of the face path,
the multi-class blur and class-field contraction, the background resize)
follow the reference's f32, and its bf16 products (the stem, the packed
composites' interpolation passes) round once, from an f32 sum.  PyTorch
lets process-wide flags change both on the card: TF32 for cuBLAS matmuls
and cuDNN convolutions, and cuBLAS reducing split-K partial sums in bf16.
:func:`pinned` turns all three off for the block it guards and restores
the caller's values after it, so the engine's results do not depend on
what the host process set.  It uses PyTorch's boolean flags (setting them
keeps PyTorch's older and newer precision settings consistent).
"""

from __future__ import annotations

import contextlib

import torch


def _flags():
    m = torch.backends.cuda.matmul
    return (m.allow_tf32, torch.backends.cudnn.allow_tf32,
            m.allow_bf16_reduced_precision_reduction)


def _set(matmul_tf32: bool, cudnn_tf32: bool, bf16_reduction: bool) -> None:
    m = torch.backends.cuda.matmul
    m.allow_tf32 = matmul_tf32
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    m.allow_bf16_reduced_precision_reduction = bf16_reduction


@contextlib.contextmanager
def pinned():
    """TF32 off for matmuls and convolutions, bf16 reductions off, inside
    the block; the caller's flags restored after it, also on an error."""
    saved = _flags()
    _set(False, False, False)
    try:
        yield
    finally:
        _set(*saved)
