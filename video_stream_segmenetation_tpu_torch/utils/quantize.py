"""Weight quantization (port of ``utils/quantize.py``): symmetric
per-output-channel int8 (and int4) quantization of a parameter tree,
dequantization on load, the reconstruction error, and stochastic rounding
of f32 weights to bf16 (``stochastic_round_bf16``, kernels/stochastic_round.py).

Trees are nested dicts (or lists and tuples) whose leaves are torch tensors
or numpy arrays; a quantized leaf is the reference's ``{"__quant__": True,
"q", "scale", "orig_dtype", "bits"}`` dict, with ``q`` int8 and ``scale``
f32 of the leaf's kind (a tensor on its device, or a numpy array) and
``orig_dtype`` numpy's dtype name, so that trees cross between the two
packages in both directions.  ``q`` and ``scale`` equal the reference's bit
for bit: the division by the scale is one IEEE f32 operation on both sides
and ``torch.round`` rounds half to even as ``jnp.round`` does.
"""

from __future__ import annotations

import numpy as np
import torch

# f32 -> bf16 stochastic rounding: the kernel's wrapper, under its reference name
from video_stream_segmenetation_tpu_torch.kernels.stochastic_round import (  # noqa: F401
    stochastic_round_bf16,
)


def _map(fn, tree, is_leaf=lambda leaf: False):
    if not is_leaf(tree):
        if isinstance(tree, dict):
            return {k: _map(fn, v, is_leaf) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(_map(fn, v, is_leaf) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    out = []
    _map(out.append, tree)
    return out


def _dtype_name(leaf) -> str:
    return str(leaf.dtype).removeprefix("torch.")


def _is_quant(leaf) -> bool:
    return isinstance(leaf, dict) and bool(leaf.get("__quant__"))


def quantize_tree(params, bits: int = 8, min_size: int = 1024):
    """Quantize every float leaf with at least ``min_size`` elements to
    int``bits`` with a per-output-channel (last axis) scale; smaller and
    non-float leaves pass through.  The structure is kept for
    :func:`dequantize_tree`."""
    qmax = 2 ** (bits - 1) - 1

    def quant(leaf):
        if isinstance(leaf, np.ndarray):
            if leaf.size < min_size or not np.issubdtype(leaf.dtype, np.floating):
                return leaf
            x = torch.as_tensor(leaf.astype(np.float32))
        elif isinstance(leaf, torch.Tensor):
            if leaf.numel() < min_size or not leaf.is_floating_point():
                return leaf
            x = leaf.detach().to(torch.float32)
        else:
            return leaf
        axes = tuple(range(x.ndim - 1))
        amax = x.abs().amax(dim=axes, keepdim=True) if axes else x.abs()
        scale = torch.clamp(amax / qmax, min=1e-12)
        q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax).to(torch.int8)
        if isinstance(leaf, np.ndarray):
            q, scale = q.numpy(), scale.numpy()
        return {"__quant__": True, "q": q, "scale": scale,
                "orig_dtype": _dtype_name(leaf), "bits": bits}

    return _map(quant, params)


def dequantize_tree(qparams):
    """Quantized leaves back to ``q * scale`` in f32, cast to the leaf's
    original dtype; other leaves pass through."""
    def dequant(leaf):
        if not _is_quant(leaf):
            return leaf
        q, scale = leaf["q"], leaf["scale"]
        if isinstance(q, np.ndarray):
            return (q.astype(np.float32) * scale).astype(leaf["orig_dtype"])
        return (q.to(torch.float32) * scale).to(getattr(torch, leaf["orig_dtype"]))

    return _map(dequant, qparams, is_leaf=_is_quant)


def quantization_error(params, bits: int = 8) -> float:
    """Max relative reconstruction error across the tree's leaves (each
    leaf's largest absolute error over its largest magnitude)."""
    deq = dequantize_tree(quantize_tree(params, bits))
    errs = []
    for a, b in zip(_leaves(params), _leaves(deq)):
        a, b = torch.as_tensor(a).float(), torch.as_tensor(b).float()
        denom = torch.clamp(a.abs().max(), min=1e-12)
        errs.append(float((a - b).abs().max() / denom))
    return max(errs) if errs else 0.0
