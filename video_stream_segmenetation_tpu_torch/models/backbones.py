"""Conv building blocks of the face models (port of ``models/backbones.py``
as the bf16 serving forward) and the seeded float trees the models load.

The reference runs these as bf16 XLA convolutions, so the port uses
``torch.nn.functional.conv2d`` in bf16 and mirrors flax's dtype flow:
input and kernel cast to bf16, BatchNorm on running averages computed in
f32 on the bf16 conv output and rounded back to bf16, relu6 in bf16.
Layers keep the reference's NHWC layout at their boundaries.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5


def same_pads(size: int, k: int, stride: int, dil: int) -> tuple[int, int]:
    """XLA/TF 'SAME' padding (low, high) along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dil + 1 - size, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                dilation: int = 1) -> torch.Tensor:
    """'SAME' conv of NCHW ``x`` with OIHW ``w`` (both one dtype)."""
    kh, kw = w.shape[2], w.shape[3]
    pt, pb = same_pads(x.shape[2], kh, stride, dilation)
    pl, pr = same_pads(x.shape[3], kw, stride, dilation)
    x = F.pad(x, (pl, pr, pt, pb))
    return F.conv2d(x, w, stride=stride, dilation=dilation)


def _oihw_bf16(kernel_hwio, device) -> torch.Tensor:
    k = torch.as_tensor(np.asarray(kernel_hwio, np.float32), device=device)
    return k.permute(3, 2, 0, 1).contiguous().to(torch.bfloat16)


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


class ConvBN(torch.nn.Module):
    """bf16 'SAME' conv (no bias) + BatchNorm on running averages + relu6,
    NCHW bf16 in and out."""

    def __init__(self, params: dict, stats: dict, stride: int = 1,
                 act: bool = True, device="cpu"):
        super().__init__()
        self.stride = stride
        self.act = act
        bn, bst = params["BatchNorm_0"], stats["BatchNorm_0"]
        self.register_buffer("w", _oihw_bf16(params["Conv_0"]["kernel"], device))
        self.register_buffer("mean", _f32(bst["mean"], device)[None, :, None, None])
        # flax: (x - mean) * (rsqrt(var + eps) * scale) + bias, in f32
        mul = torch.rsqrt(_f32(bst["var"], device) + BN_EPS) * _f32(bn["scale"], device)
        self.register_buffer("mul", mul[None, :, None, None])
        self.register_buffer("bias", _f32(bn["bias"], device)[None, :, None, None])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d_same(x, self.w, self.stride)
        y = ((y.to(torch.float32) - self.mean) * self.mul + self.bias).to(torch.bfloat16)
        return torch.clamp(y, 0.0, 6.0) if self.act else y


class Conv(torch.nn.Module):
    """flax ``nn.Conv`` with bias and ``dtype=bf16``: bf16 'SAME' conv, then
    the bias added in bf16.  NCHW bf16 in and out."""

    def __init__(self, params: dict, device="cpu"):
        super().__init__()
        self.register_buffer("w", _oihw_bf16(params["kernel"], device))
        self.register_buffer(
            "b", _f32(params["bias"], device).to(torch.bfloat16)[None, :, None, None])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_same(x, self.w) + self.b


# ---- seeded float trees -------------------------------------------------


def lecun_normal(rng: np.random.Generator, shape) -> np.ndarray:
    """flax's ``lecun_normal``: a normal truncated at 2 sigma, scaled to
    variance 1/fan_in (fan_in: every axis but the last)."""
    fan_in = int(np.prod(shape[:-1]))
    std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
    return (np.clip(rng.standard_normal(shape), -2.0, 2.0) * std).astype(np.float32)


def seeded_tree(rng: np.random.Generator, spec: dict) -> dict:
    """A flax-shaped float tree ``{"params", "batch_stats"}`` from ``spec``:
    a nested dict whose leaves are ``("convbn", hwio)`` (kernel, BatchNorm
    at unit statistics), ``("conv", hwio)`` (kernel, zero bias) or
    ``("dense", (in, out))``.  Kernels are drawn in ``spec``'s order."""
    params, stats = {}, {}
    for name, leaf in spec.items():
        if isinstance(leaf, dict):
            sub = seeded_tree(rng, leaf)
            params[name] = sub["params"]
            if sub["batch_stats"]:
                stats[name] = sub["batch_stats"]
            continue
        kind, shape = leaf
        c = shape[-1]
        if kind == "convbn":
            params[name] = {
                "Conv_0": {"kernel": lecun_normal(rng, shape)},
                "BatchNorm_0": {"scale": np.ones(c, np.float32),
                                "bias": np.zeros(c, np.float32)},
            }
            stats[name] = {"BatchNorm_0": {"mean": np.zeros(c, np.float32),
                                           "var": np.ones(c, np.float32)}}
        elif kind in ("conv", "dense"):
            params[name] = {"kernel": lecun_normal(rng, shape),
                            "bias": np.zeros(c, np.float32)}
        else:
            raise ValueError(f"unknown leaf kind {kind!r}")
    return {"params": params, "batch_stats": stats}
