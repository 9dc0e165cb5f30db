"""Conv building blocks of the float models (port of ``models/backbones.py``
as the bf16 serving forward: ``ConvBN`` with groups and dilation,
``SEBlock``, ``InvertedResidual``, ``MobileEncoder``, ``EASPP``,
``nearest_x2``) and the seeded float trees the models load.

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
                dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """'SAME' conv of NCHW ``x`` with OIHW ``w`` (both one dtype)."""
    kh, kw = w.shape[2], w.shape[3]
    pt, pb = same_pads(x.shape[2], kh, stride, dilation)
    pl, pr = same_pads(x.shape[3], kw, stride, dilation)
    x = F.pad(x, (pl, pr, pt, pb))
    return F.conv2d(x, w, stride=stride, dilation=dilation, groups=groups)


def _oihw_bf16(kernel_hwio, device) -> torch.Tensor:
    k = torch.as_tensor(np.asarray(kernel_hwio, np.float32), device=device)
    return k.permute(3, 2, 0, 1).contiguous().to(torch.bfloat16)


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


class ConvBN(torch.nn.Module):
    """bf16 'SAME' conv (no bias; ``groups`` input groups, ``dilation``) +
    BatchNorm on running averages + relu6, NCHW bf16 in and out."""

    def __init__(self, params: dict, stats: dict, stride: int = 1,
                 act: bool = True, device="cpu", groups: int = 1, dilation: int = 1):
        super().__init__()
        self.stride = stride
        self.act = act
        self.groups = groups
        self.dilation = dilation
        bn, bst = params["BatchNorm_0"], stats["BatchNorm_0"]
        self.register_buffer("w", _oihw_bf16(params["Conv_0"]["kernel"], device))
        self.register_buffer("mean", _f32(bst["mean"], device)[None, :, None, None])
        # flax: (x - mean) * (rsqrt(var + eps) * scale) + bias, in f32
        mul = torch.rsqrt(_f32(bst["var"], device) + BN_EPS) * _f32(bn["scale"], device)
        self.register_buffer("mul", mul[None, :, None, None])
        self.register_buffer("bias", _f32(bn["bias"], device)[None, :, None, None])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d_same(x, self.w, self.stride, self.dilation, self.groups)
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


class Dense(torch.nn.Module):
    """flax ``nn.Dense`` with ``dtype=bf16``: bf16 product, bias added in
    bf16."""

    def __init__(self, params: dict, device="cpu"):
        super().__init__()
        self.register_buffer("w", _f32(params["kernel"], device).to(torch.bfloat16))
        self.register_buffer("b", _f32(params["bias"], device).to(torch.bfloat16))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.w) + self.b


def mean_hw_bf16(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean`` of an NCHW bf16 tensor over H and W: summed in f32, the
    mean rounded to bf16 -> ``[N, C]``."""
    return x.to(torch.float32).mean(dim=(2, 3)).to(torch.bfloat16)


class SEBlock(torch.nn.Module):
    """Squeeze-excitation in bf16: the spatial mean, Dense, relu, Dense,
    sigmoid, times the input."""

    def __init__(self, params: dict, device="cpu"):
        super().__init__()
        self.d0 = Dense(params["Dense_0"], device)
        self.d1 = Dense(params["Dense_1"], device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.d1(torch.relu(self.d0(mean_hw_bf16(x))))
        return x * torch.sigmoid(s)[:, :, None, None]


class InvertedResidual(torch.nn.Module):
    """MobileNetV2 inverted residual: 1x1 expand (unless ``expand`` is 1),
    3x3 depthwise at ``stride``, optional SE, 1x1 project without
    activation, plus the input where stride is 1 and the width kept."""

    def __init__(self, params: dict, stats: dict, stride: int = 1, expand: int = 6,
                 use_se: bool = False, device="cpu"):
        super().__init__()
        names = iter(f"ConvBN_{i}" for i in range(3))
        layers = []
        if expand != 1:
            n = next(names)
            layers.append(ConvBN(params[n], stats[n], device=device))
        n = next(names)
        mid = params[n]["Conv_0"]["kernel"].shape[-1]
        layers.append(ConvBN(params[n], stats[n], stride=stride, groups=mid, device=device))
        self.expand_dw = torch.nn.ModuleList(layers)
        self.se = SEBlock(params["SEBlock_0"], device) if use_se else None
        n = next(names)
        self.project = ConvBN(params[n], stats[n], act=False, device=device)
        # input width: the 1x1 expand's input, or the depthwise conv's width
        k0 = params["ConvBN_0"]["Conv_0"]["kernel"].shape
        inp = k0[-2] if expand != 1 else k0[-1]
        self.residual = stride == 1 and inp == params[n]["Conv_0"]["kernel"].shape[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for layer in self.expand_dw:
            h = layer(h)
        if self.se is not None:
            h = self.se(h)
        h = self.project(h)
        return h + x if self.residual else h


# (features, stride, expand, use_se) of the encoder's inverted residuals at
# width 1.0 (the reference's MobileEncoder); the pyramid taps after blocks
# 0 (/2), 2 (/4), 4 (/8) and 7 (/16)
ENCODER_BLOCKS = ((16, 1, 1, False), (24, 2, 6, False), (24, 1, 6, False),
                  (40, 2, 6, True), (40, 1, 6, True), (96, 2, 6, True),
                  (96, 1, 6, True), (128, 1, 6, True))
ENCODER_TAPS = (0, 2, 4, 7)
EASPP_RATES = (1, 2, 4, 8)


class MobileEncoder(torch.nn.Module):
    """MobileNetV2-class encoder: a stride-2 3x3 ConvBN, then the inverted
    residuals of :data:`ENCODER_BLOCKS`; returns (f2, f4, f8, f16)."""

    def __init__(self, params: dict, stats: dict, device="cpu"):
        super().__init__()
        self.stem = ConvBN(params["ConvBN_0"], stats["ConvBN_0"], stride=2, device=device)
        self.blocks = torch.nn.ModuleList(
            InvertedResidual(params[f"InvertedResidual_{i}"], stats[f"InvertedResidual_{i}"],
                             stride=st, expand=ex, use_se=se, device=device)
            for i, (_, st, ex, se) in enumerate(ENCODER_BLOCKS))

    def forward(self, x: torch.Tensor):
        x = self.stem(x)
        feats = []
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i in ENCODER_TAPS:
                feats.append(x)
        return tuple(feats)


class EASPP(torch.nn.Module):
    """Efficient ASPP: a depthwise 3x3 ConvBN (no activation) at each of
    :data:`EASPP_RATES`, concatenated, a 1x1 ConvBN, then SE."""

    def __init__(self, params: dict, stats: dict, device="cpu"):
        super().__init__()
        n = len(EASPP_RATES)
        c = params["ConvBN_0"]["Conv_0"]["kernel"].shape[-1]
        self.branches = torch.nn.ModuleList(
            ConvBN(params[f"ConvBN_{i}"], stats[f"ConvBN_{i}"], act=False, groups=c,
                   dilation=r, device=device) for i, r in enumerate(EASPP_RATES))
        self.fuse = ConvBN(params[f"ConvBN_{n}"], stats[f"ConvBN_{n}"], device=device)
        self.se = SEBlock(params["SEBlock_0"], device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.cat([b(x) for b in self.branches], dim=1)
        return self.se(self.fuse(h))


def nearest_x2(x: torch.Tensor, times: int = 1) -> torch.Tensor:
    """x2 nearest upsample (repeat) of NCHW ``x``, ``times`` times."""
    for _ in range(times):
        x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return x


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
