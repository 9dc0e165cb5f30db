"""Conv building blocks of the float models (port of ``models/backbones.py``:
``ConvBN`` with groups and dilation, ``PatchifiedConv``, ``Conv``, ``Dense``, ``SEBlock``,
``InvertedResidual``, ``MobileEncoder``, ``EASPP``, ``nearest_x2``) and the
seeded float trees the models load.

The layers hold f32 ``nn.Parameter``s and cast to their compute ``dtype``
inside ``forward``, as flax does with ``param_dtype=f32`` and ``dtype=bf16``:
input and kernel cast to the compute dtype, the convolution in it,
BatchNorm on its running averages computed in f32 and rounded back, relu6 in
the compute dtype.  The BatchNorm keeps flax's frozen form
(``use_running_average=True`` in training too, reference
``backbones.py:57-110``); its ``mean`` and ``var`` are parameters, since the
reference's trainer differentiates and updates its ``batch_stats``
(``train/step.py:37-47``).  Parameters are made frozen; MatteNetHD turns
its on, and a trainer its model's (train/).  The compute-dtype tensors are
derived from the parameters at each call, except in a model that
:func:`freeze` froze for serving: there once, when it is frozen.
The relu6 is ``F.relu6`` where autograd records (its gradient is 0 at
both bounds, as ``jax.nn.relu6``'s is), else ``torch.clamp``.  Layers
keep the reference's NHWC layout at their boundaries and NCHW inside.
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
    if (w.requires_grad and x.device.type == "cpu" and x.dtype == torch.bfloat16
            and groups > 1 and dilation > 1):
        # PyTorch's CPU bf16 depthwise conv gives a wrong kernel gradient
        # at dilation > 1 (uninitialized values, up to inf); the f32 conv of
        # the same bf16 values, rounded, is what a bf16 conv with f32
        # accumulation computes, and its gradients are right
        return F.conv2d(x.float(), w.float(), stride=stride, dilation=dilation,
                        groups=groups).to(x.dtype)
    return F.conv2d(x, w, stride=stride, dilation=dilation, groups=groups)


def _param(a, device, perm=None) -> torch.nn.Parameter:
    """An f32 parameter, frozen until the model that trains it says so; a
    copy, so that training never writes into the caller's tree."""
    t = torch.tensor(np.asarray(a, np.float32), device=device)
    if perm is not None:
        t = t.permute(*perm).contiguous()
    return torch.nn.Parameter(t, requires_grad=False)


def _numpy(t: torch.Tensor, perm=None) -> np.ndarray:
    t = t.detach()
    if perm is not None:
        t = t.permute(*perm)
    return t.cpu().numpy().copy()


HWIO_TO_OIHW = (3, 2, 0, 1)
OIHW_TO_HWIO = (2, 3, 1, 0)


class _Layer(torch.nn.Module):
    """A layer whose forward reads tensors derived from its parameters
    (:meth:`_derive`): at each call, or those :func:`freeze` kept."""

    _frozen = None

    def derived(self):
        return self._derive() if self._frozen is None else self._frozen


def freeze(model: torch.nn.Module) -> torch.nn.Module:
    """Freeze a model for serving: no parameter requires a gradient, so
    that no step records an autograd graph, and each layer derives its
    compute-dtype tensors now, once, so that a step issues no casts for
    them.  Nothing may change the parameters after (the Engine's models)."""
    model.requires_grad_(False)
    for m in model.modules():
        if isinstance(m, _Layer):
            m._frozen = m._derive()
    return model


class ConvBN(_Layer):
    """'SAME' conv (no bias; ``groups`` input groups, ``dilation``) +
    BatchNorm on running averages + relu6, NCHW ``dtype`` in and out.
    Parameters (f32): ``kernel`` OIHW, BatchNorm ``scale``, ``bias``,
    ``mean``, ``var``."""

    def __init__(self, params: dict, stats: dict, stride: int = 1,
                 act: bool = True, device="cpu", groups: int = 1, dilation: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.stride = stride
        self.act = act
        self.groups = groups
        self.dilation = dilation
        self.dtype = dtype
        bn, bst = params["BatchNorm_0"], stats["BatchNorm_0"]
        self.kernel = _param(params["Conv_0"]["kernel"], device, HWIO_TO_OIHW)
        self.scale = _param(bn["scale"], device)
        self.bias = _param(bn["bias"], device)
        self.mean = _param(bst["mean"], device)
        self.var = _param(bst["var"], device)

    def _derive(self):
        # flax: (x - mean) * (rsqrt(var + eps) * scale) + bias, in f32
        mul = torch.rsqrt(self.var + BN_EPS) * self.scale
        return (self.kernel.to(self.dtype), self.mean[None, :, None, None],
                mul[None, :, None, None], self.bias[None, :, None, None])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.derived()
        return self.epilogue(conv2d_same(x, d[0], self.stride, self.dilation, self.groups), d)

    def epilogue(self, y: torch.Tensor, derived=None) -> torch.Tensor:
        """BatchNorm and relu6 on the conv's NCHW output ``y``."""
        _, mean, mul, bias = self.derived() if derived is None else derived
        y = ((y.to(torch.float32) - mean) * mul + bias).to(self.dtype)
        if not self.act:
            return y
        # F.relu6 where autograd records (its gradient is 0 at both bounds, as
        # jax.nn.relu6's is); else torch.clamp, the same values in one host
        # dispatch where relu6 takes three
        return F.relu6(y) if y.requires_grad else torch.clamp(y, 0.0, 6.0)

    def export(self) -> tuple[dict, dict]:
        """The flax ``(params, batch_stats)`` entries of this layer, numpy."""
        return ({"Conv_0": {"kernel": _numpy(self.kernel, OIHW_TO_HWIO)},
                 "BatchNorm_0": {"scale": _numpy(self.scale), "bias": _numpy(self.bias)}},
                {"BatchNorm_0": {"mean": _numpy(self.mean), "var": _numpy(self.var)}})


def patch_weights(kernel_hwio, u8_input: bool):
    """The reference's ``PatchifiedConv`` weights: an HWIO kernel (numpy or
    torch) reshaped to ``[kh*kw*cin, cout]`` in (dy, dx, c) order, the
    packed lane order; for u8 input the /255 of the frames folded into
    the weights, in the kernel's own dtype."""
    w = kernel_hwio.reshape(-1, kernel_hwio.shape[-1])
    return w / 255.0 if u8_input else w


class PatchifiedConv(_Layer):
    """The conv of a ConvBN whose stride is its kernel, over packed input
    ``[B, H/k, W/k, k*k*cin]`` (u8, or float in [0, 1]): one product with
    :func:`patch_weights` (port of ``PatchifiedConv``).  As the reference:
    u8 input multiplies the weights divided by 255 in f32, both operands
    cast to the compute dtype (so it is not the natural conv of the frames
    divided by 255 in that dtype); float input multiplies the weights
    themselves.  It holds no parameter: it reads the kernel of ``conv``,
    the ConvBN it serves (one tree for either input, as the reference's
    ``Conv_0``).  Returns NCHW ``[B, cout, H/k, W/k]`` in the compute dtype
    (the ConvBN's :meth:`~ConvBN.epilogue` comes after)."""

    def __init__(self, conv: ConvBN):
        super().__init__()
        self.__dict__["conv"] = conv  # not a submodule: its kernel is the ConvBN's

    def _derive(self):
        k = self.conv.kernel.permute(*OIHW_TO_HWIO)
        dt = self.conv.dtype
        return patch_weights(k, True).to(dt), patch_weights(k, False).to(dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w_u8, w_f = self.derived()
        w = w_u8 if x.dtype == torch.uint8 else w_f
        return torch.matmul(x.to(w.dtype), w).permute(0, 3, 1, 2)


class Conv(_Layer):
    """flax ``nn.Conv`` with bias: a 'SAME' conv in ``dtype``, then the bias
    added in ``dtype``.  NCHW in and out."""

    def __init__(self, params: dict, device="cpu", dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.kernel = _param(params["kernel"], device, HWIO_TO_OIHW)
        self.bias = _param(params["bias"], device)

    def _derive(self):
        return self.kernel.to(self.dtype), self.bias.to(self.dtype)[None, :, None, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.derived()
        return conv2d_same(x, w) + b

    def export(self) -> tuple[dict, dict]:
        return {"kernel": _numpy(self.kernel, OIHW_TO_HWIO), "bias": _numpy(self.bias)}, {}


class Dense(_Layer):
    """flax ``nn.Dense``: the product in ``dtype``, the bias added in
    ``dtype``."""

    def __init__(self, params: dict, device="cpu", dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.kernel = _param(params["kernel"], device)
        self.bias = _param(params["bias"], device)

    def _derive(self):
        return self.kernel.to(self.dtype), self.bias.to(self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.derived()
        return torch.matmul(x, w) + b

    def export(self) -> tuple[dict, dict]:
        return {"kernel": _numpy(self.kernel), "bias": _numpy(self.bias)}, {}


def mean_hw(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean`` of an NCHW tensor over H and W: summed in f32, the mean
    rounded to the input's dtype -> ``[N, C]``."""
    return x.to(torch.float32).mean(dim=(2, 3)).to(x.dtype)


class SEBlock(torch.nn.Module):
    """Squeeze-excitation in ``dtype``: the spatial mean, Dense, relu,
    Dense, sigmoid, times the input."""

    def __init__(self, params: dict, device="cpu", dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.d0 = Dense(params["Dense_0"], device, dtype)
        self.d1 = Dense(params["Dense_1"], device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.d1(torch.relu(self.d0(mean_hw(x))))
        return x * torch.sigmoid(s)[:, :, None, None]

    def export(self) -> tuple[dict, dict]:
        return export_layers({"Dense_0": self.d0, "Dense_1": self.d1})


def export_layers(layers: dict) -> tuple[dict, dict]:
    """The flax ``(params, batch_stats)`` subtrees of named layers (each
    with an ``export()``); layers without statistics get no entry there."""
    params, stats = {}, {}
    for name, layer in layers.items():
        params[name], st = layer.export()
        if st:
            stats[name] = st
    return params, stats


class InvertedResidual(torch.nn.Module):
    """MobileNetV2 inverted residual: 1x1 expand (unless ``expand`` is 1),
    3x3 depthwise at ``stride``, optional SE, 1x1 project without
    activation, plus the input where stride is 1 and the width kept."""

    def __init__(self, params: dict, stats: dict, stride: int = 1, expand: int = 6,
                 use_se: bool = False, device="cpu", dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        names = iter(f"ConvBN_{i}" for i in range(3))
        layers = []
        if expand != 1:
            n = next(names)
            layers.append(ConvBN(params[n], stats[n], device=device, dtype=dtype))
        n = next(names)
        mid = params[n]["Conv_0"]["kernel"].shape[-1]
        layers.append(ConvBN(params[n], stats[n], stride=stride, groups=mid, device=device,
                             dtype=dtype))
        self.expand_dw = torch.nn.ModuleList(layers)
        self.se = SEBlock(params["SEBlock_0"], device, dtype) if use_se else None
        n = next(names)
        self.project = ConvBN(params[n], stats[n], act=False, device=device, dtype=dtype)
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

    def export(self) -> tuple[dict, dict]:
        layers = [*self.expand_dw, self.project]
        parts = {f"ConvBN_{i}": layer for i, layer in enumerate(layers)}
        if self.se is not None:
            parts["SEBlock_0"] = self.se
        return export_layers(parts)


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

    def __init__(self, params: dict, stats: dict, device="cpu",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.stem = ConvBN(params["ConvBN_0"], stats["ConvBN_0"], stride=2, device=device,
                           dtype=dtype)
        self.blocks = torch.nn.ModuleList(
            InvertedResidual(params[f"InvertedResidual_{i}"], stats[f"InvertedResidual_{i}"],
                             stride=st, expand=ex, use_se=se, device=device, dtype=dtype)
            for i, (_, st, ex, se) in enumerate(ENCODER_BLOCKS))

    def forward(self, x: torch.Tensor):
        x = self.stem(x)
        feats = []
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i in ENCODER_TAPS:
                feats.append(x)
        return tuple(feats)

    def export(self) -> tuple[dict, dict]:
        return export_layers({"ConvBN_0": self.stem, **{
            f"InvertedResidual_{i}": b for i, b in enumerate(self.blocks)}})


class EASPP(torch.nn.Module):
    """Efficient ASPP: a depthwise 3x3 ConvBN (no activation) at each of
    :data:`EASPP_RATES`, concatenated, a 1x1 ConvBN, then SE."""

    def __init__(self, params: dict, stats: dict, device="cpu",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        n = len(EASPP_RATES)
        c = params["ConvBN_0"]["Conv_0"]["kernel"].shape[-1]
        self.branches = torch.nn.ModuleList(
            ConvBN(params[f"ConvBN_{i}"], stats[f"ConvBN_{i}"], act=False, groups=c,
                   dilation=r, device=device, dtype=dtype) for i, r in enumerate(EASPP_RATES))
        self.fuse = ConvBN(params[f"ConvBN_{n}"], stats[f"ConvBN_{n}"], device=device,
                           dtype=dtype)
        self.se = SEBlock(params["SEBlock_0"], device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.cat([b(x) for b in self.branches], dim=1)
        return self.se(self.fuse(h))

    def export(self) -> tuple[dict, dict]:
        return export_layers({**{f"ConvBN_{i}": b for i, b in enumerate(self.branches)},
                              f"ConvBN_{len(self.branches)}": self.fuse, "SEBlock_0": self.se})


def copy_parameters(model: torch.nn.Module, fresh: torch.nn.Module) -> None:
    """Copy ``fresh``'s parameters into ``model``'s in place (``load_tree``
    of the models: ``fresh`` is the same model built from the tree on the
    CPU); their names and shapes must agree."""
    with torch.no_grad():
        for (name, p), (fname, q) in zip(model.named_parameters(), fresh.named_parameters(),
                                          strict=True):
            if name != fname or p.shape != q.shape:
                raise ValueError(f"tree does not fit: {fname} {tuple(q.shape)} for "
                                 f"{name} {tuple(p.shape)}")
            p.copy_(q)


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
