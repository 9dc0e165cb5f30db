"""MatteNetHD float parameter trees, the pico, nano, femto, micro, light and
full plans (port of the parameter layout of ``models/mattenet_hd.py::
MatteNetHD._plan_d`` with ``decoder='pico'``, ``'nano'``, ``'femto'`` and
``'micro'``, ``_plan_c`` (``'light'``) and ``_plan_b`` (``'full'``)), with one
head channel a class (``num_classes``), and the float :class:`MatteNetHD`
of the ``_plan_d`` branch, which the trainer (train/) fits.

Serving runs the int8 graph (models/quantized.py), so serving needs the
float tree only as the quantizer's input: a nested dict of numpy arrays
with the flax module names, ``{"params": ..., "batch_stats": ...}``.
:func:`init_params` makes one from a seed with the same tree and shapes as
the flax ``init``; :class:`MatteNetHD` loads one and exports one.  Module
orders (mattenet_hd.py:195-240):

  pico (plan F), nano (plan E), femto (plan G), the same structure at
                  other deep widths:
                  ConvBN_0 stem | ConvBN_1 d2dn | ConvBN_2 d2b |
    ConvBN_3 d3dn | ConvBN_4 d3b | ConvBN_5 ctx | SEBlock_0 |
    ConvBN_6 u2red(1x1) | ConvBN_7 u1red(1x1) | Conv_0 sem | Conv_1 det |
    Conv_2 alpha
  micro (plan D): ConvBN_0 stem | ConvBN_1 d2dn | _Block_0 d2b |
    ConvBN_2 d3dn | _Block_1 d3b | ConvBN_3 ctx | SEBlock_0 |
    ConvBN_4 u2red(1x1) | ConvBN_5 u1red(1x1) | Conv_0..2 heads
  light (plan C, mattenet_hd.py:282-292): ConvBN_0 stem | ConvBN_1 b1 |
    ConvBN_2 d2dn | _Block_0 d2b | ConvBN_3 d3dn | _Block_1 d3b |
    ConvBN_4 ctx2 | ConvBN_5 ctx4 | SEBlock_0 | ConvBN_6 u2red(1x1) |
    ConvBN_7 u2(3x3) | ConvBN_8 u1red(1x1) | Conv_0..2 heads
  full (plan B, mattenet_hd.py:355-375): ConvBN_0 stem | _Block_0 b1 (no
    SE) | ConvBN_1 d2dn | _Block_1 d2b | ConvBN_2 d3dn | _Block_2 d3b |
    ConvBN_3 ctx2 | ConvBN_4 ctx4 | SEBlock_0 | ConvBN_5 u2(3x3 over the
    concat) | ConvBN_6 u1(3x3 over the concat) | Conv_0..2 heads
  (_Block: ConvBN_0, ConvBN_1 (no act), SEBlock_0 where it has SE,
  residual, relu6)
"""

from __future__ import annotations

import numpy as np

import torch
import torch.nn.functional as F

from video_stream_segmenetation_tpu_torch.models.backbones import (
    Conv,
    ConvBN,
    SEBlock,
    export_layers,
    nearest_x2,
    seeded_tree,
)
from video_stream_segmenetation_tpu_torch.ops.resize import resize_bilinear_mxu

# stem c0, /2 level c2, /4 level c3 (the reference's NANO_WIDTHS,
# mattenet_hd.py:39-43, and plans D, C and B at width 1)
WIDTHS = {"pico": (128, 128, 192), "nano": (128, 192, 256), "femto": (128, 128, 128),
          "micro": (128, 192, 256), "light": (128, 192, 256), "full": (128, 192, 256)}
# the decoders of the reference's _plan_d branch (mattenet_hd.py:188-280)
PLAN_D = ("pico", "nano", "femto", "micro")
SE_REDUCE = 4


def _se(c: int) -> dict:
    r = max(8, c // SE_REDUCE)
    return {"Dense_0": ("dense", (c, r)), "Dense_1": ("dense", (r, c))}


def _block(c: int, se: bool = True) -> dict:
    blk = {"ConvBN_0": ("convbn", (3, 3, c, c)), "ConvBN_1": ("convbn", (3, 3, c, c))}
    if se:
        blk["SEBlock_0"] = _se(c)
    return blk


def _heads(spec: dict, c3: int, c0: int, k: int) -> dict:
    spec["Conv_0"] = ("conv", (1, 1, c3, k))  # sem
    spec["Conv_1"] = ("conv", (1, 1, c0, k))  # det
    spec["Conv_2"] = ("conv", (3, 3, c0, k))  # alpha
    spec["SEBlock_0"] = _se(c3)
    return spec


def _plan_bc_spec(decoder: str, stem_stride: int, k: int) -> dict:
    """Plans C ('light') and B ('full'): the deep stages of _plan_c and
    _plan_b, a 2/4 dilation context pair, their decoders."""
    c0, c2, c3 = WIDTHS[decoder]
    ss = stem_stride
    spec = {"ConvBN_0": ("convbn", (ss, ss, 3, c0))}
    if decoder == "light":
        spec["ConvBN_1"] = ("convbn", (3, 3, c0, c0))  # b1, one conv
        n, blocks = 2, ("_Block_0", "_Block_1")
    else:
        spec["_Block_0"] = _block(c0, se=False)  # b1
        n, blocks = 1, ("_Block_1", "_Block_2")
    spec[f"ConvBN_{n}"] = ("convbn", (3, 3, c0, c2))  # d2dn
    spec[blocks[0]] = _block(c2)
    spec[f"ConvBN_{n + 1}"] = ("convbn", (3, 3, c2, c3))  # d3dn
    spec[blocks[1]] = _block(c3)
    spec[f"ConvBN_{n + 2}"] = ("convbn", (3, 3, c3, c3))  # ctx2, dilation 2
    spec[f"ConvBN_{n + 3}"] = ("convbn", (3, 3, c3, c3))  # ctx4, dilation 4, no act
    if decoder == "light":
        spec["ConvBN_6"] = ("convbn", (1, 1, c3 + c2, c2))  # u2red
        spec["ConvBN_7"] = ("convbn", (3, 3, c2, c2))  # u2
        spec["ConvBN_8"] = ("convbn", (1, 1, c2 + c0, c0))  # u1red
    else:
        spec["ConvBN_5"] = ("convbn", (3, 3, c3 + c2, c2))  # u2 over the concat
        spec["ConvBN_6"] = ("convbn", (3, 3, c2 + c0, c0))  # u1 over the concat
    return _heads(spec, c3, c0, k)


def param_spec(decoder: str, stem_stride: int, num_classes: int = 1) -> dict:
    """The float tree's layout (backbones.py::seeded_tree leaves), in the
    order its kernels are drawn: convs in module order, heads (K =
    ``num_classes`` channels each), then the context SE."""
    if decoder in ("light", "full"):
        return _plan_bc_spec(decoder, stem_stride, num_classes)
    c0, c2, c3 = WIDTHS[decoder]
    ss = stem_stride
    spec = {"ConvBN_0": ("convbn", (ss, ss, 3, c0)),
            "ConvBN_1": ("convbn", (3, 3, c0, c2))}
    if decoder == "micro":
        spec["_Block_0"] = _block(c2)
        spec["ConvBN_2"] = ("convbn", (3, 3, c2, c3))
        spec["_Block_1"] = _block(c3)
        n = 3
    else:
        spec["ConvBN_2"] = ("convbn", (3, 3, c2, c2))
        spec["ConvBN_3"] = ("convbn", (3, 3, c2, c3))
        spec["ConvBN_4"] = ("convbn", (3, 3, c3, c3))
        n = 5
    spec[f"ConvBN_{n}"] = ("convbn", (3, 3, c3, c3))  # ctx, dilation 3
    spec[f"ConvBN_{n + 1}"] = ("convbn", (1, 1, c3 + c2, c2))  # u2red
    spec[f"ConvBN_{n + 2}"] = ("convbn", (1, 1, c2 + c0, c0))  # u1red
    return _heads(spec, c3, c0, num_classes)


def init_params(decoder: str, seed: int, stem_stride: int = 10,
                num_classes: int = 1) -> dict:
    """Seeded float tree of the ``decoder`` plan ('pico', 'nano', 'femto',
    'micro', 'light' or 'full') with ``num_classes`` head channels: LeCun-normal
    kernels (truncated at 2 sigma), zero biases, BatchNorm at unit
    statistics -- flax's initializers, drawn from
    ``numpy.random.default_rng(seed)``."""
    if decoder not in WIDTHS:
        raise ValueError(f"decoder {decoder!r}: the port has {sorted(WIDTHS)}")
    return seeded_tree(np.random.default_rng(seed),
                       param_spec(decoder, stem_stride, num_classes))


def init_pico_params(seed: int, stem_stride: int = 10) -> dict:
    return init_params("pico", seed, stem_stride)


class _Block(torch.nn.Module):
    """The reference's residual ``_Block``: 3x3 ConvBN, 3x3 ConvBN without
    activation, SE where it has one, plus the input at equal width, relu6."""

    def __init__(self, params: dict, stats: dict, device, dtype):
        super().__init__()
        self.c0 = ConvBN(params["ConvBN_0"], stats["ConvBN_0"], device=device, dtype=dtype)
        self.c1 = ConvBN(params["ConvBN_1"], stats["ConvBN_1"], act=False, device=device,
                         dtype=dtype)
        self.se = SEBlock(params["SEBlock_0"], device, dtype) if "SEBlock_0" in params else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.c1(self.c0(x))
        if self.se is not None:
            h = self.se(h)
        if h.shape[1] == x.shape[1]:
            h = h + x
        return F.relu6(h)

    def export(self) -> tuple[dict, dict]:
        parts = {"ConvBN_0": self.c0, "ConvBN_1": self.c1}
        if self.se is not None:
            parts["SEBlock_0"] = self.se
        return export_layers(parts)


def _roles(decoder: str) -> dict:
    """Role -> flax module name, in the reference's module order."""
    if decoder == "micro":
        names = ("ConvBN_0", "ConvBN_1", "_Block_0", "ConvBN_2", "_Block_1", "ConvBN_3",
                 "ConvBN_4", "ConvBN_5")
    else:
        names = tuple(f"ConvBN_{i}" for i in range(8))
    roles = dict(zip(("stem", "d2dn", "d2b", "d3dn", "d3b", "ctx", "u2red", "u1red"), names))
    roles.update(ctxse="SEBlock_0", sem="Conv_0", det="Conv_1", alpha="Conv_2")
    return roles


class MatteNetHD(torch.nn.Module):
    """The float MatteNetHD of the reference's ``_plan_d`` branch
    (``mattenet_hd.py:188-280``; decoder 'pico', 'nano', 'femto' or
    'micro'), one class.  Natural ``[B, H, W, 3]`` frames (f32 in [0, 1],
    or u8) -> ``{"alpha": [B, uf*H/ss, uf*W/ss], "semantic": [B, H/4ss,
    W/4ss], "detail": [B, H/ss, W/ss]}`` f32, as the reference returns
    them (the K-class heads are not trained in the port yet).
    Layers compute in ``dtype`` (bf16, the reference's default, or f32); the
    alpha head's logits are upsampled in f32 by the half-pixel matrix
    resize (ops/resize.py::resize_bilinear_mxu).

    ``params``: a flax-named float tree ``{"params", "batch_stats"}`` (numpy
    leaves, e.g. :func:`init_params`, bridge.py::load_export); None makes
    one with :func:`init_params` from seed 0.  :meth:`tree` gives the
    module's tree back in the same form, :meth:`load_tree` loads one."""

    def __init__(self, stem_stride: int = 10, head_upsample: int = 4, decoder: str = "pico",
                 dtype: torch.dtype = torch.bfloat16, params: dict | None = None,
                 device="cuda"):
        super().__init__()
        if decoder not in PLAN_D:
            raise ValueError(f"decoder {decoder!r}: the float MatteNetHD has {PLAN_D}")
        if stem_stride < 8:
            raise ValueError(f"stem_stride {stem_stride}: the _plan_d branch needs >= 8")
        self.stem_stride, self.head_upsample = stem_stride, head_upsample
        self.decoder, self.dtype = decoder, dtype
        tree = init_params(decoder, 0, stem_stride) if params is None else params
        p, st = tree["params"], tree["batch_stats"]
        self.roles = _roles(decoder)
        strides = {"stem": stem_stride, "d2dn": 2, "d3dn": 2}
        layers = {}
        for role, name in self.roles.items():
            if name.startswith("_Block"):
                layers[name] = _Block(p[name], st[name], device, dtype)
            elif name.startswith("ConvBN"):
                layers[name] = ConvBN(p[name], st[name], stride=strides.get(role, 1),
                                      act=role != "ctx", device=device,
                                      dilation=3 if role == "ctx" else 1, dtype=dtype)
            elif name.startswith("SEBlock"):
                layers[name] = SEBlock(p[name], device, dtype)
            else:
                layers[name] = Conv(p[name], device, dtype)
        self.layers = torch.nn.ModuleDict(layers)
        self.requires_grad_(True)  # trainable, unlike the serving models' layers

    def _run(self, role: str, x: torch.Tensor) -> torch.Tensor:
        return self.layers[self.roles[role]](x)

    def forward(self, x: torch.Tensor) -> dict:
        dt = self.dtype
        x = (x.to(dt) / 255.0 if x.dtype == torch.uint8 else x.to(dt)).permute(0, 3, 1, 2)
        x0 = self._run("stem", x)
        d2 = self._run("d2b", self._run("d2dn", x0))
        d3 = self._run("d3b", self._run("d3dn", d2))
        ctx = self._run("ctxse", F.relu6(self._run("ctx", d3) + d3))
        u2 = nearest_x2(ctx)[:, :, : d2.shape[2], : d2.shape[3]]
        u2 = self._run("u2red", torch.cat([u2, d2], dim=1))
        u1 = nearest_x2(u2)[:, :, : x0.shape[2], : x0.shape[3]]
        u1 = self._run("u1red", torch.cat([u1, x0], dim=1))
        sem = self._run("sem", ctx).to(torch.float32)
        det = self._run("det", u1).to(torch.float32)
        logit = self._run("alpha", u1).to(torch.float32)
        uf = self.head_upsample
        logit = resize_bilinear_mxu(logit, (uf * logit.shape[2], uf * logit.shape[3]),
                                    method="half_pixel", channel_last=False)
        return {"alpha": torch.sigmoid(logit)[:, 0], "semantic": torch.sigmoid(sem)[:, 0],
                "detail": det[:, 0]}

    def tree(self) -> dict:
        """The module's weights as a flax-named numpy tree ``{"params",
        "batch_stats"}`` (the form init_params, bridge.params_from_jax and
        bridge.save_export take)."""
        params, stats = export_layers(self.layers)
        return {"params": params, "batch_stats": stats}

    def load_tree(self, tree: dict) -> None:
        """Copy a flax-named float tree into the module's parameters, in
        place (its layout must be this module's plan)."""
        fresh = MatteNetHD(self.stem_stride, self.head_upsample, self.decoder, self.dtype,
                           params=tree, device="cpu")
        with torch.no_grad():
            for (name, p), (fname, q) in zip(self.named_parameters(), fresh.named_parameters()):
                if name != fname or p.shape != q.shape:
                    raise ValueError(f"tree does not fit: {fname} {tuple(q.shape)} for "
                                     f"{name} {tuple(p.shape)}")
                p.copy_(q)
