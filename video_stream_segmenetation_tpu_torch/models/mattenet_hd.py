"""MatteNetHD float parameter trees, the pico, nano, femto, micro, light and
full plans (port of the parameter layout of ``models/mattenet_hd.py::
MatteNetHD._plan_d`` with ``decoder='pico'``, ``'nano'``, ``'femto'`` and
``'micro'``, ``_plan_c`` (``'light'``) and ``_plan_b`` (``'full'``)), and of
plan A (a stem stride under 8, ``MatteNetHD()``'s defaults), with one head
channel a class (``num_classes``); and the float :class:`MatteNetHD` at
every plan, with one class or K, over natural or packed frames: the
``_plan_d`` branch is what the trainer (train/) fits, plan A what the
``fast`` preset serves, and every plan what ``matting_precision='bf16'``
serves on either layout.

The int8 presets serve the int8 graph (models/quantized.py), so they need
the float tree only as the quantizer's input: a nested dict of numpy arrays
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
  plan A (stem stride < 8, mattenet_hd.py:115-186): ConvBN_0 stem 32 |
    ConvBN_1 d1dn 64 | _Block_0 d1b (no SE) | ConvBN_2 d2dn 128 | _Block_1
    d2b | ConvBN_3 d3dn 256 | _Block_2 d3b | ConvBN_4 ctx2 | ConvBN_5 ctx4 |
    SEBlock_0 | Conv_0 sem | ConvBN_6 u2 (3x3 over the concat) | ConvBN_7 u1 |
    Conv_1 det | ConvBN_8 u0 | Conv_2 alpha (3x3)
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
    PatchifiedConv,
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
# plan A's widths at width 1: stem, /2, /4, /8 of the stem grid
PLAN_A_WIDTHS = (32, 64, 128, 256)


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


def _plan_a_spec(stem_stride: int, k: int) -> dict:
    """Plan A (the reference's ``__call__`` below stem stride 8), in its
    module order."""
    c0, c1, c2, c3 = PLAN_A_WIDTHS
    ss = stem_stride
    return {
        "ConvBN_0": ("convbn", (ss, ss, 3, c0)),
        "ConvBN_1": ("convbn", (3, 3, c0, c1)), "_Block_0": _block(c1, se=False),
        "ConvBN_2": ("convbn", (3, 3, c1, c2)), "_Block_1": _block(c2),
        "ConvBN_3": ("convbn", (3, 3, c2, c3)), "_Block_2": _block(c3),
        "ConvBN_4": ("convbn", (3, 3, c3, c3)),  # ctx, dilation 2
        "ConvBN_5": ("convbn", (3, 3, c3, c3)),  # ctx, dilation 4, no act
        "SEBlock_0": _se(c3),
        "Conv_0": ("conv", (1, 1, c3, k)),  # sem
        "ConvBN_6": ("convbn", (3, 3, c3 + c2, c2)),  # u2 over the concat
        "ConvBN_7": ("convbn", (3, 3, c2 + c1, c1)),  # u1
        "Conv_1": ("conv", (1, 1, c1, k)),  # det
        "ConvBN_8": ("convbn", (3, 3, c1 + c0, c0)),  # u0
        "Conv_2": ("conv", (3, 3, c0, k)),  # alpha
    }


def param_spec(decoder: str, stem_stride: int, num_classes: int = 1) -> dict:
    """The float tree's layout (backbones.py::seeded_tree leaves), in the
    order its kernels are drawn: convs in module order, heads (K =
    ``num_classes`` channels each), then the context SE; plan A (a stem
    stride under 8, whatever the decoder, as the reference) in its module
    order."""
    if stem_stride < 8:
        return _plan_a_spec(stem_stride, num_classes)
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
    'micro', 'light' or 'full'; plan A below stem stride 8) with
    ``num_classes`` head channels: LeCun-normal
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
    """Role -> flax module name of the ``_plan_d`` branch, in the
    reference's module order."""
    if decoder == "micro":
        names = ("ConvBN_0", "ConvBN_1", "_Block_0", "ConvBN_2", "_Block_1", "ConvBN_3",
                 "ConvBN_4", "ConvBN_5")
    else:
        names = tuple(f"ConvBN_{i}" for i in range(8))
    roles = dict(zip(("stem", "d2dn", "d2b", "d3dn", "d3b", "ctx", "u2red", "u1red"), names))
    roles.update(ctxse="SEBlock_0", sem="Conv_0", det="Conv_1", alpha="Conv_2")
    return roles


_HEADS = {"sem": "Conv_0", "det": "Conv_1", "alpha": "Conv_2"}
# plan A's roles (mattenet_hd.py:126-169), in module order
PLAN_A_ROLES = {"stem": "ConvBN_0", "d1dn": "ConvBN_1", "d1b": "_Block_0",
                "d2dn": "ConvBN_2", "d2b": "_Block_1", "d3dn": "ConvBN_3", "d3b": "_Block_2",
                "ctx2": "ConvBN_4", "ctx4": "ConvBN_5", "ctxse": "SEBlock_0", "sem": "Conv_0",
                "u2": "ConvBN_6", "u1": "ConvBN_7", "det": "Conv_1", "u0": "ConvBN_8",
                "alpha": "Conv_2"}
# plan B's ('full', mattenet_hd.py:355-387) and plan C's ('light', :282-328)
PLAN_B_ROLES = {"stem": "ConvBN_0", "b1": "_Block_0", "d2dn": "ConvBN_1", "d2b": "_Block_1",
                "d3dn": "ConvBN_2", "d3b": "_Block_2", "ctx2": "ConvBN_3", "ctx4": "ConvBN_4",
                "ctxse": "SEBlock_0", "u2": "ConvBN_5", "u1": "ConvBN_6", **_HEADS}
PLAN_C_ROLES = {"stem": "ConvBN_0", "b1": "ConvBN_1", "d2dn": "ConvBN_2", "d2b": "_Block_0",
                "d3dn": "ConvBN_3", "d3b": "_Block_1", "ctx2": "ConvBN_4", "ctx4": "ConvBN_5",
                "ctxse": "SEBlock_0", "u2red": "ConvBN_6", "u2": "ConvBN_7",
                "u1red": "ConvBN_8", **_HEADS}


def plan_roles(decoder: str, stem_stride: int) -> dict:
    """Role -> flax module name of the plan the reference's ``__call__``
    picks (mattenet_hd.py:108-114): plan A below stem stride 8 (whatever
    the decoder), else plan B ('full'), C ('light') or the ``_plan_d``
    branch."""
    if stem_stride < 8:
        return PLAN_A_ROLES
    return {"full": PLAN_B_ROLES, "light": PLAN_C_ROLES}.get(decoder) or _roles(decoder)


class MatteNetHD(torch.nn.Module):
    """The float MatteNetHD at every plan, with one class or K (port of
    ``models/mattenet_hd.py::MatteNetHD``): plan A (``:115-186``; stem
    stride under 8, whatever the decoder, its head upsampled x2: the
    ``fast`` preset's net, the registry's ``mattenet_hd``), plan B
    (``'full'``, ``_plan_b`` ``:355-412``), plan C (``'light'``,
    ``_plan_c`` ``:282-353``) or the ``_plan_d`` branch (``'pico'``,
    ``'nano'``, ``'femto'``, ``'micro'``, ``:188-280``; the branch the
    trainer, train/, fits), by the stem stride and the decoder.

    Input: natural ``[B, H, W, 3]`` frames (u8, divided by 255 in the
    compute dtype as the reference does, or f32 in [0, 1]), or the packed
    frames ``[B, H/ss, W/ss, ss*ss*3]`` (u8, or float in [0, 1]), whose
    stem is one product (backbones.py::PatchifiedConv over the stem's own
    kernel: one tree serves either input).  Output ``{"alpha", "semantic",
    "detail"}`` f32 as the reference returns them: with one class ``alpha
    [B, uf*H/ss, uf*W/ss]`` (sigmoid), ``semantic`` (sigmoid) at the
    context's grid (plans B, C, D: ``H/4ss``; plan A: ``H/8ss``) and the
    ``detail`` logits; with K classes (``num_classes``, read from the
    tree) each with a K axis last, ``alpha`` and ``semantic`` the softmax
    over it.  The head's logits are upsampled in f32 one class plane at a
    time by the half-pixel matrix resize (ops/resize.py::
    resize_bilinear_mxu without the bf16 pass: the reference's
    ``precision=None``, HIGHEST), x2 at plan A and x``head_upsample``
    otherwise.  Layers compute in ``dtype`` (bf16, the reference's
    default, or f32).

    ``params``: a flax-named float tree ``{"params", "batch_stats"}``
    (numpy leaves, e.g. :func:`init_params`, bridge.py::load_export); None
    makes one with :func:`init_params` from seed 0 with ``num_classes``
    classes.  :meth:`tree` gives the module's tree back in the same form,
    :meth:`load_tree` loads one."""

    def __init__(self, stem_stride: int = 10, head_upsample: int = 4, decoder: str = "pico",
                 dtype: torch.dtype = torch.bfloat16, params: dict | None = None,
                 device="cuda", num_classes: int = 1):
        super().__init__()
        self.plan_a = stem_stride < 8
        if self.plan_a and head_upsample != 2:
            raise ValueError(f"stem_stride {stem_stride}: plan A is upsampled x2 (its head "
                             f"upsample is fixed), so head_upsample 2, got {head_upsample}")
        if decoder not in WIDTHS:
            raise ValueError(f"decoder {decoder!r}: the float MatteNetHD has {sorted(WIDTHS)}")
        self.stem_stride, self.head_upsample = stem_stride, head_upsample
        self.decoder, self.dtype = decoder, dtype
        tree = init_params(decoder, 0, stem_stride, num_classes) if params is None else params
        p, st = tree["params"], tree["batch_stats"]
        self.num_classes = int(np.shape(p["Conv_2"]["kernel"])[-1])
        self.roles = plan_roles(decoder, stem_stride)
        strides = {"stem": stem_stride, "d1dn": 2, "d2dn": 2, "d3dn": 2}
        dilations = {"ctx2": 2, "ctx4": 4, "ctx": 3}
        no_act = ("ctx4", "ctx")
        layers = {}
        for role, name in self.roles.items():
            if name.startswith("_Block"):
                layers[name] = _Block(p[name], st[name], device, dtype)
            elif name.startswith("ConvBN"):
                layers[name] = ConvBN(p[name], st[name], stride=strides.get(role, 1),
                                      act=role not in no_act, device=device,
                                      dilation=dilations.get(role, 1), dtype=dtype)
            elif name.startswith("SEBlock"):
                layers[name] = SEBlock(p[name], device, dtype)
            else:
                layers[name] = Conv(p[name], device, dtype)
        self.layers = torch.nn.ModuleDict(layers)
        self.patch_stem = PatchifiedConv(self.layers[self.roles["stem"]])
        self.requires_grad_(True)  # trainable, unlike the serving models' layers

    def _run(self, role: str, x: torch.Tensor) -> torch.Tensor:
        return self.layers[self.roles[role]](x)

    def _up(self, x: torch.Tensor, skip: torch.Tensor, role: str) -> torch.Tensor:
        """Nearest x2, cropped to the skip, concatenated with it, ``role``."""
        x = nearest_x2(x)[:, :, : skip.shape[2], : skip.shape[3]]
        return self._run(role, torch.cat([x, skip], dim=1))

    def _context(self, d3: torch.Tensor) -> torch.Tensor:
        """The 2/4 dilation context pair, + d3, relu6, SE (plans A, B, C)."""
        ctx = self._run("ctx4", self._run("ctx2", d3))
        return self._run("ctxse", F.relu6(ctx + d3))

    def _plan_a(self, x0: torch.Tensor):
        """Plan A after the stem: three stride-2 downs, each with its block
        (SE at /4 and /8), the 2/4 dilation context with SE, the sem head,
        the three-level decoder over the concats, the 3x3 alpha head."""
        d1 = self._run("d1b", self._run("d1dn", x0))
        d2 = self._run("d2b", self._run("d2dn", d1))
        d3 = self._run("d3b", self._run("d3dn", d2))
        ctx = self._context(d3)
        u1 = self._up(self._up(ctx, d2, "u2"), d1, "u1")
        u0 = self._up(u1, x0, "u0")
        return ctx, u1, self._run("alpha", u0)

    def _plan_b(self, x0: torch.Tensor):
        """Plan B: the b1 block (no SE), two stride-2 downs with SE blocks,
        the context, u2 and u1 as 3x3 convs over the concats."""
        b1 = self._run("b1", x0)
        d2 = self._run("d2b", self._run("d2dn", b1))
        d3 = self._run("d3b", self._run("d3dn", d2))
        ctx = self._context(d3)
        u1 = self._up(self._up(ctx, d2, "u2"), b1, "u1")
        return ctx, u1, self._run("alpha", u1)

    def _plan_c(self, x0: torch.Tensor):
        """Plan C: one 3x3 at b1, plan B's deep stages and context, the 1x1
        u2red over the concat and one 3x3 at /2, the 1x1 u1red."""
        b1 = self._run("b1", x0)
        d2 = self._run("d2b", self._run("d2dn", b1))
        d3 = self._run("d3b", self._run("d3dn", d2))
        ctx = self._context(d3)
        u2 = self._run("u2", self._up(ctx, d2, "u2red"))
        u1 = self._up(u2, b1, "u1red")
        return ctx, u1, self._run("alpha", u1)

    def _plan_d(self, x0: torch.Tensor):
        d2 = self._run("d2b", self._run("d2dn", x0))
        d3 = self._run("d3b", self._run("d3dn", d2))
        ctx = self._run("ctxse", F.relu6(self._run("ctx", d3) + d3))
        u1 = self._up(self._up(ctx, d2, "u2red"), x0, "u1red")
        return ctx, u1, self._run("alpha", u1)

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """The stem's output x0 (NCHW, compute dtype) of natural or packed
        frames (the packed product, then the same BatchNorm and relu6)."""
        ss = self.stem_stride
        if x.shape[-1] == 3 * ss * ss:
            return self.layers[self.roles["stem"]].epilogue(self.patch_stem(x))
        dt = self.dtype
        x = (x.to(dt) / 255.0 if x.dtype == torch.uint8 else x.to(dt)).permute(0, 3, 1, 2)
        return self._run("stem", x)

    def forward(self, x: torch.Tensor) -> dict:
        return self.from_stem(self.stem(x))

    def from_stem(self, x0: torch.Tensor) -> dict:
        """Everything after the stem: the plan's layers, the heads, the
        upsample and the sigmoid or softmax (:meth:`forward`'s output)."""
        if self.plan_a:
            plan = self._plan_a
        else:
            plan = {"full": self._plan_b, "light": self._plan_c}.get(self.decoder, self._plan_d)
        ctx, u1, logit = plan(x0)
        sem = self._run("sem", ctx).to(torch.float32)
        det = self._run("det", u1).to(torch.float32)
        logit = logit.to(torch.float32)
        uf = 2 if self.plan_a else self.head_upsample
        logit = resize_bilinear_mxu(logit, (uf * logit.shape[2], uf * logit.shape[3]),
                                    method="half_pixel", channel_last=False)
        if self.num_classes == 1:
            return {"alpha": torch.sigmoid(logit)[:, 0], "semantic": torch.sigmoid(sem)[:, 0],
                    "detail": det[:, 0]}
        last = (0, 2, 3, 1)
        return {"alpha": torch.softmax(logit, dim=1).permute(*last).contiguous(),
                "semantic": torch.softmax(sem, dim=1).permute(*last).contiguous(),
                "detail": det.permute(*last).contiguous()}

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
        if fresh.num_classes != self.num_classes:
            raise ValueError(f"tree does not fit: {fresh.num_classes} classes for "
                             f"{self.num_classes}")
        with torch.no_grad():
            for (name, p), (fname, q) in zip(self.named_parameters(), fresh.named_parameters()):
                if name != fname or p.shape != q.shape:
                    raise ValueError(f"tree does not fit: {fname} {tuple(q.shape)} for "
                                     f"{name} {tuple(p.shape)}")
                p.copy_(q)
