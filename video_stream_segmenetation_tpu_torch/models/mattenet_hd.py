"""MatteNetHD float parameter trees, the pico, nano, micro, light and full
plans (port of the parameter layout of ``models/mattenet_hd.py::
MatteNetHD._plan_d`` with ``decoder='pico'``, ``'nano'`` and ``'micro'``,
``_plan_c`` (``'light'``) and ``_plan_b`` (``'full'``)), with one head
channel a class (``num_classes``).

Serving runs the int8 graph (models/quantized.py), so the port needs the
float tree only as the quantizer's input: a nested dict of numpy arrays
with the flax module names, ``{"params": ..., "batch_stats": ...}``.
:func:`init_params` makes one from a seed with the same tree and shapes as
the flax ``init``.  Module orders (mattenet_hd.py:195-240):

  pico (plan F), nano (plan E, the same at deeper widths):
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

from video_stream_segmenetation_tpu_torch.models.backbones import seeded_tree

# stem c0, /2 level c2, /4 level c3 (the reference's NANO_WIDTHS,
# mattenet_hd.py:39-43, and plans D, C and B at width 1)
WIDTHS = {"pico": (128, 128, 192), "nano": (128, 192, 256), "micro": (128, 192, 256),
          "light": (128, 192, 256), "full": (128, 192, 256)}
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
    """Seeded float tree of the ``decoder`` plan ('pico', 'nano', 'micro',
    'light' or 'full') with ``num_classes`` head channels: LeCun-normal
    kernels (truncated at 2 sigma), zero biases, BatchNorm at unit
    statistics -- flax's initializers, drawn from
    ``numpy.random.default_rng(seed)``."""
    if decoder not in WIDTHS:
        raise ValueError(f"decoder {decoder!r}: the port has {sorted(WIDTHS)}")
    return seeded_tree(np.random.default_rng(seed),
                       param_spec(decoder, stem_stride, num_classes))


def init_pico_params(seed: int, stem_stride: int = 10) -> dict:
    return init_params("pico", seed, stem_stride)
