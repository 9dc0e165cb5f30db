"""MatteNetHD float parameter trees, the pico, nano and micro plans (port of
the parameter layout of ``models/mattenet_hd.py::MatteNetHD._plan_d`` with
``decoder='pico'``, ``'nano'`` and ``'micro'``), with one head channel a
class (``num_classes``).

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
  (_Block: ConvBN_0, ConvBN_1 (no act), SEBlock_0, residual, relu6)
"""

from __future__ import annotations

import numpy as np

from video_stream_segmenetation_tpu_torch.models.backbones import seeded_tree

# stem c0, /2 level c2, /4 level c3 (the reference's NANO_WIDTHS,
# mattenet_hd.py:39-43, and plan D)
WIDTHS = {"pico": (128, 128, 192), "nano": (128, 192, 256), "micro": (128, 192, 256)}
SE_REDUCE = 4


def _se(c: int) -> dict:
    r = max(8, c // SE_REDUCE)
    return {"Dense_0": ("dense", (c, r)), "Dense_1": ("dense", (r, c))}


def _block(c: int) -> dict:
    return {"ConvBN_0": ("convbn", (3, 3, c, c)), "ConvBN_1": ("convbn", (3, 3, c, c)),
            "SEBlock_0": _se(c)}


def param_spec(decoder: str, stem_stride: int, num_classes: int = 1) -> dict:
    """The float tree's layout (backbones.py::seeded_tree leaves), in the
    order its kernels are drawn: convs in module order, heads (K =
    ``num_classes`` channels each), then the context SE."""
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
    k = num_classes
    spec["Conv_0"] = ("conv", (1, 1, c3, k))  # sem
    spec["Conv_1"] = ("conv", (1, 1, c0, k))  # det
    spec["Conv_2"] = ("conv", (3, 3, c0, k))  # alpha
    spec["SEBlock_0"] = _se(c3)
    return spec


def init_params(decoder: str, seed: int, stem_stride: int = 10,
                num_classes: int = 1) -> dict:
    """Seeded float tree of the ``decoder`` plan ('pico', 'nano' or 'micro')
    with ``num_classes`` head channels:
    LeCun-normal kernels (truncated at 2 sigma), zero biases, BatchNorm at
    unit statistics -- flax's initializers, drawn from
    ``numpy.random.default_rng(seed)``."""
    if decoder not in WIDTHS:
        raise ValueError(f"decoder {decoder!r}: the port has {sorted(WIDTHS)}")
    return seeded_tree(np.random.default_rng(seed),
                       param_spec(decoder, stem_stride, num_classes))


def init_pico_params(seed: int, stem_stride: int = 10) -> dict:
    return init_params("pico", seed, stem_stride)
