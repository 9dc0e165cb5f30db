"""MatteNetHD float parameter tree, pico plan (port of the parameter layout
of ``models/mattenet_hd.py::MatteNetHD._plan_d`` with ``decoder='pico'``).

Serving runs the int8 graph (models/quantized.py), so the port needs the
float tree only as the quantizer's input: a nested dict of numpy arrays
with the flax module names, ``{"params": ..., "batch_stats": ...}``.
:func:`init_pico_params` makes one from a seed with the same tree and
shapes as the flax ``init``.  Plan-E/F module order (mattenet_hd.py:195-240):

  ConvBN_0 stem | ConvBN_1 d2dn | ConvBN_2 d2b | ConvBN_3 d3dn |
  ConvBN_4 d3b | ConvBN_5 ctx | SEBlock_0 | ConvBN_6 u2red(1x1) |
  ConvBN_7 u1red(1x1) | Conv_0 sem | Conv_1 det | Conv_2 alpha
"""

from __future__ import annotations

import numpy as np

# plan-F widths: stem c0, /2 level c2, /4 level c3
PICO_WIDTHS = (128, 128, 192)
SE_REDUCE = 4


def pico_conv_shapes(stem_stride: int) -> dict:
    """Kernel shape (HWIO) of every conv of the pico tree, by module name."""
    c0, c2, c3 = PICO_WIDTHS
    ss = stem_stride
    return {
        "ConvBN_0": (ss, ss, 3, c0),
        "ConvBN_1": (3, 3, c0, c2),
        "ConvBN_2": (3, 3, c2, c2),
        "ConvBN_3": (3, 3, c2, c3),
        "ConvBN_4": (3, 3, c3, c3),
        "ConvBN_5": (3, 3, c3, c3),
        "ConvBN_6": (1, 1, c3 + c2, c2),
        "ConvBN_7": (1, 1, c2 + c0, c0),
        "Conv_0": (1, 1, c3, 1),
        "Conv_1": (1, 1, c0, 1),
        "Conv_2": (3, 3, c0, 1),
    }


def init_pico_params(seed: int, stem_stride: int = 10) -> dict:
    """Seeded float pico tree: LeCun-normal kernels (truncated at 2 sigma),
    zero biases, BatchNorm at unit statistics -- flax's initializers, drawn
    from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)

    def lecun(shape):
        fan_in = int(np.prod(shape[:-1]))
        std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
        return (np.clip(rng.standard_normal(shape), -2.0, 2.0) * std).astype(np.float32)

    params, stats = {}, {}
    for name, shape in pico_conv_shapes(stem_stride).items():
        if name.startswith("ConvBN"):
            c = shape[-1]
            params[name] = {
                "Conv_0": {"kernel": lecun(shape)},
                "BatchNorm_0": {"scale": np.ones(c, np.float32),
                                "bias": np.zeros(c, np.float32)},
            }
            stats[name] = {"BatchNorm_0": {"mean": np.zeros(c, np.float32),
                                           "var": np.ones(c, np.float32)}}
        else:
            params[name] = {"kernel": lecun(shape),
                            "bias": np.zeros(shape[-1], np.float32)}
    c3 = PICO_WIDTHS[2]
    r = max(8, c3 // SE_REDUCE)
    params["SEBlock_0"] = {
        "Dense_0": {"kernel": lecun((c3, r)), "bias": np.zeros(r, np.float32)},
        "Dense_1": {"kernel": lecun((r, c3)), "bias": np.zeros(c3, np.float32)},
    }
    return {"params": params, "batch_stats": stats}
