"""The model zoo's table (port of ``models/registry.py``): each entry's
canonical input geometry and how its port module is built from a seeded
numpy tree.

Each tree is drawn from ``numpy.random.default_rng(seed)`` with the
reference's initialisers' shapes (flax names), so the same seed gives the
same tree on every machine and nothing reads a global random state.  The
plan-C entry serves through the port's int8 model
(models/quantized.py::QuantizedMatteNetHD, the tree quantized by the port's
quantizer); ``mattenet_hd`` (plan A, stem stride 5) through the port's
float MatteNetHD.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from video_stream_segmenetation_tpu_torch.models.blazeface import (
    FaceFinder,
    init_face_finder_params,
)
from video_stream_segmenetation_tpu_torch.models.facemesh import (
    LandmarkNet,
    init_landmark_net_params,
)
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import MatteNetHD
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import init_params as init_hd
from video_stream_segmenetation_tpu_torch.models.modnet import MatteNet, init_mattenet_params
from video_stream_segmenetation_tpu_torch.models.quantized import (
    QuantizedMatteNetHD,
    quantize_mattenet_hd,
)
from video_stream_segmenetation_tpu_torch.models.rvm import RecurrentMatteNet, init_rvm_params
from video_stream_segmenetation_tpu_torch.models.u2net import SaliencyNet, init_u2net_params


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """``make(tree, device, **kwargs)`` builds the module, ``init_tree(seed,
    **kwargs)`` draws its tree."""

    name: str
    make: Callable[..., torch.nn.Module]
    init_tree: Callable[..., Any]
    input_hw: tuple[int, int]
    kwargs: dict = dataclasses.field(default_factory=dict)
    stateful: bool = False

    def build(self, tree, device="cuda", **overrides) -> torch.nn.Module:
        """The module serving ``tree`` on ``device``."""
        return self.make(tree, device, **{**self.kwargs, **overrides})

    def init_params(self, seed: int = 0, device="cuda", **overrides):
        """``(module, tree)`` for the tree drawn from ``seed``."""
        kw = {**self.kwargs, **overrides}
        tree = self.init_tree(seed, **kw)
        return self.make(tree, device, **kw), tree


def _hd_tree(seed, stem_stride, head_upsample, decoder):
    return quantize_mattenet_hd(init_hd(decoder, seed, stem_stride), stem_stride, decoder)


def _hd(tree, device, stem_stride, head_upsample, decoder):
    return QuantizedMatteNetHD(tree, stem_stride, head_upsample, device=device)


def _float_hd(tree, device, stem_stride, head_upsample, decoder):
    return MatteNetHD(stem_stride, head_upsample, decoder, params=tree, device=device)


def _face(tree, device, input_size=256):
    return FaceFinder(tree, input_size, device=device)


@functools.lru_cache(maxsize=None)
def _registry() -> dict[str, ModelSpec]:
    return {
        # the float matting net of the active preset
        "mattenet": ModelSpec("mattenet", lambda t, d: MatteNet(t, device=d),
                              lambda seed: init_mattenet_params(seed), (288, 512)),
        # the 720p-native net at the reference's MatteNetHD() defaults:
        # plan A, stem stride 5, float (the int8 quantizer needs a stride
        # >= 8); the fast preset's model
        "mattenet_hd": ModelSpec(
            "mattenet_hd", _float_hd,
            lambda seed, stem_stride, head_upsample, decoder: init_hd(decoder, seed,
                                                                      stem_stride),
            (720, 1280), {"stem_stride": 5, "head_upsample": 2, "decoder": "full"}),
        # plan C (decoder='light')
        "mattenet_hd10_lite": ModelSpec(
            "mattenet_hd10_lite", _hd, _hd_tree, (720, 1280),
            {"stem_stride": 10, "head_upsample": 4, "decoder": "light"}),
        # the K=4 natural-layout MatteNet (the multiclass preset's model)
        "mattenet_multiclass": ModelSpec(
            "mattenet_multiclass", lambda t, d, num_classes: MatteNet(t, device=d),
            lambda seed, num_classes: init_mattenet_params(seed, num_classes), (288, 512),
            {"num_classes": 4}),
        "facefinder": ModelSpec("facefinder", _face,
                                lambda seed, **_: init_face_finder_params(seed), (256, 256)),
        "facefinder128": ModelSpec("facefinder128", _face,
                                   lambda seed, **_: init_face_finder_params(seed), (128, 128),
                                   {"input_size": 128}),
        "landmarknet": ModelSpec("landmarknet", lambda t, d: LandmarkNet(t, device=d),
                                 lambda seed: init_landmark_net_params(seed), (192, 192)),
        # recurrent matting (the rvm preset; state: models/rvm.py::init_state)
        "recurrent_mattenet": ModelSpec("recurrent_mattenet",
                                        lambda t, d: RecurrentMatteNet(t, device=d),
                                        lambda seed: init_rvm_params(seed), (288, 512),
                                        stateful=True),
        # the salient-object net of the u2 preset
        "saliencynet": ModelSpec("saliencynet", lambda t, d: SaliencyNet(t, device=d),
                                 lambda seed: init_u2net_params(seed), (320, 320)),
    }


def get_spec(name: str) -> ModelSpec:
    reg = _registry()
    if name not in reg:
        raise KeyError(f"unknown model '{name}'; have {sorted(reg)}")
    return reg[name]


def list_models() -> list[str]:
    return sorted(_registry())
