"""The model zoo's table (port of ``models/registry.py``): each entry's
canonical input geometry and how its port module is built from a seeded
numpy tree.

Each tree is drawn from ``numpy.random.default_rng(seed)`` with the
reference's initialisers' shapes (flax names), so the same seed gives the
same tree on every machine and nothing reads a global random state.  The
plan-C entry serves through the port's int8 model
(models/quantized.py::QuantizedMatteNetHD, the tree quantized by the port's
quantizer): the port's float MatteNetHD covers only the plan-D decoders it
trains, and ``mattenet_hd``'s stride-5 float net is not ported.  The
entries whose models the port does not have yet stay listed, and
building one raises ``NotImplementedError`` naming the ROADMAP item that
ports it.
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
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import init_params as init_hd
from video_stream_segmenetation_tpu_torch.models.modnet import MatteNet, init_mattenet_params
from video_stream_segmenetation_tpu_torch.models.quantized import (
    QuantizedMatteNetHD,
    quantize_mattenet_hd,
)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """``make(tree, device, **kwargs)`` builds the module, ``init_tree(seed,
    **kwargs)`` draws its tree; ``unported`` names the ROADMAP item of an
    entry the port does not have yet."""

    name: str
    make: Callable[..., torch.nn.Module] | None
    init_tree: Callable[..., Any] | None
    input_hw: tuple[int, int]
    kwargs: dict = dataclasses.field(default_factory=dict)
    stateful: bool = False
    unported: str | None = None

    def _check(self) -> None:
        if self.unported:
            raise NotImplementedError(f"model {self.name!r} is not ported yet ({self.unported})")

    def build(self, tree, device="cuda", **overrides) -> torch.nn.Module:
        """The module serving ``tree`` on ``device``."""
        self._check()
        return self.make(tree, device, **{**self.kwargs, **overrides})

    def init_params(self, seed: int = 0, device="cuda", **overrides):
        """``(module, tree)`` for the tree drawn from ``seed``."""
        self._check()
        kw = {**self.kwargs, **overrides}
        tree = self.init_tree(seed, **kw)
        return self.make(tree, device, **kw), tree


def _hd_tree(seed, stem_stride, head_upsample, decoder):
    return quantize_mattenet_hd(init_hd(decoder, seed, stem_stride), stem_stride, decoder)


def _hd(tree, device, stem_stride, head_upsample, decoder):
    return QuantizedMatteNetHD(tree, stem_stride, head_upsample, device=device)


def _face(tree, device, input_size=256):
    return FaceFinder(tree, input_size, device=device)


def _unported(name, hw, item, **kw):
    return ModelSpec(name, None, None, hw, unported=f"ROADMAP Queue 1 item {item}", **kw)


@functools.lru_cache(maxsize=None)
def _registry() -> dict[str, ModelSpec]:
    return {
        # the float matting net of the active preset
        "mattenet": ModelSpec("mattenet", lambda t, d: MatteNet(t, device=d),
                              lambda seed: init_mattenet_params(seed), (288, 512)),
        # the 720p-native net at the reference's MatteNetHD() defaults:
        # stem stride 5, float (the int8 quantizer needs a stride >= 8)
        "mattenet_hd": _unported("mattenet_hd", (720, 1280), "4 (fast)",
                                 kwargs={"stem_stride": 5, "head_upsample": 2,
                                         "decoder": "full"}),
        # plan C (decoder='light')
        "mattenet_hd10_lite": ModelSpec(
            "mattenet_hd10_lite", _hd, _hd_tree, (720, 1280),
            {"stem_stride": 10, "head_upsample": 4, "decoder": "light"}),
        # the K=4 natural-layout MatteNet
        "mattenet_multiclass": _unported("mattenet_multiclass", (288, 512), "5 (multiclass)",
                                         kwargs={"num_classes": 4}),
        "facefinder": ModelSpec("facefinder", _face,
                                lambda seed, **_: init_face_finder_params(seed), (256, 256)),
        "facefinder128": ModelSpec("facefinder128", _face,
                                   lambda seed, **_: init_face_finder_params(seed), (128, 128),
                                   {"input_size": 128}),
        "landmarknet": ModelSpec("landmarknet", lambda t, d: LandmarkNet(t, device=d),
                                 lambda seed: init_landmark_net_params(seed), (192, 192)),
        "recurrent_mattenet": _unported("recurrent_mattenet", (288, 512), "4 (rvm)",
                                        stateful=True),
        "saliencynet": _unported("saliencynet", (320, 320), "4 (u2)"),
    }


def get_spec(name: str) -> ModelSpec:
    reg = _registry()
    if name not in reg:
        raise KeyError(f"unknown model '{name}'; have {sorted(reg)}")
    return reg[name]


def list_models() -> list[str]:
    return sorted(_registry())
