"""LandmarkNet, the FaceMesh-468-class landmark regressor of the face path
(port of ``models/facemesh.py``): a dense bf16 3x3 trunk, a 1x1 conv to
256, a global mean and one bf16 dense layer to 468 x 3 landmarks + a
score; x/y through a sigmoid (normalized to the ROI), z raw."""

from __future__ import annotations

import numpy as np
import torch

from video_stream_segmenetation_tpu_torch.models.backbones import (
    ConvBN,
    Dense,
    copy_parameters,
    export_layers,
    mean_hw,
    seeded_tree,
)

NUM_LANDMARKS = 468

# (features, stride, kernel) of ConvBN_0..ConvBN_8
_TRUNK = ((32, 2, 3), (48, 2, 3), (48, 1, 3), (64, 2, 3), (64, 1, 3),
          (96, 2, 3), (96, 1, 3), (128, 2, 3), (256, 1, 1))


def landmark_net_spec() -> dict:
    spec, cin = {}, 3
    for i, (c, _, k) in enumerate(_TRUNK):
        spec[f"ConvBN_{i}"] = ("convbn", (k, k, cin, c))
        cin = c
    spec["Dense_0"] = ("dense", (cin, NUM_LANDMARKS * 3 + 1))
    return spec


def init_landmark_net_params(seed: int) -> dict:
    """Seeded float tree with the flax LandmarkNet's names and shapes."""
    return seeded_tree(np.random.default_rng(seed), landmark_net_spec())


class LandmarkNet(torch.nn.Module):
    """``[S, n, n, 3]`` f32 -> ``{"landmarks": [S, 468, 3], "scores": [S]}``
    f32.  Layers compute in ``dtype`` (bf16, the reference's default, or
    f32); :meth:`tree` and :meth:`load_tree` as FaceFinder's."""

    def __init__(self, tree: dict, device="cuda", dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        p, st = tree["params"], tree["batch_stats"]
        self.trunk = torch.nn.ModuleList(
            ConvBN(p[f"ConvBN_{i}"], st[f"ConvBN_{i}"], stride=s, device=device, dtype=dtype)
            for i, (_, s, _) in enumerate(_TRUNK))
        self.dense = Dense(p["Dense_0"], device, dtype)

    def tree(self) -> dict:
        params, stats = export_layers({**{f"ConvBN_{i}": m for i, m in enumerate(self.trunk)},
                                       "Dense_0": self.dense})
        return {"params": params, "batch_stats": stats}

    def load_tree(self, tree: dict) -> None:
        copy_parameters(self, LandmarkNet(tree, "cpu", self.dtype))

    def forward(self, x: torch.Tensor) -> dict:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        for layer in self.trunk:
            x = layer(x)
        # jnp.mean sums in f32 and rounds the mean to the compute dtype
        out = self.dense(mean_hw(x)).to(torch.float32)
        lm = out[:, : NUM_LANDMARKS * 3].reshape(-1, NUM_LANDMARKS, 3)
        xy = torch.sigmoid(lm[..., :2])
        return {"landmarks": torch.cat([xy, lm[..., 2:3]], dim=-1),
                "scores": torch.sigmoid(out[:, -1])}
