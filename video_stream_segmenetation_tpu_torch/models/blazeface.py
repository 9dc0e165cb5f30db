"""FaceFinder, the BlazeFace-class anchor detector of the face path (port
of ``models/blazeface.py``): a dense bf16 3x3 trunk to /16 and /32, two
anchor heads, the SSD decode of ops/detect.py and f32 sigmoid scores."""

from __future__ import annotations

import numpy as np
import torch

from video_stream_segmenetation_tpu_torch.models.backbones import (
    Conv,
    ConvBN,
    copy_parameters,
    export_layers,
    seeded_tree,
)
from video_stream_segmenetation_tpu_torch.ops.detect import (
    blazeface_anchors,
    decode_anchor_boxes,
)

# (features, stride) of ConvBN_0..ConvBN_8; /16 after ConvBN_6, /32 after 8
_TRUNK = ((32, 2), (48, 2), (48, 1), (64, 2), (64, 1), (96, 2), (96, 1),
          (128, 2), (128, 1))
# anchor heads: (input channels, anchors a cell) at /16 and /32
_HEADS = ((96, 2), (128, 6))


def face_finder_spec() -> dict:
    spec, cin = {}, 3
    for i, (c, _) in enumerate(_TRUNK):
        spec[f"ConvBN_{i}"] = ("convbn", (3, 3, cin, c))
        cin = c
    for j, (ch, per_cell) in enumerate(_HEADS):
        spec[f"Conv_{2 * j}"] = ("conv", (3, 3, ch, per_cell * 16))
        spec[f"Conv_{2 * j + 1}"] = ("conv", (3, 3, ch, per_cell))
    return spec


def init_face_finder_params(seed: int) -> dict:
    """Seeded float tree with the flax FaceFinder's names and shapes (the
    same for every input size)."""
    return seeded_tree(np.random.default_rng(seed), face_finder_spec())


class FaceFinder(torch.nn.Module):
    """``[S, n, n, 3]`` f32 (n = input_size) -> ``{"box_coords": [S, A, 16]``
    normalized, ``"box_scores": [S, A]}`` f32.  Layers compute in ``dtype``
    (bf16, the reference's default, or f32).  :meth:`tree` gives the
    flax-named numpy tree, :meth:`load_tree` loads one in place."""

    def __init__(self, tree: dict, input_size: int = 256, device="cuda",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.input_size, self.dtype = input_size, dtype
        p, st = tree["params"], tree["batch_stats"]
        self.trunk = torch.nn.ModuleList(
            ConvBN(p[f"ConvBN_{i}"], st[f"ConvBN_{i}"], stride=s, device=device, dtype=dtype)
            for i, (_, s) in enumerate(_TRUNK))
        self.heads = torch.nn.ModuleList(Conv(p[f"Conv_{i}"], device, dtype) for i in range(4))
        self.register_buffer("anchors", torch.as_tensor(
            np.array(blazeface_anchors(input_size)), device=device))

    def tree(self) -> dict:
        params, stats = export_layers({**{f"ConvBN_{i}": m for i, m in enumerate(self.trunk)},
                                       **{f"Conv_{i}": m for i, m in enumerate(self.heads)}})
        return {"params": params, "batch_stats": stats}

    def load_tree(self, tree: dict) -> None:
        copy_parameters(self, FaceFinder(tree, self.input_size, "cpu", self.dtype))

    def forward(self, x: torch.Tensor) -> dict:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        feats = []
        for i, layer in enumerate(self.trunk):
            x = layer(x)
            if i in (6, 8):
                feats.append(x)
        s = x.shape[0]
        raws, logits = [], []
        for j, feat in enumerate(feats):
            raw = self.heads[2 * j](feat).permute(0, 2, 3, 1).reshape(s, -1, 16)
            cls = self.heads[2 * j + 1](feat).permute(0, 2, 3, 1).reshape(s, -1)
            raws.append(raw)
            logits.append(cls)
        raw = torch.cat(raws, dim=1).to(torch.float32)
        logit = torch.cat(logits, dim=1).to(torch.float32)
        return {"box_coords": decode_anchor_boxes(raw, self.anchors, self.input_size),
                "box_scores": torch.sigmoid(logit)}
