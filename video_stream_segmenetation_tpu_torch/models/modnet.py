"""MatteNet, the float MODNet-class matting network of the ``active`` preset
and, with K class heads, of the natural-layout ``multiclass`` preset (port
of ``models/modnet.py`` at width 1.0, as the bf16 serving forward of
models/backbones.py's blocks).

A MobileNetV2-class encoder (/2, /4, /8, /16), the e-ASPP context at /16, a
detail branch at /4 and three decoder blocks (nearest x2, crop to the
skip, concat, two 3x3 ConvBNs) back to /2, then a nearest x2 to full
resolution, the input concatenated, a 3x3 ConvBN and a 1x1 alpha head, f32
sigmoid (one class) or f32 softmax over the K class channels (class 0 the
background).  The reference's two auxiliary heads (the semantic and detail
logits, used in training) feed nothing the alpha needs, so the port
computes only the alpha.
"""

from __future__ import annotations

import numpy as np
import torch

from video_stream_segmenetation_tpu_torch.models.backbones import (
    EASPP,
    EASPP_RATES,
    ENCODER_BLOCKS,
    Conv,
    ConvBN,
    MobileEncoder,
    nearest_x2,
    seeded_tree,
)

SEM_FEATURES = 96  # the e-ASPP's width
DETAIL = (48, 32)  # the detail branch's two ConvBNs
DECODER = (64, 48, 24)  # the decoder blocks, /8, /4, /2
FUSION = 16  # the full-resolution ConvBN before the alpha head


def _se(c: int) -> dict:
    r = max(8, c // 4)
    return {"Dense_0": ("dense", (c, r)), "Dense_1": ("dense", (r, c))}


def mattenet_spec(num_classes: int = 1) -> dict:
    """The flax MatteNet's names and kernel shapes (width 1.0, K =
    ``num_classes`` channels a head), in the reference's module creation
    order."""
    enc = {"ConvBN_0": ("convbn", (3, 3, 3, 16))}
    cin = 16
    for i, (c, _, ex, se) in enumerate(ENCODER_BLOCKS):
        mid = cin * ex
        blk, j = {}, 0
        if ex != 1:
            blk["ConvBN_0"] = ("convbn", (1, 1, cin, mid))
            j = 1
        blk[f"ConvBN_{j}"] = ("convbn", (3, 3, 1, mid))
        if se:
            blk["SEBlock_0"] = _se(mid)
        blk[f"ConvBN_{j + 1}"] = ("convbn", (1, 1, mid, c))
        enc[f"InvertedResidual_{i}"] = blk
        cin = c
    f2, f4, f8 = ENCODER_BLOCKS[0][0], ENCODER_BLOCKS[2][0], ENCODER_BLOCKS[4][0]
    easpp = {f"ConvBN_{i}": ("convbn", (3, 3, 1, cin)) for i in range(len(EASPP_RATES))}
    easpp[f"ConvBN_{len(EASPP_RATES)}"] = ("convbn", (1, 1, cin * len(EASPP_RATES),
                                                      SEM_FEATURES))
    easpp["SEBlock_0"] = _se(SEM_FEATURES)
    d0, d1 = DETAIL
    u8, u4, u2 = DECODER

    def dec(cin_, skip, c):
        return {"ConvBN_0": ("convbn", (3, 3, cin_ + skip, c)),
                "ConvBN_1": ("convbn", (3, 3, c, c))}

    return {
        "MobileEncoder_0": enc,
        "EASPP_0": easpp,
        "Conv_0": ("conv", (1, 1, SEM_FEATURES, num_classes)),
        "ConvBN_0": ("convbn", (3, 3, f4 + SEM_FEATURES, d0)),
        "ConvBN_1": ("convbn", (3, 3, d0, d1)),
        "Conv_1": ("conv", (1, 1, d1, num_classes)),
        "_DecoderBlock_0": dec(SEM_FEATURES, f8, u8),
        "_DecoderBlock_1": dec(u8, f4 + d1, u4),
        "_DecoderBlock_2": dec(u4, f2, u2),
        "ConvBN_2": ("convbn", (3, 3, u2 + 3, FUSION)),
        "Conv_2": ("conv", (1, 1, FUSION, num_classes)),
    }


def init_mattenet_params(seed: int, num_classes: int = 1) -> dict:
    """Seeded float tree with the flax MatteNet's names and shapes."""
    return seeded_tree(np.random.default_rng(seed), mattenet_spec(num_classes))


class _DecoderBlock(torch.nn.Module):
    def __init__(self, params: dict, stats: dict, device="cpu"):
        super().__init__()
        self.c0 = ConvBN(params["ConvBN_0"], stats["ConvBN_0"], device=device)
        self.c1 = ConvBN(params["ConvBN_1"], stats["ConvBN_1"], device=device)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = nearest_x2(x)[:, :, : skip.shape[2], : skip.shape[3]]
        return self.c1(self.c0(torch.cat([x, skip], dim=1)))


class MatteNet(torch.nn.Module):
    """``[S, H, W, 3]`` f32 0..1 (H, W divisible by 16) -> ``{"alpha":
    [S, H, W]}`` f32 in [0, 1], or with K class heads ``[S, H, W, K]``
    softmax maps.  K is the tree's: its three heads must agree on it."""

    def __init__(self, tree: dict, device="cpu"):
        super().__init__()
        p, st = tree["params"], tree["batch_stats"]
        heads = [p[n]["kernel"].shape[-1] for n in ("Conv_0", "Conv_1", "Conv_2")]
        if len(set(heads)) != 1:
            raise ValueError(f"MatteNet: the tree's semantic, detail and alpha heads have "
                             f"{heads} classes; they must agree")
        self.num_classes = heads[0]
        self.encoder = MobileEncoder(p["MobileEncoder_0"], st["MobileEncoder_0"], device)
        self.easpp = EASPP(p["EASPP_0"], st["EASPP_0"], device)
        self.detail = torch.nn.ModuleList(
            ConvBN(p[n], st[n], device=device) for n in ("ConvBN_0", "ConvBN_1"))
        self.decoder = torch.nn.ModuleList(
            _DecoderBlock(p[f"_DecoderBlock_{i}"], st[f"_DecoderBlock_{i}"], device)
            for i in range(len(DECODER)))
        self.fusion = ConvBN(p["ConvBN_2"], st["ConvBN_2"], device=device)
        self.head = Conv(p["Conv_2"], device)

    def forward(self, x: torch.Tensor) -> dict:
        h, w = x.shape[1:3]
        x = x.to(torch.bfloat16).permute(0, 3, 1, 2)
        f2, f4, f8, f16 = self.encoder(x)
        sem = self.easpp(f16)
        d = torch.cat([f4, nearest_x2(sem, 2)[:, :, : f4.shape[2], : f4.shape[3]]], dim=1)
        for layer in self.detail:
            d = layer(d)
        u = self.decoder[0](sem, f8)
        u = self.decoder[1](u, torch.cat([f4, d], dim=1))
        u = self.decoder[2](u, f2)
        u = torch.cat([nearest_x2(u)[:, :, :h, :w], x], dim=1)
        logit = self.head(self.fusion(u)).to(torch.float32)
        if self.num_classes == 1:
            return {"alpha": torch.sigmoid(logit)[:, 0]}
        return {"alpha": torch.softmax(logit, dim=1).permute(0, 2, 3, 1)}
