"""MatteNet, the float MODNet-class matting network of the ``active`` preset
and, with K class heads, of the natural-layout ``multiclass`` preset (port
of ``models/modnet.py`` at width 1.0, as the bf16 serving forward of
models/backbones.py's blocks).

A MobileNetV2-class encoder (/2, /4, /8, /16), the e-ASPP context at /16, a
detail branch at /4 and three decoder blocks (nearest x2, crop to the
skip, concat, two 3x3 ConvBNs) back to /2, then a nearest x2 to full
resolution, the input concatenated, a 3x3 ConvBN and a 1x1 alpha head, f32
sigmoid (one class) or f32 softmax over the K class channels (class 0 the
background); beside it the reference's two auxiliary heads, the semantic
map at /16 (sigmoid or softmax) and the detail logits at /4, which the
training loss reads.
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
    copy_parameters,
    export_layers,
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


def mattenet_spec(num_classes: int = 1, width: float = 1.0) -> dict:
    """The flax MatteNet's names and kernel shapes (K = ``num_classes``
    channels a head; the encoder's channels at ``width``, each
    ``max(8, int(n * width) // 8 * 8)`` as the reference's), in the
    reference's module creation order."""
    def wc(n):
        return max(8, int(n * width) // 8 * 8)

    enc = {"ConvBN_0": ("convbn", (3, 3, 3, wc(16)))}
    cin = wc(16)
    for i, (c, _, ex, se) in enumerate(ENCODER_BLOCKS):
        c = wc(c)
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
    f2, f4, f8 = (wc(ENCODER_BLOCKS[i][0]) for i in (0, 2, 4))
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


def init_mattenet_params(seed: int, num_classes: int = 1, width: float = 1.0) -> dict:
    """Seeded float tree with the flax MatteNet's names and shapes (the
    encoder at ``width``)."""
    return seeded_tree(np.random.default_rng(seed), mattenet_spec(num_classes, width))


class _DecoderBlock(torch.nn.Module):
    def __init__(self, params: dict, stats: dict, device="cpu",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.c0 = ConvBN(params["ConvBN_0"], stats["ConvBN_0"], device=device, dtype=dtype)
        self.c1 = ConvBN(params["ConvBN_1"], stats["ConvBN_1"], device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = nearest_x2(x)[:, :, : skip.shape[2], : skip.shape[3]]
        return self.c1(self.c0(torch.cat([x, skip], dim=1)))

    def export(self) -> tuple[dict, dict]:
        return export_layers({"ConvBN_0": self.c0, "ConvBN_1": self.c1})


class MatteNet(torch.nn.Module):
    """``[S, H, W, 3]`` f32 0..1 (H, W divisible by 16) -> ``{"alpha":
    [S, H, W], "semantic": [S, H/16, W/16], "detail": [S, H/4, W/4]}`` f32
    (alpha and semantic sigmoids, detail logits), or with K class heads
    each with a K axis last (alpha and semantic softmax maps).  K is the
    tree's: its three heads must agree on it.  Layers compute in ``dtype``
    (bf16, the reference's default, or f32); :meth:`tree` gives the
    flax-named numpy tree, :meth:`load_tree` loads one in place."""

    def __init__(self, tree: dict, device="cuda", dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        p, st = tree["params"], tree["batch_stats"]
        heads = [p[n]["kernel"].shape[-1] for n in ("Conv_0", "Conv_1", "Conv_2")]
        if len(set(heads)) != 1:
            raise ValueError(f"MatteNet: the tree's semantic, detail and alpha heads have "
                             f"{heads} classes; they must agree")
        self.num_classes, self.dtype = heads[0], dtype
        self.encoder = MobileEncoder(p["MobileEncoder_0"], st["MobileEncoder_0"], device, dtype)
        self.easpp = EASPP(p["EASPP_0"], st["EASPP_0"], device, dtype)
        self.sem_head = Conv(p["Conv_0"], device, dtype)
        self.detail = torch.nn.ModuleList(
            ConvBN(p[n], st[n], device=device, dtype=dtype) for n in ("ConvBN_0", "ConvBN_1"))
        self.det_head = Conv(p["Conv_1"], device, dtype)
        self.decoder = torch.nn.ModuleList(
            _DecoderBlock(p[f"_DecoderBlock_{i}"], st[f"_DecoderBlock_{i}"], device, dtype)
            for i in range(len(DECODER)))
        self.fusion = ConvBN(p["ConvBN_2"], st["ConvBN_2"], device=device, dtype=dtype)
        self.head = Conv(p["Conv_2"], device, dtype)

    def tree(self) -> dict:
        params, stats = export_layers({
            "MobileEncoder_0": self.encoder, "EASPP_0": self.easpp, "Conv_0": self.sem_head,
            "ConvBN_0": self.detail[0], "ConvBN_1": self.detail[1], "Conv_1": self.det_head,
            **{f"_DecoderBlock_{i}": b for i, b in enumerate(self.decoder)},
            "ConvBN_2": self.fusion, "Conv_2": self.head})
        return {"params": params, "batch_stats": stats}

    def load_tree(self, tree: dict) -> None:
        copy_parameters(self, MatteNet(tree, "cpu", self.dtype))

    def forward(self, x: torch.Tensor) -> dict:
        h, w = x.shape[1:3]
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        f2, f4, f8, f16 = self.encoder(x)
        sem = self.easpp(f16)
        sem_logit = self.sem_head(sem).to(torch.float32)
        d = torch.cat([f4, nearest_x2(sem, 2)[:, :, : f4.shape[2], : f4.shape[3]]], dim=1)
        for layer in self.detail:
            d = layer(d)
        det = self.det_head(d).to(torch.float32)
        u = self.decoder[0](sem, f8)
        u = self.decoder[1](u, torch.cat([f4, d], dim=1))
        u = self.decoder[2](u, f2)
        u = torch.cat([nearest_x2(u)[:, :, :h, :w], x], dim=1)
        logit = self.head(self.fusion(u)).to(torch.float32)
        if self.num_classes == 1:
            return {"alpha": torch.sigmoid(logit)[:, 0], "semantic": torch.sigmoid(sem_logit)[:, 0],
                    "detail": det[:, 0]}
        last = (0, 2, 3, 1)
        return {"alpha": torch.softmax(logit, dim=1).permute(*last),
                "semantic": torch.softmax(sem_logit, dim=1).permute(*last),
                "detail": det.permute(*last)}


def matting_alpha(model: MatteNet, frames: torch.Tensor) -> torch.Tensor:
    """Convenience (the reference's ``matting_alpha``): frames ``[S, H, W,
    3]`` in [0, 1] -> the model's alpha ``[S, H, W]`` (its weights are the
    module's own, where the reference passes its params)."""
    return model(frames)["alpha"]
