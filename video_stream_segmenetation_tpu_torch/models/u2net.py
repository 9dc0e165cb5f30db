"""SaliencyNet, the U2Net-class salient-object segmenter of the ``u2``
preset (port of ``models/u2net.py``; the role of the U2Net ONNX model of
u2FrameProc.ts, 320x320 input).

Nested U: four RSU (residual U) encoder blocks with 2x2 max-pooling
between them (SAME padding: an odd size pads its high edge), three RSU
decoder blocks over ``concat(nearest_x2(below) cropped, skip)``, a 3x3
side logit at each decoder level and at the bottom, nearest-upsampled to
the input and cropped, and a 1x1 conv over the four side logits in f32,
then sigmoid.  The compute dtype elsewhere (bf16, as flax's
``dtype=bfloat16``, or f32).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from video_stream_segmenetation_tpu_torch.models.backbones import (
    Conv,
    ConvBN,
    copy_parameters,
    export_layers,
    nearest_x2,
    seeded_tree,
)

# (depth, mid, out) of each RSU, in creation order: encoder e1..e4, then
# decoder d3, d2, d1
RSU_PLAN = ((4, 16, 32), (3, 16, 48), (2, 24, 64), (1, 32, 96),
            (1, 24, 64), (2, 16, 48), (3, 16, 32))


def _rsu_spec(cin: int, depth: int, mid: int, out: int) -> dict:
    """An RSU's ConvBNs: the input conv, ``depth`` encoder convs, the
    dilated bottom, ``depth`` decoder convs over the concat, the output."""
    spec = {"ConvBN_0": ("convbn", (3, 3, cin, out))}
    chans = [out] + [mid] * depth  # each encoder conv's input
    for i in range(depth):
        spec[f"ConvBN_{1 + i}"] = ("convbn", (3, 3, chans[i], mid))
    spec[f"ConvBN_{depth + 1}"] = ("convbn", (3, 3, mid, mid))
    for i in range(depth):
        spec[f"ConvBN_{depth + 2 + i}"] = ("convbn", (3, 3, 2 * mid, mid))
    spec[f"ConvBN_{2 * depth + 2}"] = ("convbn", (3, 3, mid, out))
    return spec


def u2net_spec() -> dict:
    """The flax SaliencyNet's names and kernel shapes, in its module
    creation order."""
    outs = [p[2] for p in RSU_PLAN]
    e1, e2, e3, e4 = outs[:4]
    cins = (3, e1, e2, e3, e4 + e3, outs[4] + e2, outs[5] + e1)
    spec = {f"RSU_{i}": _rsu_spec(cin, *plan) for i, (cin, plan) in
            enumerate(zip(cins, RSU_PLAN))}
    # side logits on d1, d2, d3 and e4, then the fused 1x1 over them
    for i, c in enumerate((outs[6], outs[5], outs[4], e4)):
        spec[f"Conv_{i}"] = ("conv", (3, 3, c, 1))
    spec["Conv_4"] = ("conv", (1, 1, 4, 1))
    return spec


def init_u2net_params(seed: int) -> dict:
    """Seeded float tree with the flax SaliencyNet's names and shapes
    (models/backbones.py::seeded_tree)."""
    return seeded_tree(np.random.default_rng(seed), u2net_spec())


def max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool of NCHW ``x`` with 'SAME' padding (an odd
    size pads its high edge with -inf, as flax's ``nn.max_pool``)."""
    h, w = x.shape[2], x.shape[3]
    x = F.pad(x, (0, w % 2, 0, h % 2), value=float("-inf"))
    return F.max_pool2d(x, 2, 2)


def _crop_to(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x[:, :, : like.shape[2], : like.shape[3]]


class RSU(torch.nn.Module):
    """Residual U-block: an inner encoder-decoder at the block's scale,
    plus the input conv's output."""

    def __init__(self, params: dict, stats: dict, depth: int, device="cpu",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.depth = depth
        self.convs = torch.nn.ModuleList(
            ConvBN(params[f"ConvBN_{i}"], stats[f"ConvBN_{i}"], device=device,
                   dilation=2 if i == depth + 1 else 1, dtype=dtype)
            for i in range(2 * depth + 3))

    def export(self) -> tuple[dict, dict]:
        return export_layers({f"ConvBN_{i}": m for i, m in enumerate(self.convs)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.depth
        hx = self.convs[0](x)
        feats, h = [], hx
        for i in range(d):
            h = self.convs[1 + i](h)
            feats.append(h)
            h = max_pool_same(h)
        h = self.convs[d + 1](h)
        for i, skip in enumerate(reversed(feats)):
            h = self.convs[d + 2 + i](torch.cat([_crop_to(nearest_x2(h), skip), skip], dim=1))
        return self.convs[2 * d + 2](h) + hx


class SaliencyNet(torch.nn.Module):
    """``[S, H, W, 3]`` f32 0..1 (320x320 canonical) -> ``{"alpha": [S, H,
    W] f32 (sigmoid), "side": the four side outputs (sigmoid)}``.  Layers
    compute in ``dtype`` (bf16, the reference's default, or f32), the fused
    1x1 in f32; :meth:`tree` gives the flax-named numpy tree,
    :meth:`load_tree` loads one in place."""

    def __init__(self, tree: dict, device="cuda", dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        p, st = tree["params"], tree["batch_stats"]
        self.dtype = dtype
        self.rsu = torch.nn.ModuleList(
            RSU(p[f"RSU_{i}"], st[f"RSU_{i}"], plan[0], device, dtype)
            for i, plan in enumerate(RSU_PLAN))
        self.side = torch.nn.ModuleList(Conv(p[f"Conv_{i}"], device, dtype) for i in range(4))
        self.fuse = Conv(p["Conv_4"], device, dtype=torch.float32)

    def tree(self) -> dict:
        params, stats = export_layers({**{f"RSU_{i}": m for i, m in enumerate(self.rsu)},
                                       **{f"Conv_{i}": m for i, m in enumerate(self.side)},
                                       "Conv_4": self.fuse})
        return {"params": params, "batch_stats": stats}

    def load_tree(self, tree: dict) -> None:
        copy_parameters(self, SaliencyNet(tree, "cpu", self.dtype))

    def forward(self, x: torch.Tensor) -> dict:
        h, w = x.shape[1:3]
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        e1 = self.rsu[0](x)
        e2 = self.rsu[1](max_pool_same(e1))
        e3 = self.rsu[2](max_pool_same(e2))
        e4 = self.rsu[3](max_pool_same(e3))
        d3 = self.rsu[4](torch.cat([_crop_to(nearest_x2(e4), e3), e3], dim=1))
        d2 = self.rsu[5](torch.cat([_crop_to(nearest_x2(d3), e2), e2], dim=1))
        d1 = self.rsu[6](torch.cat([_crop_to(nearest_x2(d2), e1), e1], dim=1))
        sides = []
        for conv, feat, times in zip(self.side, (d1, d2, d3, e4), range(4)):
            logit = nearest_x2(conv(feat), times)[:, :, :h, :w]
            sides.append(logit.to(torch.float32))
        fused = self.fuse(torch.cat(sides, dim=1))[:, 0]
        return {"alpha": torch.sigmoid(fused),
                "side": [torch.sigmoid(t[:, 0]) for t in sides]}
