"""RecurrentMatteNet, the RVM-class stateful matting net of the ``rvm``
preset (port of ``models/rvm.py``; the role of the RVM ONNX model of
frameProcessorRVM.ts:16-19,46-70).

The input is downsampled (``downsample_ratio`` 0.25, half-pixel bilinear)
and run through the MobileNetV2-class encoder of models/backbones.py; a
1x1 ConvBN and a ConvGRU at /16, then three up blocks (nearest x2, crop to
the skip, concat, a 3x3 ConvBN, a ConvGRU) back to /2; nearest x2, the
downsampled input concatenated, a 3x3 ConvBN and a 1x1 head give the
low-resolution alpha (f32 sigmoid); it is upsampled half-pixel bilinear
to the input and refined by two 3x3 convs over the input and itself,
clipped to [0, 1].  Everything computes in the compute dtype (bf16, as
flax's ``dtype=bfloat16`` with f32 parameters does, or f32).

The recurrent state is four NHWC f32 tensors r1..r4 at /2, /4, /8, /16 of
the downsampled input with :data:`REC_CHANNELS` channels (the reference's
``RecurrentState``, here a plain tuple so that it rides
``StreamState.rec``); each GRU casts its state to the compute dtype and
the new state goes back to f32.
"""

from __future__ import annotations

import numpy as np
import torch

from video_stream_segmenetation_tpu_torch.models.backbones import (
    ENCODER_BLOCKS,
    Conv,
    ConvBN,
    MobileEncoder,
    copy_parameters,
    export_layers,
    nearest_x2,
    seeded_tree,
)
from video_stream_segmenetation_tpu_torch.models.modnet import mattenet_spec
from video_stream_segmenetation_tpu_torch.ops.resize import resize_bilinear

# channels of r1..r4 (frameProcessorRVM.ts:16-19): /2, /4, /8, /16
REC_CHANNELS = (16, 20, 40, 64)
DOWNSAMPLE_RATIO = 0.25
FUSION = 16  # the ConvBN before the low-resolution alpha head
REFINE = 8  # the full-resolution refinement conv's width


def _down_hw(hw, ratio: float = DOWNSAMPLE_RATIO) -> tuple[int, int]:
    """The downsampled input's size (Python's round, as the reference)."""
    return max(1, round(hw[0] * ratio)), max(1, round(hw[1] * ratio))


def init_state(batch: int, hw: tuple[int, int], downsample_ratio: float = DOWNSAMPLE_RATIO,
               device="cpu") -> tuple:
    """Zero recurrent state, the documented cold start
    (frameProcessorRVM.ts:48-53): r1..r4 NHWC f32, each stage ceil(n/2)
    of the one above (SAME-padded stride-2 convs)."""
    dh, dw = _down_hw(hw, downsample_ratio)
    return tuple(torch.zeros((batch, -(-dh // s), -(-dw // s), c), dtype=torch.float32,
                             device=device)
                 for s, c in zip((2, 4, 8, 16), REC_CHANNELS))


def rvm_spec() -> dict:
    """The flax RecurrentMatteNet's names and kernel shapes (width 1.0), in
    its module creation order."""
    f2, f4, f8 = ENCODER_BLOCKS[0][0], ENCODER_BLOCKS[2][0], ENCODER_BLOCKS[4][0]
    f16 = ENCODER_BLOCKS[7][0]

    def gru(cin, c):
        return {"Conv_0": ("conv", (3, 3, cin + c, 2 * c)),
                "Conv_1": ("conv", (3, 3, cin + c, c))}

    r1, r2, r3, r4 = REC_CHANNELS
    return {
        "MobileEncoder_0": mattenet_spec()["MobileEncoder_0"],
        "ConvBN_0": ("convbn", (1, 1, f16, r4)),
        "ConvGRU_0": gru(r4, r4),
        "ConvBN_1": ("convbn", (3, 3, r4 + f8, r3)),
        "ConvGRU_1": gru(r3, r3),
        "ConvBN_2": ("convbn", (3, 3, r3 + f4, r2)),
        "ConvGRU_2": gru(r2, r2),
        "ConvBN_3": ("convbn", (3, 3, r2 + f2, r1)),
        "ConvGRU_3": gru(r1, r1),
        "ConvBN_4": ("convbn", (3, 3, r1 + 3, FUSION)),
        "Conv_0": ("conv", (1, 1, FUSION, 1)),
        "Conv_1": ("conv", (3, 3, 4, REFINE)),
        "Conv_2": ("conv", (3, 3, REFINE, 1)),
    }


def init_rvm_params(seed: int) -> dict:
    """Seeded float tree with the flax RecurrentMatteNet's names and
    shapes (models/backbones.py::seeded_tree)."""
    return seeded_tree(np.random.default_rng(seed), rvm_spec())


class ConvGRU(torch.nn.Module):
    """Convolutional GRU in ``dtype``: ``z, r = sigmoid(conv([x, h]))``,
    ``cand = tanh(conv([x, r h]))``, ``h' = (1 - z) h + z cand``.  NCHW."""

    def __init__(self, params: dict, device="cpu", dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.zr = Conv(params["Conv_0"], device, dtype)
        self.cand = Conv(params["Conv_1"], device, dtype)

    def export(self) -> tuple[dict, dict]:
        return export_layers({"Conv_0": self.zr, "Conv_1": self.cand})

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        h = h.to(self.dtype)
        z, r = torch.sigmoid(self.zr(torch.cat([x, h], dim=1))).chunk(2, dim=1)
        cand = torch.tanh(self.cand(torch.cat([x, r * h], dim=1)))
        return (1 - z) * h + z * cand


class RecurrentMatteNet(torch.nn.Module):
    """``(x [S, H, W, 3] f32 0..1, state (r1, r2, r3, r4)) -> {"alpha":
    [S, H, W] f32 in [0, 1], "alpha_small": [S, dH, dW] f32, "state": the
    new (r1..r4) f32}``.  Layers compute in ``dtype`` (bf16, the
    reference's default, or f32); :meth:`tree` gives the flax-named numpy
    tree, :meth:`load_tree` loads one in place."""

    def __init__(self, tree: dict, device="cuda", downsample_ratio: float = DOWNSAMPLE_RATIO,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        p, st = tree["params"], tree["batch_stats"]
        self.downsample_ratio, self.dtype = downsample_ratio, dtype
        self.encoder = MobileEncoder(p["MobileEncoder_0"], st["MobileEncoder_0"], device, dtype)
        self.convbn = torch.nn.ModuleList(
            ConvBN(p[f"ConvBN_{i}"], st[f"ConvBN_{i}"], device=device, dtype=dtype)
            for i in range(5))
        self.gru = torch.nn.ModuleList(ConvGRU(p[f"ConvGRU_{i}"], device, dtype)
                                       for i in range(4))
        self.head = Conv(p["Conv_0"], device, dtype)
        self.refine = torch.nn.ModuleList(Conv(p[f"Conv_{i}"], device, dtype) for i in (1, 2))

    def tree(self) -> dict:
        params, stats = export_layers({
            "MobileEncoder_0": self.encoder,
            **{f"ConvBN_{i}": m for i, m in enumerate(self.convbn)},
            **{f"ConvGRU_{i}": m for i, m in enumerate(self.gru)},
            "Conv_0": self.head, "Conv_1": self.refine[0], "Conv_2": self.refine[1]})
        return {"params": params, "batch_stats": stats}

    def load_tree(self, tree: dict) -> None:
        copy_parameters(self, RecurrentMatteNet(tree, "cpu", self.downsample_ratio, self.dtype))

    def forward(self, x: torch.Tensor, state) -> dict:
        s, h, w, _ = x.shape
        dh, dw = _down_hw((h, w), self.downsample_ratio)
        x32 = x.to(torch.float32)
        small = resize_bilinear(x32, (dh, dw), method="half_pixel").to(self.dtype)
        small = small.permute(0, 3, 1, 2)
        f2, f4, f8, f16 = self.encoder(small)
        rec = [r.permute(0, 3, 1, 2) for r in state]
        g = self.gru[0](self.convbn[0](f16), rec[3])
        new = [g]
        # up blocks to /8, /4, /2: nearest x2 cropped to the skip, concat,
        # a 3x3 ConvBN, the GRU on that scale's state
        for i, (skip, r) in enumerate(((f8, rec[2]), (f4, rec[1]), (f2, rec[0])), start=1):
            xu = nearest_x2(g)[:, :, : skip.shape[2], : skip.shape[3]]
            g = self.gru[i](self.convbn[i](torch.cat([xu, skip], dim=1)), r)
            new.append(g)
        out = torch.cat([nearest_x2(g)[:, :, :dh, :dw], small], dim=1)
        logit = self.head(self.convbn[4](out))
        alpha_small = torch.sigmoid(logit.to(torch.float32))[:, 0]
        # full resolution: bilinear upsample + a guided refinement conv
        alpha_up = resize_bilinear(alpha_small, (h, w), method="half_pixel",
                                   channel_last=False)
        guide = torch.cat([x32, alpha_up[..., None]], dim=-1).to(self.dtype)
        res = self.refine[1](torch.relu(self.refine[0](guide.permute(0, 3, 1, 2))))
        alpha = torch.clamp(alpha_up + res.to(torch.float32)[:, 0], 0.0, 1.0)
        r4, r3, r2, r1 = (t.permute(0, 2, 3, 1).to(torch.float32) for t in new)
        return {"alpha": alpha, "alpha_small": alpha_small, "state": (r1, r2, r3, r4)}
