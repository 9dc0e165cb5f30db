"""int8 serving graphs of the face subpath's FaceFinder and LandmarkNet
(port of ``models/quantized_face.py``): the trunk's scheme
(models/quantized.py) on the face models.

* :func:`quantize_face_finder` and :func:`quantize_landmark_net`: numpy
  copies of the reference's quantizers, bit for bit -- BatchNorm folded
  into per-output-channel int8 weights, every activation a relu6 output so
  that requantization is the 6/127 lattice; the first layer's input on a
  1/127 lattice (``round(x * 127)`` of the 0..1 image: zero stays exact
  under the 'SAME' padding); the heads int8 in, an f32 epilogue out
  (``acc * mult + bias``); LandmarkNet's pooled Dense head kept float.
* :class:`QuantizedFaceFinder` and :class:`QuantizedLandmarkNet`: the
  forwards, behind the same contract as models/blazeface.py and
  facemesh.py.  Their convolutions are models/quantized.py::_conv_i8, the
  exact int8 convolution (float64 accumulation, exact at these sizes), as
  the reference computes them with XLA's s8 convolution, outside any
  Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from video_stream_segmenetation_tpu_torch.models.facemesh import NUM_LANDMARKS
from video_stream_segmenetation_tpu_torch.models.quantized import (
    ACT_SCALE,
    _conv_i8,
    _layer,
    _qconvbn,
    _quant_w,
    _requant,
)
from video_stream_segmenetation_tpu_torch.ops.detect import (
    blazeface_anchors,
    decode_anchor_boxes,
)
from video_stream_segmenetation_tpu_torch.parallel.mesh import resolve_device

IN_SCALE = 1.0 / 127.0  # the [0, 1] input lattice

# (layer, stride) in models/blazeface.py's order; f16 after ConvBN_6
_FF_TRUNK = (("ConvBN_0", 2), ("ConvBN_1", 2), ("ConvBN_2", 1), ("ConvBN_3", 2),
             ("ConvBN_4", 1), ("ConvBN_5", 2), ("ConvBN_6", 1), ("ConvBN_7", 2),
             ("ConvBN_8", 1))
# heads in call order: raw16, cls16, raw32, cls32
_FF_HEADS = ("Conv_0", "Conv_1", "Conv_2", "Conv_3")
# models/facemesh.py's order; ConvBN_8 is the 1x1 256-wide projection
_LMK_TRUNK = _FF_TRUNK


def _quant_input(x: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.clamp(x, 0.0, 1.0) * 127.0).to(torch.int8)


def _qhead(p: dict, name: str) -> dict:
    """A biased head conv -> int8 weights + the f32 epilogue."""
    wq, sw = _quant_w(np.asarray(p[name]["kernel"], np.float64))
    return {"wq": wq, "mult": (ACT_SCALE * sw).astype(np.float32),
            "bias": np.asarray(p[name]["bias"], np.float32)}


def _trunk(p: dict, st: dict, layers) -> dict:
    return {nm: _qconvbn(p, st, nm, IN_SCALE if i == 0 else ACT_SCALE)
            for i, (nm, _) in enumerate(layers)}


def quantize_face_finder(tree: dict) -> dict:
    """A float FaceFinder tree ``{"params", "batch_stats"}`` (numpy leaves)
    -> the int8 serving dict (per layer ``wq`` s8 HWIO, ``mult``, ``bias``
    f32)."""
    p, st = tree["params"], tree["batch_stats"]
    q = _trunk(p, st, _FF_TRUNK)
    for nm in _FF_HEADS:
        q[nm] = _qhead(p, nm)
    return q


def quantize_landmark_net(tree: dict) -> dict:
    """A float LandmarkNet tree -> the int8 serving dict, ``Dense_0`` float
    (``kernel``, ``bias`` f32)."""
    p, st = tree["params"], tree["batch_stats"]
    q = _trunk(p, st, _LMK_TRUNK)
    q["Dense_0"] = {"kernel": np.asarray(p["Dense_0"]["kernel"], np.float32),
                    "bias": np.asarray(p["Dense_0"]["bias"], np.float32)}
    return q


def _layers(q: dict, names, device) -> list:
    return [_layer(q[nm]["wq"], q[nm]["mult"], q[nm]["bias"], device) for nm in names]


class QuantizedFaceFinder(torch.nn.Module):
    """``[S, n, n, 3]`` f32 0..1 -> ``{"box_coords": [S, A, 16]``
    normalized, ``"box_scores": [S, A]}``, as models/blazeface.py::
    FaceFinder, with the convolutions in int8."""

    def __init__(self, q: dict, input_size: int = 256, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.input_size = input_size
        self.trunk = _layers(q, [nm for nm, _ in _FF_TRUNK], device)
        self.heads = _layers(q, _FF_HEADS, device)
        self.register_buffer("anchors", torch.as_tensor(
            np.array(blazeface_anchors(input_size)), device=device))

    def forward(self, x: torch.Tensor) -> dict:
        x = _quant_input(x)
        feats = []
        for (nm, stride), layer in zip(_FF_TRUNK, self.trunk):
            x = _requant(_conv_i8(x, layer, stride=stride))
            if nm in ("ConvBN_6", "ConvBN_8"):
                feats.append(x)
        s = x.shape[0]
        raws, logits = [], []
        for j, feat in enumerate(feats):
            raws.append(_conv_i8(feat, self.heads[2 * j]).reshape(s, -1, 16))
            logits.append(_conv_i8(feat, self.heads[2 * j + 1]).reshape(s, -1))
        raw = torch.cat(raws, dim=1)
        return {"box_coords": decode_anchor_boxes(raw, self.anchors, self.input_size),
                "box_scores": torch.sigmoid(torch.cat(logits, dim=1))}


class QuantizedLandmarkNet(torch.nn.Module):
    """``[S, n, n, 3]`` f32 0..1 -> ``{"landmarks": [S, 468, 3], "scores":
    [S]}``, as models/facemesh.py::LandmarkNet, with the trunk in int8
    and the pooled relu6-lattice features through the float Dense head."""

    def __init__(self, q: dict, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.trunk = _layers(q, [nm for nm, _ in _LMK_TRUNK], device)
        d = q["Dense_0"]
        self.register_buffer("dense_w", torch.as_tensor(
            np.asarray(d["kernel"], np.float32), device=device))
        self.register_buffer("dense_b", torch.as_tensor(
            np.asarray(d["bias"], np.float32), device=device))

    def forward(self, x: torch.Tensor) -> dict:
        x = _quant_input(x)
        for (_, stride), layer in zip(_LMK_TRUNK, self.trunk):
            x = _requant(_conv_i8(x, layer, stride=stride))
        pooled = x.to(torch.float32).mean(dim=(1, 2)) * ACT_SCALE
        out = pooled @ self.dense_w + self.dense_b
        lm = out[:, : NUM_LANDMARKS * 3].reshape(-1, NUM_LANDMARKS, 3)
        return {"landmarks": torch.cat([torch.sigmoid(lm[..., :2]), lm[..., 2:3]], dim=-1),
                "scores": torch.sigmoid(out[:, -1])}
