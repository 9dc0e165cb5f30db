"""The reference application's MediaPipe face graphs, run with torch (port
of ``models/reference_face.py``).

The reference application ships its face models as ONNX files
(``MediaPipeFaceDetector.onnx``, ``MediaPipeFaceLandmarkDetector.onnx``);
copies of both are committed under ``weights/face_ref/``.
utils/onnx_lite.py parses them, initializers included, and
utils/onnx_exec.py::build_torch_fn runs them, the weights moved to the
device once, when the module is built.  Both modules take the K gathered
streams as one batch (the graphs were exported for batch 1; the executor
keeps the batch axis through their reshapes) and sit behind the face
path's model contract (runtime/pipeline.py::FaceModels):

* :class:`ReferenceFaceFinder`: ``[K, 256, 256, 3]`` f32 0..1 ->
  ``{"box_coords": [K, 896, 16]`` normalized corners and keypoints (the
  graph's SSD regressions decoded by ops/detect.py::decode_anchor_boxes
  over the 896-anchor grid), ``"box_scores": [K, 896]`` sigmoid``}``;
* :class:`ReferenceLandmarkNet`: ``[K, 192, 192, 3]`` f32 0..1 ->
  ``{"landmarks": [K, 468, 3]`` normalized, ``"scores": [K]}``.

The graphs run in f32: their convolutions go through ``F.conv2d`` (the
reference runs them as XLA convolutions, outside any Pallas kernel) under
runtime/precision.py::pinned, so TF32 never changes a detection.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from video_stream_segmenetation_tpu_torch.ops.detect import (
    blazeface_anchors,
    decode_anchor_boxes,
)
from video_stream_segmenetation_tpu_torch.parallel.mesh import resolve_device
from video_stream_segmenetation_tpu_torch.runtime.precision import pinned
from video_stream_segmenetation_tpu_torch.utils import onnx_exec, onnx_lite

FACE_REF_DIR = Path(__file__).resolve().parent.parent / "weights" / "face_ref"
DETECTOR_ONNX = "MediaPipeFaceDetector.onnx"
LANDMARK_ONNX = "MediaPipeFaceLandmarkDetector.onnx"


def load_graph(name: str, face_ref_dir=FACE_REF_DIR) -> onnx_lite.Model:
    """One of the committed graphs, parsed (nodes and initializers)."""
    return onnx_lite.load(str(Path(face_ref_dir) / name))


class _Graph(torch.nn.Module):
    """A graph of ``weights/face_ref/`` on ``device``: NHWC images in, the
    graph's outputs by name out."""

    input_size = 0

    def __init__(self, name: str, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self._fn, self._params = onnx_exec.build_torch_fn(load_graph(name), device=device)

    def run(self, x: torch.Tensor) -> dict:
        with pinned():
            return self._fn(self._params, image=x.to(torch.float32).permute(0, 3, 1, 2))


class ReferenceFaceFinder(_Graph):
    """The MediaPipe face detector behind the FaceFinder contract."""

    input_size = 256

    def __init__(self, device="cuda"):
        super().__init__(DETECTOR_ONNX, device)
        self.register_buffer("anchors", torch.as_tensor(
            np.array(blazeface_anchors(self.input_size)), device=device))

    def forward(self, x: torch.Tensor) -> dict:
        out = self.run(x)
        coords = decode_anchor_boxes(out["box_coords"], self.anchors, self.input_size)
        return {"box_coords": coords, "box_scores": torch.sigmoid(out["box_scores"][..., 0])}


class ReferenceLandmarkNet(_Graph):
    """The MediaPipe FaceMesh-468 behind the LandmarkNet contract (its
    score is a sigmoid in the graph already)."""

    input_size = 192

    def __init__(self, device="cuda"):
        super().__init__(LANDMARK_ONNX, device)

    def forward(self, x: torch.Tensor) -> dict:
        out = self.run(x)
        return {"landmarks": out["landmarks"], "scores": out["scores"]}
