"""parity_check.py on the CPU against the reference's composition of the same
steps (tools/parity_check.py, written out here with the JAX package's
Engine, utils/clips.py and ops/resize.py; the tool itself is not imported:
its imports set JAX's global config), the trained MatteNet carried across by
bridge.py (weights/mattenet.npz, the export of checkpoints/mattenet).

Bars, with their reasons:
* the served masks' mean IoU against the reference masks within 0.02 of
  the reference engine's (the bar of tests/test_torch_gates.py: the trained
  MatteNet sits on bf16 knife edges, so the engines are held by IoU);
* onnx_reference_masks against build_jax_fn and the reference's resize:
  within 1e-5 (f32 convolution sums in another order);
* the refusals: argparse's exit.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_onnx_port import _attr, _mk_model
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu import models as JM
from video_stream_segmenetation_tpu import ops as JO
from video_stream_segmenetation_tpu import runtime as JR
from video_stream_segmenetation_tpu import utils as JU
from video_stream_segmenetation_tpu.runtime.pipeline import ModelBundle
from video_stream_segmenetation_tpu.service import Engine as JaxEngine
from video_stream_segmenetation_tpu.utils import onnx_exec as JE
from video_stream_segmenetation_tpu.utils import onnx_lite as JL
from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch import parity_check as PC

HW, T = (80, 160), 6
MATTENET = bridge.WEIGHTS_DIR / "mattenet.npz"
IOU_TOL = 0.02


def reference_report(frames, ref_masks) -> dict:
    """tools/parity_check.py's steps for a clip off 720p: the default
    statics at the tool's mask, the trained MatteNet, one stream, the masks
    against the reference masks resized half-pixel."""
    fh, fw = frames.shape[1:3]
    mh, mw = max(32, (fh * 2 // 5) // 8 * 8), max(64, (fw * 2 // 5) // 16 * 16)
    statics = JR.PipelineStatics(frame_hw=(fh, fw), mask_hw=(mh, mw), fd_size=128,
                                 lmk_size=96, background="color", face_path=False)
    tree = jax.tree_util.tree_map(jnp.asarray, bridge.load_export(MATTENET))
    eng = JaxEngine(num_streams=1, statics=statics, bundle=ModelBundle(JM.MatteNet(), tree),
                    donate_state=False)
    eng.admit()
    masks = JU.run_clip_through_engine(eng, JU.SyntheticClip(
        frames=frames, alpha=np.zeros(frames.shape[:3], np.float32)))
    ref_small = np.asarray(JO.resize_bilinear(jnp.asarray(ref_masks.astype(np.float32)),
                                              (mh, mw), method="half_pixel",
                                              channel_last=False))
    return JU.parity_report(masks, ref_small)


def port_report(tmp_path, args) -> tuple[int, dict]:
    rep = tmp_path / "report.json"
    code = PC.main([*args, "--checkpoint", str(MATTENET), "--device", "cpu",
                    "--report", str(rep)])
    return code, json.loads(rep.read_text())


@pytest.fixture(scope="module")
def clip():
    c = JU.synthetic_clip(n_frames=T, hw=HW, seed=3)
    return c.frames, c.alpha


@pytest.fixture(scope="module")
def reference(clip):
    return reference_report(*clip)


def _held(got, want):
    assert got["frames"] == want["frames"]
    assert abs(got["iou_mean"] - want["iou_mean"]) <= IOU_TOL
    assert got["target_iou"] == 0.99
    assert got["passes_target"] == (got["iou_mean"] >= 0.99)


def test_npz_clip_against_the_reference(tmp_path, clip, reference):
    frames, alpha = clip
    path = tmp_path / "clip.npz"
    np.savez(path, frames=frames, masks=alpha)
    code, got = port_report(tmp_path, ["--clip", str(path), "--save-masks",
                                       str(tmp_path / "served.npz")])
    _held(got, reference)
    assert code == (0 if got["passes_target"] else 1)
    with np.load(tmp_path / "served.npz") as z:
        assert z["masks"].shape == (T, 32, 64)
    # the served masks as --ref: the port against itself, every frame equal
    code, again = port_report(tmp_path, ["--clip", str(path), "--ref",
                                         str(tmp_path / "served.npz")])
    assert code == 0 and again["iou_min"] == 1.0


def test_image_directories_against_the_reference(tmp_path, clip):
    frames, alpha = clip
    (tmp_path / "frames").mkdir()
    (tmp_path / "masks").mkdir()
    for t in range(T):
        Image.fromarray(frames[t]).save(tmp_path / "frames" / f"{t:03d}.png")
        Image.fromarray(np.round(alpha[t] * 255).astype(np.uint8)).save(
            tmp_path / "masks" / f"{t:03d}.png")
    masks = np.stack([np.asarray(Image.open(tmp_path / "masks" / f"{t:03d}.png").convert("L"),
                                 np.float32) / 255.0 for t in range(T)])
    _, got = port_report(tmp_path, ["--clip", str(tmp_path / "frames"),
                                    "--ref", str(tmp_path / "masks")])
    _held(got, reference_report(frames, masks))


def test_synthetic_against_the_reference(tmp_path):
    c = JU.synthetic_clip(n_frames=T, hw=(240, 320), seed=1)
    _, got = port_report(tmp_path, ["--synthetic", "--frames", str(T)])
    _held(got, reference_report(c.frames, c.alpha))


def test_the_serving_geometry_takes_the_production_preset():
    st = PC.statics_of((720, 1280))
    assert (st.frame_layout, st.matting_precision, st.matting_decoder) == ("s2d", "int8", "pico")
    assert (st.mask_hw, st.background, st.face_path, st.fd_size, st.lmk_size) == (
        (288, 512), "color", False, 64, 48)
    assert PC.statics_of((720, 1280), synthetic=True).frame_layout == "natural"
    assert PC.mask_hw_of((240, 320)) == (96, 128)


def test_onnx_reference_masks_match_the_reference(rng):
    """A Conv + Sigmoid matting graph built in memory: the port's masks
    against build_jax_fn over the reference's asymmetric resize."""
    w = (rng.random((1, 3, 3, 3), np.float32) - 0.5)
    nodes = [JL.Node(op_type="Conv", inputs=["input", "w", "b"], outputs=["logit"],
                     attrs=_attr(pads=[1, 1, 1, 1]), name="conv"),
             JL.Node(op_type="Sigmoid", inputs=["logit"], outputs=["mask"], attrs={},
                     name="sig")]
    model = _mk_model(nodes, {"w": w, "b": np.asarray([0.1], np.float32)},
                      [("input", (1, 3, 24, 40))], ["mask"])
    frames = rng.integers(0, 256, (3, 60, 100, 3), dtype=np.uint8)
    got = PC.onnx_reference_masks(model, frames, (24, 40), "cpu")
    fn, params = JE.build_jax_fn(model)
    want = []
    for fr in frames:
        x = JO.resize_bilinear(jnp.asarray(fr, jnp.float32)[None] / 255.0, (24, 40),
                               method="asymmetric")
        want.append(np.asarray(fn(params, input=jnp.transpose(x, (0, 3, 1, 2)))["mask"])[0, 0])
    assert got.shape == (3, 24, 40) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.stack(want), rtol=0, atol=1e-5)


def test_onnx_reference_masks_refuse_a_graph_without_a_mask(rng):
    node = JL.Node(op_type="Relu", inputs=["input"], outputs=["y"], attrs={}, name="relu")
    model = _mk_model([node], {}, [("input", (1, 3, 8, 8))], ["y"])
    with pytest.raises(ValueError, match="mask"):
        PC.onnx_reference_masks(model, rng.integers(0, 256, (1, 16, 16, 3), dtype=np.uint8),
                                (8, 8), "cpu")


def test_refusals(tmp_path, clip):
    with pytest.raises(SystemExit):
        PC.main(["--device", "cpu"])  # no clip
    path = tmp_path / "frames_only.npz"
    np.savez(path, frames=clip[0])
    with pytest.raises(SystemExit):
        PC.main(["--clip", str(path), "--device", "cpu"])  # no reference masks


def test_the_card_is_the_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        PC.main(["--synthetic", "--frames", "2"])
