"""The port's clip harness (utils/clips.py) against the reference's: the
synthetic clip for the same seed and geometry bit for bit, the parity
metrics on the same masks exactly, and a clip through the port's Engine."""

import numpy as np
import pytest

from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu.utils import clips as jclips
from video_stream_segmenetation_tpu_torch.runtime.config import PipelineStatics
from video_stream_segmenetation_tpu_torch.service.engine import Engine
from video_stream_segmenetation_tpu_torch.utils import clips


@pytest.mark.parametrize("n, hw, seed, motion", [(5, (48, 64), 0, 1.5), (3, (72, 128), 7, 0.5),
                                                 (4, (36, 64), 3, 3.0)])
def test_synthetic_clip_matches_the_reference(n, hw, seed, motion):
    got = clips.synthetic_clip(n_frames=n, hw=hw, seed=seed, motion=motion)
    want = jclips.synthetic_clip(n_frames=n, hw=hw, seed=seed, motion=motion)
    np.testing.assert_array_equal(got.frames, want.frames)
    np.testing.assert_array_equal(got.alpha, want.alpha)
    assert got.frames.dtype == np.uint8 and got.alpha.dtype == np.float32
    assert got.head_box is None
    assert (got.alpha[0] != got.alpha[-1]).any()


def test_metrics_match_the_reference():
    rng = np.random.default_rng(1)
    a = rng.random((6, 12, 16))
    b = np.clip(a + rng.normal(0, 0.2, a.shape), 0, 1)
    b[2] = 0.0
    np.testing.assert_array_equal(clips.mask_iou(a, b), jclips.mask_iou(a, b))
    np.testing.assert_array_equal(clips.mask_iou(b * 0, b * 0), jclips.mask_iou(b * 0, b * 0))
    assert clips.temporal_stability(a) == jclips.temporal_stability(a)
    assert clips.temporal_stability(a[:1]) == 1.0
    assert clips.parity_report(a, b) == jclips.parity_report(a, b)
    x = np.zeros((3, 8, 8))
    x[:, :4] = 1.0
    assert clips.mask_iou(x, np.roll(x, 2, axis=1))[0] == pytest.approx(2 / 6)


def test_reference_masks_roundtrip(tmp_path):
    masks = (np.random.default_rng(1).random((3, 16, 16)) > 0.5).astype(np.float32)
    p = tmp_path / "ref.npz"
    np.savez(p, masks=masks)
    np.testing.assert_array_equal(clips.load_reference_masks(str(p)), masks)
    np.testing.assert_array_equal(clips.load_reference_masks(str(p)),
                                  jclips.load_reference_masks(str(p)))


def test_engine_clip_integration():
    """A clip through one stream of the port's Engine (seeded weights, so
    no meaningful IoU): masks of the mask grid, finite, responding to the
    input."""
    statics = PipelineStatics(frame_hw=(48, 64), mask_hw=(32, 64), fd_size=64, lmk_size=48,
                              background="color", face_path=False)
    eng = Engine(2, statics, device="cpu")
    eng.admit_all()
    clip = clips.synthetic_clip(n_frames=4, hw=(48, 64))
    masks = clips.run_clip_through_engine(eng, clip, stream=1)
    assert masks.shape == (4, 32, 64) and masks.dtype == np.float32
    assert np.isfinite(masks).all() and masks.std() > 0
    assert clips.parity_report(masks, masks)["iou_mean"] == 1.0
    with pytest.raises(AssertionError, match="geometry"):
        clips.run_clip_through_engine(eng, clips.synthetic_clip(n_frames=1, hw=(40, 64)))
