"""The face path's sources by layout, the port's Engine against the JAX
Engine at 80x160 / mask 32x64, S=2, 8 steps (tests/test_torch_face_options.py's
runners and tolerances):

* s2d with ``face_input='frames'``: the packed frames of the gathered
  streams unpacked (the reference's ``_face_subpath_compact`` with
  ``s2d_block``), the letterbox and the ROI crop by gathers
  (``resize_impl='gather'``, ``crop_impl='gather'``);
* the natural layout with ``face_input='guide'``: the face path on the
  mask-resolution f32 resize (frame_hw := mask_hw), the ROI crop by
  interpolation products (``crop_impl='mxu'``);
* s2d with ``face_tracking='translation'``: the detector on every firing
  stream's guide, the centre's delta as an integer translation; the
  reference turns its planar u8 guide off there and feeds the refine
  kernel ``floor(small * 255 + 0.5)``, the port keeps the planar u8 guide
  of the same integers, so the teacher-forced refined alpha shows that
  the two agree.

Plus the face-source helpers (pipeline.py::face_image, face_f32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_natural_engines as NE
from tests.test_torch_face_options import assert_face_matches, assert_step_matches, run_s2d
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu import models as jm
from video_stream_segmenetation_tpu import ops
from video_stream_segmenetation_tpu_torch.models.modnet import init_mattenet_params
from video_stream_segmenetation_tpu_torch.runtime import pipeline as TPL

RUNS = {
    # (layout, overrides)
    "pico_frames_gather": ("s2d", {"face_input": "frames", "crop_impl": "gather",
                                   "resize_impl": "gather"}),
    "active_guide_mxu": ("natural", {"face_input": "guide", "crop_impl": "mxu"}),
    "pico_translation": ("s2d", {"face_tracking": "translation"}),
}


@pytest.fixture(scope="module", params=sorted(RUNS))
def engines(request):
    layout, over = RUNS[request.param]
    if layout == "natural":
        runs = NE.run_engines("active", over, jm.MatteNet(), init_mattenet_params(0),
                              NE.engine_frames())
    else:
        runs = run_s2d(over)
    return (request.param, layout, *runs)


def test_face_outputs_match(engines):
    name, layout, jouts, touts, _ = engines
    if layout == "natural":
        assert_face_matches(jouts, touts, tr=0.6, lin=3e-2)
    else:
        assert_face_matches(jouts, touts)
    if name == "pico_translation":
        # the centres moved and some step applied a whole-pixel translation
        assert any(np.asarray(j["state"]["has_center"]).any() for j in jouts)
        assert not any("face_prior_params" in j and np.asarray(j["face_has_prior"]).any()
                       for j in jouts)


@pytest.mark.parametrize("step", range(NE.ENGINE_T))
def test_step_matches_teacher_forced(engines, step):
    _, layout, jouts, _, forced = engines
    if layout == "natural":
        assert_step_matches(jouts[step], forced[step], 5e-3, 1e-3)
    else:
        assert_step_matches(jouts[step], forced[step], 4e-3, 1e-4)


def test_face_image_forms(rng):
    """face_image: packed frames unpacked, a planar guide made channel-last,
    natural images as they are; face_f32 divides u8 by 255 only."""
    frames = rng.integers(0, 256, (2, 20, 30, 3), dtype=np.uint8)
    packed = torch.tensor(np.asarray(ops.space_to_depth(jnp.asarray(frames), 10)))
    np.testing.assert_array_equal(TPL.face_image(packed, s2d_block=10).numpy(), frames)
    planar = torch.tensor(frames).permute(0, 3, 1, 2).contiguous()
    np.testing.assert_array_equal(TPL.face_image(planar, planar=True).numpy(), frames)
    f32 = torch.tensor(frames.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(TPL.face_f32(f32).numpy(), f32.numpy())
    np.testing.assert_array_equal(TPL.face_f32(torch.tensor(frames)).numpy(),
                                  frames.astype(np.float32) / np.float32(255.0))
