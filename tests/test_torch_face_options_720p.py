"""``fast_int8_pico`` with ``face_compact=False`` and with
``face_tracking='translation'`` at 720p with the trained weights, both
engines as they serve, 8 steps, S=2 (tests/test_torch_face_720p.py's runner
and bars: the reference's least IoU is chip_smoke.py's REFERENCE_IOU, the
port within 0.01 of it at every step, the face decisions equal)."""

import pytest

from tests.test_torch_face_720p import run_face_iou
from tests.torch_threads import one_torch_thread  # noqa: F401

RUNS = {
    "fast_int8_pico_uncompacted": {"face_compact": False},
    "fast_int8_pico_translation": {"face_tracking": "translation"},
}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_trained_engine_iou_720p(run, record_property):
    ious, decisions = run_face_iou("fast_int8_pico", RUNS[run], record_property)
    assert min(ious) > 0.5
    assert any(a.any() for a, _ in decisions)
