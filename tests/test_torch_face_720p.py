"""The face subpath's new forms at 720p with the trained weights, both
engines as they serve (the reference takes its CPU defaults: the unfused
refine chain), held by their IoU against the committed frames' ground
truth over 8 steps, S=2: ``fast_int8_pico_refface`` (the MediaPipe
graphs) and ``fast_int8_pico`` with ``face_precision='int8'`` here;
``face_compact=False`` and ``face_tracking='translation'`` in
tests/test_torch_face_options_720p.py, so that the tier-1 run's workers
share the load.  The reference's least IoU over the steps is the bar
chip_smoke.py's serve phases hold the card to (REFERENCE_IOU, within
0.02).

The port runs twice: on the reference's route (``use_fused_refine=
False``, which the reference's 'auto' resolves to off a TPU), where its
IoU is within 0.01 of the reference's at every step and the face
decisions (face_applied, face_has_prior) are equal; and as it serves
(the fused temporal refine), held to the bar as the card is.  The two
routes part where a landmark affine is applied: with face_precision=
'int8' the fused route's IoU at step 5 is 0.9329 and the chain's 0.8868
(the reference's chain 0.8868 as well); the reference's fused route is
not run at 720p here (its Pallas kernels in interpret mode), and at
80x160 the port's fused route equals it (tests/test_torch_refface.py).
ROADMAP's watch list keeps it."""

import numpy as np
import pytest

from tests.test_torch_zoo_720p import IOU_S, IOU_T, _restored, iou
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu import models as jm
from video_stream_segmenetation_tpu.runtime.pipeline import ModelBundle
from video_stream_segmenetation_tpu.runtime.presets import preset as jax_preset
from video_stream_segmenetation_tpu.service import Engine as JaxEngine
from video_stream_segmenetation_tpu_torch import bridge

RUNS = {
    "fast_int8_pico_refface": ("fast_int8_pico_refface", {}),
    "fast_int8_pico_int8_face": ("fast_int8_pico", {"face_precision": "int8"}),
}


def run_face_iou(name: str, over: dict, record_property):
    """Both engines over the two committed frames, swapped between the
    streams each step, the wall-clock face gate off; returns the
    reference's IoUs and the steps' face decisions (applied, has_prior)."""
    from video_stream_segmenetation_tpu_torch.runtime.presets import preset
    from video_stream_segmenetation_tpu_torch.service.engine import Engine

    # debug_face_outputs: the plane routes export face_has_prior too
    jst = jax_preset(name, debug_face_outputs=True, **over)
    fd, lm = (("facefinder", "landmarknet") if jst.fd_size == 256
              else ("facefinder_128", "landmarknet_128"))
    bundle = ModelBundle(jm.MatteNetHD(stem_stride=10, head_upsample=4,
                                       decoder=jst.matting_decoder),
                         _restored(bridge.EXPORTS[jst.matting_decoder]),
                         jm.FaceFinder(input_size=jst.fd_size), _restored(fd),
                         jm.LandmarkNet(), _restored(lm))
    je = JaxEngine(num_streams=IOU_S, statics=jst, bundle=bundle, donate_state=False)
    st = preset(name, use_fused_refine=False, **over)
    te = Engine(IOU_S, st, **bridge.trained_weights(st), device="cpu")
    served = Engine(IOU_S, preset(name, **over), **bridge.trained_weights(st), device="cpu")
    frames, gt = bridge.load_frames()
    order = [np.arange(IOU_S) % 2, (np.arange(IOU_S) + 1) % 2]
    ious, decisions, served_ious = [], [], []
    for t in range(IOU_T):
        truth = gt[order[t % 2]] > 127
        step, dec = [], []
        for e in (je, te, served):
            e.face_min_interval_s = 0.0
            if t == 0:
                e.admit_all()
            last = np.array(e._last_face_at)
            out = e.process(frames[order[t % 2]])
            alpha = out["alpha"] if e is je else out["alpha"].float()
            step.append(iou(np.asarray(alpha, np.float32), truth))
            dec.append((np.array(e._last_face_at) != last, np.asarray(out["face_has_prior"])))
        print(f"[{name} {over} trained, 720p, step {t}] IoU vs ground truth: reference "
              f"{step[0]:.4f}, port {step[1]:.4f}, port as it serves {step[2]:.4f}")
        served_ious.append(step.pop())
        ious.append(step)
        for k in range(2):
            np.testing.assert_array_equal(dec[1][k], dec[0][k], err_msg=f"step {t}")
        decisions.append(dec[0])
        assert abs(step[0] - step[1]) < 0.01
    assert te.stats()["passthrough_steps"] == 0 and served.stats()["passthrough_steps"] == 0
    assert min(served_ious) >= min(r for r, _ in ious) - 0.02
    record_property("iou_served", served_ious)
    record_property("iou_reference", [r for r, _ in ious])
    record_property("iou_port", [p for _, p in ious])
    return [r for r, _ in ious], decisions


@pytest.mark.parametrize("run", sorted(RUNS))
def test_trained_engine_iou_720p(run, record_property):
    """The MediaPipe detector finds the committed person in stream 0's
    frame (score 0.617, clear of the 0.6 threshold by more than the f32
    graphs' differences) and the landmark graph rejects it (score 1e-5,
    the synthetic face is no face to it): the prior is applied, the affine
    never, on both sides.  The int8 face models apply the affine."""
    name, over = RUNS[run]
    ious, decisions = run_face_iou(name, over, record_property)
    assert min(ious) > 0.5
    applied = np.stack([a for a, _ in decisions])
    has_prior = np.stack([p for _, p in decisions])
    assert has_prior.any()
    assert applied.any() == (run != "fast_int8_pico_refface")
