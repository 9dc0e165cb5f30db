"""``active`` at 720p with the trained weights (mattenet, facefinder,
landmarknet at 256/192): the port's Engine and the JAX Engine, both as they
serve, held by their IoU against the committed frames' ground truth over 8
steps, on the separable-warp route (the analytic prior; the plane prior and
the composite routes give the same alpha) and on the exact-warp route.
The reference's least IoU is the bar chip_smoke.py holds the card to
(REFERENCE_IOU).  (Apart from tests/test_torch_active.py so that the
tier-1 run's workers share the load.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu import models
from video_stream_segmenetation_tpu.runtime.pipeline import ModelBundle
from video_stream_segmenetation_tpu_torch import bridge

IOU_S, IOU_T = 2, 8
ROUTES = {"active": {}, "active_exact_warp": {"warp_impl": "exact"}}


def _iou(alpha, truth):
    pred = alpha > 0.5
    inter = (pred & truth).sum(axis=(1, 2))
    return float(np.mean(inter / np.maximum((pred | truth).sum(axis=(1, 2)), 1)))


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_trained_engine_iou_720p(route, record_property):
    """Both engines free-running (the reference takes its CPU defaults, the
    XLA chain and composite), the committed frames swapped between S=2
    streams each step, the wall-clock face gate off: the port's IoU within
    0.01 of the reference's at every step.  The bf16 MatteNet sits on knife
    edges at 720p (the reference's own jitted and op-by-op forwards give
    an alpha IoU of 0.99 against each other on these frames), so this is
    held by IoU, not element by element."""
    from video_stream_segmenetation_tpu.runtime.presets import preset as jax_preset
    from video_stream_segmenetation_tpu.service import Engine as JaxEngine
    from video_stream_segmenetation_tpu_torch.runtime.presets import preset
    from video_stream_segmenetation_tpu_torch.service.engine import Engine

    over = ROUTES[route]
    st = preset("active", **over)
    w = bridge.trained_weights(st)
    jt = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    bundle = ModelBundle(models.MatteNet(), jt(w["params"]),
                         models.FaceFinder(input_size=st.fd_size), jt(w["face_params"]["face"]),
                         models.LandmarkNet(), jt(w["face_params"]["lmk"]))
    je = JaxEngine(num_streams=IOU_S, statics=jax_preset("active", **over), bundle=bundle,
                   donate_state=False)
    te = Engine(IOU_S, st, **w, device="cpu")
    frames, gt = bridge.load_frames()
    order = [np.arange(IOU_S) % 2, (np.arange(IOU_S) + 1) % 2]
    ious, applied = [], 0
    for t in range(IOU_T):
        truth = gt[order[t % 2]] > 127
        step = []
        for e in (je, te):
            e.face_min_interval_s = 0.0
            if t == 0:
                e.admit_all()
            out = e.process(frames[order[t % 2]])
            step.append(_iou(np.asarray(out["alpha"], np.float32), truth))
        applied += int(te.state.has_affine.sum())
        print(f"[{route} trained, 720p, step {t}] IoU vs ground truth: reference "
              f"{step[0]:.4f}, port {step[1]:.4f}")
        ious.append(step)
        assert abs(step[0] - step[1]) < 0.01
    record_property("iou_reference", [r for r, _ in ious])
    record_property("iou_port", [p for _, p in ious])
    assert min(r for r, _ in ious) > 0.5
    assert applied > 0  # the face path moved the warp
