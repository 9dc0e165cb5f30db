"""The six presets of this slice at 720p with the trained weights, both
engines as they serve (the reference takes its CPU defaults: the unfused
refine chain and XLA paths where the port runs its kernels' plain
versions), held by their IoU against the committed frames' ground truth.
The reference's least IoU over the steps is the bar chip_smoke.py's serve
phases hold the card to (REFERENCE_IOU, within 0.02).  The int8 and
tracking presets are here; the recurrent and saliency ones in
tests/test_torch_zoo_720p_models.py, so that the tier-1 run's workers share
the load.

The ground truth is at the 288x512 mask grid (bridge.load_frames).  u2's
mask is 320x320: both engines' alphas are taken to 288x512 by the same
nearest taps (row (i * 320) // 288, column (j * 320) // 512) before they
are scored; the other presets score their 288x512 alpha directly.  The JAX
side is built with a ModelBundle of the restored checkpoints (no flax
init)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from video_stream_segmenetation_tpu import models as jm
from video_stream_segmenetation_tpu.runtime.pipeline import ModelBundle
from video_stream_segmenetation_tpu.runtime.presets import preset as jax_preset
from video_stream_segmenetation_tpu.service import Engine as JaxEngine
from video_stream_segmenetation_tpu.utils.checkpoint import restore_params
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu_torch import bridge

ROOT = Path(__file__).resolve().parents[1]
# 8 steps, as chip_smoke.py's serve phases run (the tracking and temporal
# presets settle over the steps)
IOU_S, IOU_T = 2, 8
# preset -> (matting checkpoint, face checkpoints)
CKPT = {
    "fast_int8_nano": ("mattenet_hd10_nano", ("facefinder", "landmarknet")),
    "fast_int8_femto": ("mattenet_hd10_femto", ("facefinder", "landmarknet")),
    "blaze_tracking": ("mattenet", ("facefinder_128", "landmarknet")),
    "branch": ("mattenet", ("facefinder", "landmarknet")),
    "rvm": ("rvm", ("facefinder", "landmarknet")),
    "u2": ("u2net", ("facefinder", "landmarknet")),
}
RUNS = ("fast_int8_nano", "fast_int8_femto", "blaze_tracking")
# branch: nothing in serving sets an affine with the face path off, so the
# even streams start with this 2-pixel shift (mask coordinates) and the
# max blend engages from the second step, as chip_smoke.py::PRIMED_AFFINE
# primes its branch phase
PRIMED_AFFINE = (1.0, 0.0, 2.0, 0.0, 1.0, -2.0)


def prime(e):
    """Give the even streams PRIMED_AFFINE (has_affine on)."""
    import dataclasses

    import torch

    even = np.arange(IOU_S) % 2 == 0
    if isinstance(e, JaxEngine):
        aff = np.array(e.state.affine)
        aff[even] = PRIMED_AFFINE
        e.state = dataclasses.replace(e.state, affine=jnp.asarray(aff),
                                      has_affine=jnp.asarray(even | np.array(e.state.has_affine)))
    else:
        e.state.affine[torch.as_tensor(even)] = torch.tensor(PRIMED_AFFINE)
        e.state.has_affine[torch.as_tensor(even)] = True


def _restored(name):
    return jax.tree_util.tree_map(jnp.asarray, restore_params(str(ROOT / "checkpoints" / name)))


def jax_engine(name):
    st = jax_preset(name)
    matting, (fd, lm) = CKPT[name]
    if st.matting_arch == "recurrent":
        model = jm.RecurrentMatteNet()
    elif st.matting_arch == "saliency":
        model = jm.SaliencyNet()
    elif st.matting_input == "native":
        model = jm.MatteNetHD(stem_stride=10, head_upsample=4, decoder=st.matting_decoder)
    else:
        model = jm.MatteNet()
    bundle = ModelBundle(model, _restored(matting), jm.FaceFinder(input_size=st.fd_size),
                         _restored(fd), jm.LandmarkNet(), _restored(lm))
    return JaxEngine(num_streams=IOU_S, statics=st, bundle=bundle, donate_state=False)


def to_truth_grid(alpha: np.ndarray) -> np.ndarray:
    """An alpha ``[S, h, w]`` on the ground truth's 288x512 grid by nearest
    taps (the identity at 288x512)."""
    h, w = alpha.shape[1:]
    iy = (np.arange(288) * h) // 288
    ix = (np.arange(512) * w) // 512
    return alpha[:, iy][:, :, ix]


def iou(alpha, truth):
    pred = to_truth_grid(alpha) > 0.5
    inter = (pred & truth).sum(axis=(1, 2))
    return float(np.mean(inter / np.maximum((pred | truth).sum(axis=(1, 2)), 1)))


def run_iou(name, record_property):
    """Both engines as they serve, the trained weights, the two committed
    720p frames swapped between S=2 streams each step, the wall-clock face
    gate off (branch: the even streams primed, :func:`prime`): the port's
    IoU within 0.01 of the reference's at every step; returns the
    reference's IoUs."""
    from video_stream_segmenetation_tpu_torch.runtime.presets import preset
    from video_stream_segmenetation_tpu_torch.service.engine import Engine

    frames, gt = bridge.load_frames()
    order = [np.arange(IOU_S) % 2, (np.arange(IOU_S) + 1) % 2]
    je = jax_engine(name)
    st = preset(name)
    te = Engine(IOU_S, st, **bridge.trained_weights(st), device="cpu")
    ious = []
    for t in range(IOU_T):
        truth = gt[order[t % 2]] > 127
        step = []
        for e in (je, te):
            e.face_min_interval_s = 0.0
            if t == 0:
                e.admit_all()
                if name == "branch":
                    prime(e)
            out = e.process(frames[order[t % 2]])
            step.append(iou(np.asarray(out["alpha"].float() if e is te else out["alpha"],
                                       np.float32), truth))
        print(f"[{name} trained, 720p, step {t}] IoU vs ground truth: reference "
              f"{step[0]:.4f}, port {step[1]:.4f}")
        ious.append(step)
        assert abs(step[0] - step[1]) < 0.01
    assert te.stats()["passthrough_steps"] == 0
    record_property("iou_reference", [r for r, _ in ious])
    record_property("iou_port", [p for _, p in ious])
    return [r for r, _ in ious]


@pytest.mark.parametrize("name", RUNS)
def test_trained_engine_iou_720p(name, record_property):
    """The trained nano and femto checkpoints find little of this person
    (the reference's own IoU about 0.21 and 0.10, as micro's 0.25,
    tests/test_torch_micro.py); the bar is the reference's, and the
    alpha is not empty."""
    assert min(run_iou(name, record_property)) > 0.05


def test_u2_truth_grid_is_one_nearest_resample():
    """The 320x320 alpha goes to 288x512 by one set of nearest taps, the
    same on both sides; a 288x512 alpha is left as it is."""
    a = np.random.default_rng(0).random((1, 320, 320), dtype=np.float32)
    b = to_truth_grid(a)
    assert b.shape == (1, 288, 512)
    np.testing.assert_array_equal(b[0, 287, 511], a[0, 318, 319])
    c = np.random.default_rng(1).random((1, 288, 512), dtype=np.float32)
    np.testing.assert_array_equal(to_truth_grid(c), c)
