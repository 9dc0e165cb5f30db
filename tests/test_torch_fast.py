"""The ``fast`` preset in the port against the JAX package on the CPU: the
float plan-A MatteNetHD (stem stride 5, the reference's ``MatteNetHD()``)
over natural frames, ``resize_nearest``'s u8 guide, the Engine over 8 steps
at 80x160 (stem 16x32, mask 32x64, fd 64, lmk 48), the trained export in
both packages, and the 720p IoU bar chip_smoke.py holds the card to.

Tolerances, with their reasons:
* plan A runs in bf16, and PyTorch and XLA round the convolutions' and the
  SE's partial sums at other places (tests/test_torch_active.py): the
  seeded net's alpha within 2e-3 of the reference's jitted forward, its
  semantic within 2e-3 and detail logits within 2e-2 (unbounded logits,
  a few bf16 steps); the trained net sits on knife edges: on these frames
  the reference's own op-by-op forward departs from its jitted one by a
  mean of 1.03e-3, a 99th percentile of 1.71e-2 and 0.07 % of the pixels
  of alpha > 0.5, so the port's alpha is held to about twice that (mean
  2e-3, 99th percentile 3.5e-2, 0.2 % of the mask);
* ``resize_nearest``: gathers, bit for bit;
* the Engine (seeded plan A, the trained face models): the face decisions
  as tests/test_torch_active.py holds them; teacher-forced, the alpha
  within 5e-3, new_prev within 1e-3, the frame within one u8 step (the
  composite's bf16 pass against the CPU reference's f32);
* 720p, trained weights, both engines as they serve: the port's IoU
  against the committed frames' ground truth within 0.01 of the
  reference's at every step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_natural_engines as NE
from tests.test_torch_zoo_720p import iou
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu import models, ops
from video_stream_segmenetation_tpu.runtime.pipeline import ModelBundle
from video_stream_segmenetation_tpu.runtime.presets import preset as jax_preset
from video_stream_segmenetation_tpu.service import Engine as JaxEngine
from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import MatteNetHD, init_params
from video_stream_segmenetation_tpu_torch.ops import resize as TRS
from video_stream_segmenetation_tpu_torch.runtime.presets import preset
from video_stream_segmenetation_tpu_torch.service.engine import Engine

T = torch.tensor


@pytest.fixture(scope="module")
def trees():
    return {"seeded": init_params("full", 0, 5),
            "trained": bridge.load_export(bridge.WEIGHTS_DIR / "mattenet_hd.npz")}


@pytest.fixture(scope="module")
def people():
    """Two rendered people at 80x160, u8 (the engine's first frames)."""
    return NE.engine_frames()[0]


def test_plan_a_tree_has_the_flax_names_and_shapes(trees):
    """The seeded tree and the trained export have the flax init's tree."""
    flax_tree = jax.eval_shape(lambda: models.MatteNetHD().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 80, 160, 3))))
    shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), t)  # noqa: E731
    assert shapes(dict(flax_tree)) == shapes(trees["seeded"]) == shapes(trees["trained"])


@pytest.mark.parametrize("which", ["seeded", "trained"])
def test_plan_a_forward_matches(trees, people, which):
    """u8 frames in (the /255 in bf16, as the reference divides), alpha
    [S, 32, 64] = 2x the 16x32 stem grid, semantic at /8 of it, detail at
    /2."""
    tree = trees[which]
    jm = models.MatteNetHD()
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    jit = jax.jit(lambda p, x: jm.apply(p, x))(jt, jnp.asarray(people))
    got = MatteNetHD(5, 2, "full", params=tree, device="cpu")(T(people))
    shapes = {"alpha": (2, 32, 64), "semantic": (2, 2, 4), "detail": (2, 8, 16)}
    for k, shape in shapes.items():
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == shape, k
    a, want = got["alpha"].detach().numpy(), np.asarray(jit["alpha"])
    if which == "seeded":
        assert np.abs(a - want).max() <= 2e-3
        np.testing.assert_allclose(got["semantic"].detach().numpy(),
                                   np.asarray(jit["semantic"]), rtol=0, atol=2e-3)
        np.testing.assert_allclose(got["detail"].detach().numpy(), np.asarray(jit["detail"]),
                                   rtol=0, atol=2e-2)
        return
    gap = np.abs(a - want)
    assert gap.mean() <= 2e-3 and np.quantile(gap, 0.99) <= 3.5e-2
    assert ((a > 0.5) != (want > 0.5)).mean() <= 2e-3


def test_plan_a_head_upsample_is_two():
    with pytest.raises(ValueError, match="head_upsample 2"):
        MatteNetHD(5, 4, "full", device="cpu")


@pytest.mark.parametrize("in_hw,out_hw,method", [
    ((720, 1280), (288, 512), "half_pixel"), ((80, 160), (32, 64), "half_pixel"),
    ((80, 160), (33, 50), "asymmetric"), ((30, 40), (61, 90), "half_pixel")])
def test_resize_nearest_matches_bit_for_bit(rng, in_hw, out_hw, method):
    """u8 frames (the guide) and an f32 plane: the same taps, exactly."""
    f = rng.integers(0, 256, (2, *in_hw, 3), dtype=np.uint8)
    got = TRS.resize_nearest(T(f), out_hw, method)
    assert got.dtype == torch.uint8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        ops.resize_nearest(jnp.asarray(f), out_hw, method=method)))
    p = rng.random((2, *in_hw), dtype=np.float32)
    np.testing.assert_array_equal(
        TRS.resize_nearest(T(p), out_hw, method, channel_last=False).numpy(),
        np.asarray(ops.resize_nearest(jnp.asarray(p), out_hw, method=method,
                                      channel_last=False)))


# ---- the Engine -------------------------------------------------------------


@pytest.fixture(scope="module")
def engines(trees):
    return NE.run_engines("fast", {}, models.MatteNetHD(), trees["seeded"],
                          NE.engine_frames())


def test_engine_face_decisions_match(engines):
    jouts, touts, _ = engines
    NE.assert_face_decisions_match(jouts, touts)
    # the analytic prior's scalars ride the outputs, as in the reference
    assert "face_prior_params" in touts[0]


@pytest.mark.parametrize("step", range(NE.ENGINE_T))
def test_engine_step_matches(engines, step):
    """Teacher-forced: the alpha within 5e-3, new_prev within 1e-3, the
    frame within one u8 step."""
    jouts, _, forced = engines
    j, g = jouts[step], forced[step]
    assert g["alpha"].dtype == torch.float32 and g["frame"].dtype == torch.uint8
    np.testing.assert_allclose(g["alpha"].numpy(), np.asarray(j["alpha"], np.float32),
                               rtol=0, atol=5e-3)
    np.testing.assert_allclose(g["state"]["prev_alpha"], j["state"]["prev_alpha"],
                               rtol=0, atol=1e-3)
    diff = np.abs(g["frame"].numpy().astype(np.int32) - np.asarray(j["frame"]).astype(np.int32))
    assert diff.max() <= 1


def test_engine_builds_plan_a_over_the_stem_grid():
    """The model is the plan-A MatteNetHD; the mask must be 2x the stem
    grid ceil(frame / 5), as the reference's error says."""
    e = Engine(1, preset("fast", face_path=False, frame_hw=(80, 160), mask_hw=(32, 64)),
               device="cpu")
    assert isinstance(e.model, MatteNetHD) and e.model.plan_a
    with pytest.raises(ValueError, match="integer multiple of the stem grid"):
        Engine(1, preset("fast", face_path=False, frame_hw=(80, 160), mask_hw=(30, 64)),
               device="cpu")


# ---- the trained weights at 720p --------------------------------------------


def test_trained_engine_iou_720p(record_property):
    """Both engines as they serve (the reference off the TPU: the unfused
    refine chain), the trained mattenet_hd and face models, the two
    committed frames swapped between S=2 streams for 8 steps: the port's
    IoU within 0.01 of the reference's at every step; the reference's
    least is chip_smoke.py's bar (REFERENCE_IOU['fast'])."""
    frames, gt = bridge.load_frames()
    st = preset("fast")
    w = bridge.trained_weights(st)
    jt = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    bundle = ModelBundle(models.MatteNetHD(), jt(w["params"]), models.FaceFinder(),
                         jt(w["face_params"]["face"]), models.LandmarkNet(),
                         jt(w["face_params"]["lmk"]))
    je = JaxEngine(num_streams=2, statics=jax_preset("fast"), bundle=bundle,
                   donate_state=False)
    te = Engine(2, st, **w, device="cpu")
    order = [np.arange(2) % 2, (np.arange(2) + 1) % 2]
    ious = []
    for t in range(8):
        truth = gt[order[t % 2]] > 127
        step = []
        for e in (je, te):
            e.face_min_interval_s = 0.0
            if t == 0:
                e.admit_all()
            out = e.process(frames[order[t % 2]])
            step.append(iou(np.asarray(out["alpha"], np.float32), truth))
        print(f"[fast trained, 720p, step {t}] IoU vs ground truth: reference "
              f"{step[0]:.4f}, port {step[1]:.4f}")
        ious.append(step)
        assert abs(step[0] - step[1]) < 0.01
    assert te.stats()["passthrough_steps"] == 0
    record_property("iou_reference", [r for r, _ in ious])
    record_property("iou_port", [p for _, p in ious])
