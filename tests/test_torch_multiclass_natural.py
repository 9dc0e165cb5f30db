"""The natural layout's ``multiclass`` preset (BASELINE config 5) in the port
against the JAX package on the CPU: the K=4 MatteNet, ``multiclass_composite``
for each effect, the Engine over 8 steps at 80x160 (mask 32x64), and the
trained ``mattenet_multiclass`` at 720p by the foreground IoU bar
chip_smoke.py holds the card to.

Tolerances, with their reasons:
* the K-class MatteNet runs in bf16 (tests/test_torch_active.py's
  reasons): the seeded net's softmax maps within 2e-3 of the reference's;
  the trained net sits on knife edges (a bf16 rounding moves a map by up
  to 1.3e-2 on these frames), so its maps are held by their mean
  difference (1e-3), its 99th percentile (6e-3) and the pixels whose
  most likely class differs (0.2 %);
* ``multiclass_composite``: the same f32 operations (the upsample's
  interpolation products, the separable blur), summed in another order:
  the f32 result within 2e-6, the u8 result within one step on under 1 %
  of values;
* the Engine, seeded weights: class_alpha and alpha within 2e-3 (the bf16
  model's differences, through the simplex EMA), the frame within one u8
  step on all but 1 % of values and two at most;
* 720p, trained weights, both engines as they serve: the foreground
  IoU within 0.01 of the reference's at every step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_natural_engines as NE
from tests.test_torch_multiclass import foreground_iou
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu import models, ops
from video_stream_segmenetation_tpu.runtime.pipeline import ModelBundle
from video_stream_segmenetation_tpu.runtime.presets import preset as jax_preset
from video_stream_segmenetation_tpu.service import Engine as JaxEngine
from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.models.modnet import MatteNet, init_mattenet_params
from video_stream_segmenetation_tpu_torch.ops.composite import multiclass_composite
from video_stream_segmenetation_tpu_torch.runtime.presets import preset
from video_stream_segmenetation_tpu_torch.service.engine import Engine

T = torch.tensor
K = 4
GEOM = dict(frame_hw=(80, 160), mask_hw=(32, 64))


def _jt(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def trees():
    return {"seeded": init_mattenet_params(0, K),
            "trained": bridge.load_export(bridge.WEIGHTS_DIR / "mattenet_multiclass.npz")}


def test_k_class_tree_has_the_flax_names_and_shapes(trees):
    flax_tree = jax.eval_shape(lambda: models.MatteNet(num_classes=K).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 64, 3))))
    shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), t)  # noqa: E731
    assert shapes(dict(flax_tree)) == shapes(trees["seeded"]) == shapes(trees["trained"])


@pytest.mark.parametrize("which", ["seeded", "trained"])
def test_k_class_mattenet_matches(trees, which):
    """Rendered people resized to the mask: softmax maps [S, 32, 64, 4] on
    the simplex."""
    f = NE.engine_frames()[0]
    small = np.asarray(ops.resize_bilinear(jnp.asarray(f, jnp.float32) / 255.0, (32, 64),
                                           method="asymmetric"))
    jm = models.MatteNet(num_classes=K)
    jt = _jt(trees[which])
    jit = np.asarray(jax.jit(lambda p, x: jm.apply(p, x)["alpha"])(jt, jnp.asarray(small)))
    model = MatteNet(trees[which])
    got = model(T(small))["alpha"].numpy()
    assert model.num_classes == K and got.shape == (2, 32, 64, K) and got.dtype == np.float32
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=0, atol=1e-5)
    gap = np.abs(got - jit)
    if which == "seeded":
        assert gap.max() <= 2e-3
        return
    assert gap.mean() <= 1e-3 and np.quantile(gap, 0.99) <= 6e-3
    assert (got.argmax(-1) != jit.argmax(-1)).mean() <= 2e-3


EFFECTS = {
    "keep": {"keep": True},
    "color": {"color": (0.1, 0.8, 0.3)},
    "blur": {"blur": 3.0},
    "tint": {"tint": (0.9, 0.2, 0.2), "strength": 0.4},
}


@pytest.mark.parametrize("effect", sorted(EFFECTS) + ["all"])
@pytest.mark.parametrize("maps_hw", [(32, 64), (80, 160)])
def test_multiclass_composite_matches_reference(rng, effect, maps_hw):
    """One effect on class 2 (keep, a colour, the blur, the tint; the rest
    kept or blurred) or all four, maps at the mask (upsampled, clipped and
    renormalised) or at the frame."""
    effects = ([{"blur": 8.0}, {"keep": True}, EFFECTS[effect], {"keep": True}]
               if effect != "all" else [EFFECTS[n] for n in ("blur", "keep", "tint", "color")])
    frames = rng.random((2, 80, 160, 3), dtype=np.float32)
    a = rng.random((2, *maps_hw, K)).astype(np.float32) + 0.05
    a /= a.sum(-1, keepdims=True)
    for out_u8 in (False, True):
        want = np.asarray(ops.multiclass_composite(jnp.asarray(frames), jnp.asarray(a), effects,
                                                   out_u8=out_u8))
        got = multiclass_composite(T(frames), T(a), effects, out_u8=out_u8).numpy()
        assert got.shape == want.shape == frames.shape and got.dtype == want.dtype
        if out_u8:
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 0.01
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    with pytest.raises(ValueError, match="effects"):
        multiclass_composite(T(frames), T(a), effects[:3])


# ---- the Engine -------------------------------------------------------------

STEPS = 8


def _ellipse_frames(t):
    """A bright ellipse moving over noise, per stream (tests/test_torch_
    multiclass.py's frames)."""
    rng = np.random.default_rng(100 + t)
    f = (rng.random((2, 80, 160, 3)) * 120).astype(np.uint8)
    yy, xx = np.mgrid[0:80, 0:160]
    for s in range(2):
        cx, cy = 50 + 9 * t + 20 * s, 40 + 2 * t
        f[s][((xx - cx) / 28.0) ** 2 + ((yy - cy) / 30.0) ** 2 <= 1.0] = (220, 190, 170)
    return f


def _bundle(matte, face_p, lmk_p):
    return ModelBundle(models.MatteNet(num_classes=K), _jt(matte), models.FaceFinder(),
                       _jt(face_p), models.LandmarkNet(), _jt(lmk_p))


@pytest.fixture(scope="module")
def engines(trees):
    """The preset as it stands (face_path=True, which the multi-class step
    never reads, as in the reference: both engines build face models and
    apply none), seeded K=4 MatteNet; stream 1's EMA knob moved."""
    faces = {n: bridge.load_export(bridge.WEIGHTS_DIR / f"{n}.npz")
             for n in ("facefinder", "landmarknet")}
    je = JaxEngine(num_streams=2, statics=jax_preset("multiclass", **GEOM),
                   bundle=_bundle(trees["seeded"], faces["facefinder"], faces["landmarknet"]),
                   donate_state=False)
    te = Engine(2, preset("multiclass", **GEOM), params=trees["seeded"],
                face_params={"face": faces["facefinder"], "lmk": faces["landmarknet"]},
                device="cpu")
    outs = []
    for e in (je, te):
        e.admit_all()
        e.set_knobs(1, ema=0.7)
        outs.append([e.process(_ellipse_frames(t)) for t in range(STEPS)])
    return je, te, outs


@pytest.mark.parametrize("step", range(STEPS))
def test_engine_step_matches(engines, step):
    _, te, (jouts, touts) = engines
    jo, to = jouts[step], touts[step]
    assert te.face_models is not None
    assert to["class_alpha"].shape == (2, 32, 64, K) and to["frame"].dtype == torch.uint8
    np.testing.assert_allclose(to["class_alpha"].numpy(), np.asarray(jo["class_alpha"]),
                               rtol=0, atol=2e-3)
    np.testing.assert_allclose(to["alpha"].numpy(), np.asarray(jo["alpha"]), rtol=0,
                               atol=2e-3)
    diff = np.abs(to["frame"].numpy().astype(np.int32)
                  - np.asarray(jo["frame"]).astype(np.int32))
    assert diff.max() <= 2 and (diff > 1).mean() < 0.01
    assert not to["face_applied"].any() and not to["det_score"].any()


def test_engine_state_after_the_steps(engines):
    """rec (the smoothed class maps) within 2e-3 and frame_idx equal; the
    adaptive EMA ran (the maps moved between steps)."""
    je, te, (jouts, touts) = engines
    np.testing.assert_allclose(te.state.rec[0].numpy(), np.asarray(je.state.rec), rtol=0,
                               atol=2e-3)
    np.testing.assert_array_equal(te.state.frame_idx.numpy(), np.asarray(je.state.frame_idx))
    assert np.abs(touts[-1]["class_alpha"].numpy() - touts[0]["class_alpha"].numpy()).max() \
        > 1e-2


# ---- the trained weights at 720p --------------------------------------------


def test_trained_engine_iou_720p(record_property):
    """Both engines as they serve, the trained mattenet_multiclass, the two
    committed frames swapped between S=2 streams for 8 steps: the
    foreground IoU (1 - class 0 > 0.5) within 0.01 of the reference's at
    every step, and each class map's mean within 5e-3; the reference's
    least IoU is chip_smoke.py's bar (REFERENCE_IOU['multiclass']).  This
    checkpoint was fitted to another synthetic scene (the reference's
    tools/train_variants.py::train_multiclass) and finds none of this
    person (class 0 above 0.5 nearly everywhere, IoU 0 on both sides), so
    chip_smoke.py also holds the last step's class means to the
    reference's (REFERENCE_CLASS_MEANS)."""
    frames, gt = bridge.load_frames()
    st = preset("multiclass")
    w = bridge.trained_weights(st)
    je = JaxEngine(num_streams=2, statics=jax_preset("multiclass"),
                   bundle=_bundle(w["params"], w["face_params"]["face"],
                                  w["face_params"]["lmk"]), donate_state=False)
    te = Engine(2, st, **w, device="cpu")
    order = [np.arange(2) % 2, (np.arange(2) + 1) % 2]
    je.admit_all()
    te.admit_all()
    ious = []
    for t in range(8):
        truth = gt[order[t % 2]] > 127
        maps = [np.asarray(e.process(frames[order[t % 2]])["class_alpha"]) for e in (je, te)]
        step = [foreground_iou(m, truth) for m in maps]
        means = [m.mean(axis=(0, 1, 2)) for m in maps]
        print(f"[multiclass trained, 720p, step {t}] foreground IoU vs ground truth: "
              f"reference {step[0]:.4f}, port {step[1]:.4f}; class means: reference "
              f"{np.round(means[0], 4).tolist()}, port {np.round(means[1], 4).tolist()}")
        ious.append(step)
        assert abs(step[0] - step[1]) < 0.01
        np.testing.assert_allclose(means[1], means[0], rtol=0, atol=5e-3)
    assert te.stats()["passthrough_steps"] == 0
    record_property("iou_reference", [r for r, _ in ious])
    record_property("iou_port", [p for _, p in ious])
