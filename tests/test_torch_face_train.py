"""The port's face training (train/face.py, train/face_trainer.py) against
the reference's (train/face.py, tools/train_face.py) at a small geometry:
scenes 72x128, FD 64, LMK 48, batch 2.

- The face batch rendered from the reference's own draws, parts included,
  within 1e-6 (the same arithmetic; sqrt and division may round apart);
  the landmark template exactly.
- The losses, the letterbox and the jittered crops given the same draws
  within 1e-6 relative (f32 products on both sides: the CPU reference's
  precision).
- One step's loss and gradient of each model from the reference's init
  tree, BatchNorm statistics included, at the bars of
  tests/torch_train_helpers.py; a 3-step ``train_model`` in f32 on the
  same batches: losses within 1e-4 relative (the updates feed back).
- ``main`` at the small geometry writes exports that load back, and
  reuses them with the skip flags; the reference's own face-training
  properties (tests/test_face_training.py) hold on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_train_helpers as H
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu import models
from video_stream_segmenetation_tpu.train import face as JF
from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.models.blazeface import FaceFinder
from video_stream_segmenetation_tpu_torch.models.facemesh import LandmarkNet
from video_stream_segmenetation_tpu_torch.ops.detect import blazeface_anchors
from video_stream_segmenetation_tpu_torch.train import face as PF
from video_stream_segmenetation_tpu_torch.train import face_trainer as FT

import train_face as TF  # noqa: E402  (tools/, on the path torch_train_helpers sets)

SCENE = (72, 128)
FD, LMK = 64, 48
B = 2
T = torch.as_tensor


@pytest.fixture
def ref_geometry(monkeypatch):
    """The reference trainer's module geometry at the small sizes."""
    monkeypatch.setattr(TF, "SCENE_HW", SCENE)
    monkeypatch.setattr(TF, "FD", FD)
    monkeypatch.setattr(TF, "LMK", LMK)


def _ref_draws(key, hw):
    """The reference's draws of synthetic_face_batch(key, B, hw), as the
    port's face_draws names them (``ks[10]`` drawn twice, as the reference
    does)."""
    h, w = hw
    ks = jax.random.split(key, 14)

    def u(k, shape, lo=0.0, hi=1.0):
        return np.array(jax.random.uniform(k, shape, minval=lo, maxval=hi))

    b1, b3, img = (B, 1, 1), (B, 1, 1, 3), (B, h, w, 3)
    return {"cx": u(ks[0], b1, 0.25 * w, 0.75 * w), "cy": u(ks[1], b1, 0.45 * h, 0.85 * h),
            "rx": u(ks[2], b1, 0.12 * w, 0.28 * w), "ry": u(ks[3], b1, 0.28 * h, 0.5 * h),
            "edge": u(ks[4], b1, 0.05, 0.2), "head_dy": u(ks[5], b1, 0.9, 1.2),
            "head_r": u(ks[6], b1, 0.35, 0.55), "fg_color": u(ks[7], b3, 0.25, 0.9),
            "fg_tex": u(ks[8], img, -0.15, 0.15), "bg_base": u(ks[9], b3, 0.0, 0.5),
            "bg_tex": u(ks[10], img), "bg_gain": u(ks[10], (B, 1, 1, 1), 0.1, 0.4),
            "noise": np.array(jax.random.normal(ks[11], img)),
            "feat_strength": u(ks[12], b1, 0.45, 0.75)}


def _ref_batch(seed, hw=SCENE):
    """The reference's face batch (numpy) of PRNGKey(seed)."""
    out = jax.jit(JF.synthetic_face_batch, static_argnums=(1, 2))(jax.random.PRNGKey(seed), B, hw)
    return tuple(np.asarray(v) for v in out)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---- data -------------------------------------------------------------------


def test_template_is_the_references():
    np.testing.assert_array_equal(PF.face_template_468(), JF.face_template_468())
    assert PF.ANCHOR_IDS == JF.ANCHOR_IDS and PF.ANCHOR_UV == JF.ANCHOR_UV


def test_face_batch_renders_reference_draws():
    key = jax.random.PRNGKey(5)
    want = jax.jit(JF.synthetic_face_batch, static_argnums=(1, 2, 3))(key, B, SCENE, True)
    draws = {k: T(v) for k, v in _ref_draws(key, SCENE).items()}
    got = PF.render_face_batch(draws, SCENE, return_parts=True)
    for name, g, w in zip(("frame", "box", "landmarks"), got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6 * max(1.0, float(np.abs(w).max())), err_msg=name)
    assert got[3].keys() == want[3].keys()
    for k in got[3]:
        np.testing.assert_allclose(got[3][k].numpy(), np.asarray(want[3][k]), rtol=0, atol=1e-6,
                                   err_msg=k)


def test_face_draws_ranges():
    d = PF.face_draws(torch.Generator().manual_seed(0), 64, SCENE)
    assert set(d) == set(_ref_draws(jax.random.PRNGKey(0), SCENE))
    fs = d["feat_strength"]
    assert fs.shape == (64, 1, 1) and fs.min() >= 0.45 and fs.max() < 0.75


def test_losses_match_reference():
    g = np.random.default_rng(3)
    anchors = blazeface_anchors(FD)
    a = anchors.shape[0]
    gt = np.asarray([[0.3, 0.25, 0.6, 0.7], [0.1, 0.4, 0.45, 0.8]], np.float32)
    det = {"box_scores": g.uniform(0, 1, (B, a)).astype(np.float32),
           "box_coords": g.uniform(0, 1, (B, a, 16)).astype(np.float32)}
    want = JF.detector_loss({k: jnp.asarray(v) for k, v in det.items()}, jnp.asarray(gt),
                            jnp.asarray(anchors))
    got = PF.detector_loss({k: T(v) for k, v in det.items()}, T(gt), T(anchors))
    lm = {"landmarks": g.uniform(0, 1, (B, 468, 3)).astype(np.float32),
          "scores": np.asarray([0.8, 0.3], np.float32)}
    lgt = g.uniform(0, 1, (B, 468, 2)).astype(np.float32)
    is_face = np.asarray([True, False])
    want_l = JF.landmark_loss({k: jnp.asarray(v) for k, v in lm.items()}, jnp.asarray(lgt),
                              jnp.asarray(is_face))
    got_l = PF.landmark_loss({k: T(v) for k, v in lm.items()}, T(lgt), T(is_face))
    for (tl, tm), (jl, jm) in ((got, want), (got_l, want_l)):
        assert _rel(tl.item(), float(jl)) <= 1e-6
        for k in jm:
            assert _rel(tm[k].item(), float(jm[k])) <= 1e-6, k


def test_letterbox_and_crops_match_reference(ref_geometry):
    frames, box, lm = _ref_batch(7)
    want_in, want_gt = TF.letterbox_batch(jnp.asarray(frames), jnp.asarray(box))
    got_in, got_gt = FT.letterbox_batch(T(frames), T(box), FD, SCENE)
    assert got_in.shape == (B, FD, FD, 3)
    assert _rel(got_in, want_in) <= 1e-6 and _rel(got_gt, want_gt) <= 1e-6
    key = jax.random.PRNGKey(11)
    k1, k2, k3 = jax.random.split(key, 3)
    draws = {"scale": jax.random.uniform(k1, (B,), minval=0.9, maxval=1.15),
             "shift": jax.random.uniform(k2, (B, 2), minval=-0.1, maxval=0.1),
             "face_u": jax.random.uniform(k3, (B,))}
    want = TF.lmk_batch(key, *map(jnp.asarray, (frames, box, lm)))
    got = FT.lmk_batch({k: T(np.asarray(v)) for k, v in draws.items()}, T(frames), T(box), T(lm),
                       LMK, SCENE)
    assert got[0].shape == (B, LMK, LMK, 3)
    assert _rel(got[0], want[0]) <= 1e-6 and _rel(got[1], want[1]) <= 1e-6
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    d = FT.lmk_draws(torch.Generator().manual_seed(0), 256)
    assert d["scale"].min() >= 0.9 and d["scale"].max() < 1.15
    assert d["shift"].abs().max() <= 0.1 and 0.6 < (d["face_u"] > 0.25).float().mean() < 0.9


# ---- gradients and the trainer ---------------------------------------------------


def _ref_model(which, jdt=jnp.float32):
    return models.FaceFinder(input_size=FD, dtype=jdt) if which == "fd" else \
        models.LandmarkNet(dtype=jdt)


def _init_tree(which):
    """The reference trainer's init: ``model.init(PRNGKey(0), sample)``."""
    size = FD if which == "fd" else LMK
    return H.np_tree(_ref_model(which).init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3))))


def _port_model(which, tree, tdt):
    if which == "fd":
        return FaceFinder(tree, FD, device="cpu", dtype=tdt)
    return LandmarkNet(tree, device="cpu", dtype=tdt)


def _inputs(which, seed):
    """One step's model inputs and targets (numpy), made by the reference's
    batch and its letterbox or crops."""
    frames, box, lm = map(jnp.asarray, _ref_batch(seed))
    if which == "fd":
        return tuple(np.asarray(v) for v in TF.letterbox_batch(frames, box))
    return tuple(np.asarray(v) for v in TF.lmk_batch(jax.random.PRNGKey(seed), frames, box, lm))


def _losses(which, jdt):
    """(reference loss of (params, inputs), port loss of (model, inputs))."""
    jm = _ref_model(which, jdt)
    if which == "fd":
        anchors = jnp.asarray(blazeface_anchors(FD))
        return (lambda p, x, gt: JF.detector_loss(jm.apply(p, x), gt, anchors),
                lambda m, x, gt: PF.detector_loss(m(x), gt, m.anchors))
    return (lambda p, x, gt, face: JF.landmark_loss(jm.apply(p, x), gt, face),
            lambda m, x, gt, face: PF.landmark_loss(m(x), gt, face))


@pytest.fixture(scope="module")
def grads():
    """Both sides' (loss, gradient leaves) for each model and dtype, from
    the reference's init tree and one batch."""
    TF.SCENE_HW, TF.FD, TF.LMK = SCENE, FD, LMK
    out = {}
    for which in ("fd", "lmk"):
        tree = _init_tree(which)
        inputs = _inputs(which, 21)
        for dtype, (jdt, tdt) in H.DTYPES.items():
            jloss, tloss = _losses(which, jdt)
            ref = H.ref_grads(lambda p: jloss(p, *map(jnp.asarray, inputs)), tree)
            model = _port_model(which, tree, tdt)
            out[which, dtype] = ref, H.port_grads(model, lambda: tloss(model, *map(T, inputs)))
    return out


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("which", ["fd", "lmk"])
def test_gradients_match_reference(grads, which, dtype):
    ref, got = grads[which, dtype]
    H.assert_grads_close(ref, got, dtype, stats=2 * 9, ref_f32=grads[which, "f32"][0])


@pytest.mark.parametrize("which", ["fd", "lmk"])
def test_train_model_f32_matches_reference(ref_geometry, which):
    """Three steps of each side's ``train_model`` from the reference's init,
    fed the same batches (the reference's loss finds its batch by its
    step's key): per-step losses within 1e-4 relative."""
    steps = 3
    batches = [_inputs(which, 40 + i) for i in range(steps)]
    pick = H.by_key(H.split_keys(1, steps), batches)
    record, ref_losses = H.recorder()
    jloss, tloss = _losses(which, jnp.float32)

    def ref_loss(params, key):
        loss, metrics = jloss(params, *pick(key))
        record(loss)
        return loss, metrics

    size = FD if which == "fd" else LMK
    TF.train_model(which, _ref_model(which), ref_loss, None, steps, 1e-3,
                   jnp.zeros((1, size, size, 3)))
    model = _port_model(which, _init_tree(which), torch.float32)
    it = iter(batches)
    seen = []
    _, hist = FT.train_model(which, model, lambda gen: tloss(model, *map(T, next(it))), steps,
                             on_step=lambda i, m: seen.append(m["loss"].item()))
    assert next(it, None) is None and [r["step"] for r in hist] == [steps]
    assert len(ref_losses) == len(seen) == steps
    for t, j in zip(seen, ref_losses):
        assert abs(t - j) <= 1e-4 * abs(j), (seen, ref_losses)


def test_main_writes_exports_that_load(tmp_path):
    res = FT.main(tmp_path, steps=2, batch=B, fd=FD, lmk=LMK, device="cpu", scene_hw=SCENE)
    fd_name, lmk_name = FT.export_names(FD, LMK)
    assert (fd_name, lmk_name) == ("facefinder_64", "landmarknet_48")
    assert FT.export_names(256, 192) == ("facefinder", "landmarknet")
    fd_tree = bridge.load_export(tmp_path / f"{fd_name}.npz")
    lmk_tree = bridge.load_export(tmp_path / f"{lmk_name}.npz")
    FaceFinder(fd_tree, FD, device="cpu").load_tree(fd_tree)
    LandmarkNet(lmk_tree, device="cpu").load_tree(lmk_tree)
    assert set(res) == {"det_mean_iou", "det_mean_score", "det_valid_frac",
                        "lmk_anchor_x_err_px", "lmk_mean_score"}
    again = FT.main(tmp_path, fd=FD, lmk=LMK, skip_fd=True, skip_lmk=True, device="cpu",
                    scene_hw=SCENE)
    assert again == res


# ---- the reference's own properties (tests/test_face_training.py) ---------------


def test_face_batch_geometry():
    frames, box, lm = PF.synthetic_face_batch(torch.Generator().manual_seed(0), 4, (96, 160))
    assert frames.shape == (4, 96, 160, 3)
    for i in PF.ANCHOR_IDS:
        assert ((lm[:, i, 0] >= box[:, 0] - 1) & (lm[:, i, 0] <= box[:, 2] + 1)).all()
        assert ((lm[:, i, 1] >= box[:, 1] - 1) & (lm[:, i, 1] <= box[:, 3] + 1)).all()


def test_losses_prefer_the_truth():
    anchors = T(blazeface_anchors(64))
    gt = torch.tensor([[0.3, 0.3, 0.7, 0.7]])
    inside = ((anchors[:, 0] >= 0.3) & (anchors[:, 0] <= 0.7) & (anchors[:, 1] >= 0.3)
              & (anchors[:, 1] <= 0.7))[None]
    good = {"box_scores": torch.where(inside, 0.95, 0.05),
            "box_coords": torch.cat([gt[0], torch.zeros(12)]).expand(1, len(anchors), 16)}
    bad = {"box_scores": torch.where(inside, 0.05, 0.95),
           "box_coords": torch.zeros((1, len(anchors), 16))}
    assert PF.detector_loss(good, gt, anchors)[0] < PF.detector_loss(bad, gt, anchors)[0]
    lgt = torch.full((2, 468, 2), 0.5)
    good = {"landmarks": torch.cat([lgt, torch.zeros((2, 468, 1))], -1),
            "scores": torch.tensor([0.9, 0.9])}
    bad = {"landmarks": torch.zeros((2, 468, 3)), "scores": torch.tensor([0.1, 0.1])}
    face = torch.tensor([True, True])
    assert PF.landmark_loss(good, lgt, face)[0] < PF.landmark_loss(bad, lgt, face)[0]


def test_face_models_forward_contract():
    from video_stream_segmenetation_tpu_torch.models.blazeface import init_face_finder_params
    from video_stream_segmenetation_tpu_torch.models.facemesh import init_landmark_net_params

    out = FaceFinder(init_face_finder_params(0), 256, device="cpu")(torch.zeros((2, 256, 256, 3)))
    assert out["box_coords"].shape == (2, 896, 16) and out["box_scores"].shape == (2, 896)
    out = LandmarkNet(init_landmark_net_params(0), device="cpu")(torch.zeros((2, 192, 192, 3)))
    assert out["landmarks"].shape == (2, 468, 3) and out["scores"].shape == (2,)
