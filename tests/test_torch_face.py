"""The port's face subpath against the JAX package: the resize, geometry,
detector and prior ops (f32 on both sides, held at float32 rounding), the
bf16 FaceFinder / LandmarkNet with the trained weights, and the
cadence-compacted face subpath on the planar u8 guide.

Tolerances, with their reasons:
* ops: 1e-5 relative plus a few ulps absolute (float32 operations in
  another order), exact where the op is floor/ceil/compare on equal
  inputs;
* face models: bf16 convolutions round at other places in PyTorch and
  XLA.  FaceFinder's normalized boxes within 2e-3 (a quarter pixel at a
  128 input) and scores within 1e-2 (one bf16 step of a logit in the
  sigmoid's steep middle); LandmarkNet's x/y within 4e-3 (one bf16 step
  of the dense output through the sigmoid), its raw z within one bf16
  step at magnitude 1 (2**-7), its score within 2e-3;
* the compacted subpath: decisions equal on frames whose scores are clear
  of the thresholds, det_score within 1e-2, the prior scalars within one
  mask pixel (the floor/ceil box conversion), the affine within 0.3 mask
  pixels in translation and 1e-2 in its linear part.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stream_segmenetation_tpu import models, ops
from video_stream_segmenetation_tpu.ops import detect as JD
from video_stream_segmenetation_tpu.ops import geometry as JG
from video_stream_segmenetation_tpu.ops import prior as JP
from video_stream_segmenetation_tpu.runtime import init_state
from video_stream_segmenetation_tpu.runtime.pipeline import (
    ModelBundle,
    _face_subpath_compact,
    _letterbox_to_square,
)
from video_stream_segmenetation_tpu.runtime.presets import preset as jax_preset
from video_stream_segmenetation_tpu.utils.checkpoint import restore_params
from video_stream_segmenetation_tpu.utils.clips import articulated_clip
from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.models.blazeface import FaceFinder
from video_stream_segmenetation_tpu_torch.models.facemesh import LandmarkNet
from video_stream_segmenetation_tpu_torch.ops import detect as TD
from video_stream_segmenetation_tpu_torch.ops import geometry as TG
from video_stream_segmenetation_tpu_torch.ops import prior as TP
from video_stream_segmenetation_tpu_torch.ops import resize as TR
from video_stream_segmenetation_tpu_torch.runtime import pipeline as TPL
from video_stream_segmenetation_tpu_torch.runtime.presets import preset

T = torch.tensor
ATOL = 1e-5


def _close(got, want, atol=ATOL, rtol=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


# ---- ops/resize.py ------------------------------------------------------


@pytest.mark.parametrize("method", ["asymmetric", "half_pixel"])
@pytest.mark.parametrize("out_hw", [(7, 9), (20, 30), (12, 16)])
def test_resize_bilinear_forms_match(rng, method, out_hw):
    img = rng.random((2, 12, 16, 3), dtype=np.float32)
    want = ops.resize_bilinear(jnp.asarray(img), out_hw, method=method)
    _close(TR.resize_bilinear(T(img), out_hw, method=method), want)
    want_mxu = ops.resize_bilinear_mxu(jnp.asarray(img), out_hw, method=method)
    _close(TR.resize_bilinear_mxu(T(img), out_hw, method=method), want_mxu)
    plane = img[..., 0]
    _close(TR.resize_bilinear_mxu(T(plane), out_hw, method=method, channel_last=False),
           ops.resize_bilinear_mxu(jnp.asarray(plane), out_hw, method=method,
                                   channel_last=False))


def test_crop_and_resize_mxu_matches(rng):
    img = rng.random((3, 20, 30, 3), dtype=np.float32)
    # inside, partly outside the frame, and degenerate boxes
    box = np.asarray([[3.0, 2.0, 17.5, 15.0], [-4.0, 10.0, 12.0, 26.0],
                      [25.0, 1.0, 25.0, 1.5]], np.float32)
    want = ops.crop_and_resize_mxu(jnp.asarray(img), jnp.asarray(box), (9, 11))
    _close(TR.crop_and_resize_mxu(T(img), T(box), (9, 11)), want)


# ---- ops/geometry.py, ops/detect.py, ops/prior.py -----------------------


def test_geometry_constants_match():
    assert TG.ANCHOR_IDXS == JG.ANCHOR_IDXS and TG.REF_NORM == JG.REF_NORM


@pytest.mark.parametrize("src_hw,target", [((288, 512), 128), ((288, 512), 256),
                                           ((32, 64), 64), ((720, 1280), 256)])
def test_letterbox_matches(rng, src_hw, target):
    assert TG.letterbox_params(src_hw, target) == JG.letterbox_params(src_hw, target)
    pts = (rng.random((4, 2)) * target).astype(np.float32)
    _close(TG.letterbox_inverse_map(T(pts), src_hw, target),
           JG.letterbox_inverse_map(jnp.asarray(pts), src_hw, target))
    frames = rng.random((2, *src_hw, 3), dtype=np.float32)
    if src_hw[0] * src_hw[1] <= 288 * 512:
        _close(TPL.letterbox_to_square(T(frames), src_hw, target),
               _letterbox_to_square(jnp.asarray(frames), src_hw, target, impl="mxu"))


def test_pad_box_matches(rng):
    box = np.concatenate([rng.random((6, 2)) * 40, 40 + rng.random((6, 2)) * 30], 1)
    box[0] = (-5.0, -3.0, 70.0, 90.0)  # clamped at every side
    box[1] = (10.0, 10.0, 10.0, 10.0)  # empty: at least one pixel
    box = box.astype(np.float32)
    np.testing.assert_array_equal(TG.pad_box(T(box), 0.25, (64, 72)).numpy(),
                                  np.asarray(JG.pad_box(jnp.asarray(box), 0.25, (64, 72))))


@pytest.mark.parametrize("mask_hw", [(72, 128), (288, 512)])
def test_affine_from_landmarks_matches(rng, mask_hw):
    base = np.asarray(JG.REF_NORM, np.float32) * np.asarray([512, 288], np.float32)
    pts = np.zeros((3, 468, 2), np.float32)
    pts[:] = rng.random((468, 2)) * 100
    for s in range(3):  # rotated, scaled, shifted anchors plus noise
        th, sc = 0.1 * (s - 1), 0.8 + 0.2 * s
        r = np.asarray([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]) * sc
        pts[s, list(JG.ANCHOR_IDXS)] = base @ r.T + (5.0 * s, -3.0) + rng.normal(0, 2, (5, 2))
    want = JG.affine_from_landmarks(jnp.asarray(pts), (288, 512), mask_hw, mode="exact")
    _close(TG.affine_from_landmarks(T(pts), (288, 512), mask_hw), want,
           atol=1e-4)
    ref = jnp.asarray(rng.random((2, 5, 2)), jnp.float32)
    dst = jnp.asarray(rng.random((2, 5, 2)), jnp.float32)
    _close(TG.estimate_similarity_transform(T(np.asarray(dst)), T(np.asarray(ref))),
           JG.estimate_similarity_transform(dst, ref))


@pytest.mark.parametrize("size", [64, 128, 256])
def test_anchors_and_decode_match(rng, size):
    np.testing.assert_array_equal(TD.blazeface_anchors(size), ops.blazeface_anchors(size))
    a = TD.blazeface_anchors(size)
    raw = (rng.normal(0, 8, (2, a.shape[0], 16))).astype(np.float32)
    _close(TD.decode_anchor_boxes(T(raw), T(np.array(a)), size),
           JD.decode_anchor_boxes(jnp.asarray(raw), jnp.asarray(a), size))


@pytest.mark.parametrize("letterboxed", [True, False])
def test_best_box_decode_matches(rng, letterboxed):
    n = 224
    coords = rng.random((4, n, 16)).astype(np.float32)
    coords[..., 2:4] = coords[..., 0:2] + 0.2 * rng.random((4, n, 2))
    scores = rng.random((4, n)).astype(np.float32)
    scores[1, [7, 30, 99]] = 2.0  # a tie: the first index wins
    coords[2, :, 2:4] = coords[2, :, 0:2]  # empty boxes: not valid
    coords[3, :, :4] = (0.0, 0.0, 0.1, 0.05)  # clamped to the frame's corner
    want = ops.best_box_decode(jnp.asarray(coords), jnp.asarray(scores), (288, 512), 128,
                               letterboxed=letterboxed)
    got = TD.best_box_decode(T(coords), T(scores), (288, 512), 128, letterboxed=letterboxed)
    _close(got[0], want[0], atol=1e-4)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[1][1].item() == 2.0 and not got[2][2].item()


def test_face_prior_params_match(rng):
    box = np.concatenate([rng.random((8, 2)) * 200, 200 + rng.random((8, 2)) * 200], 1)
    box = box.astype(np.float32)
    for video_hw in ((288, 512), (720, 1280)):
        np.testing.assert_array_equal(
            TP.face_prior_params(T(box), video_hw, (288, 512)).numpy(),
            np.asarray(JP.face_prior_params(jnp.asarray(box), video_hw, (288, 512))))


# ---- models ---------------------------------------------------------------


@pytest.fixture(scope="module")
def face_trees():
    return {name: bridge.face_tree(jax.tree_util.tree_map(
        np.asarray, restore_params(f"checkpoints/{name}")))
        for name in ("facefinder_128", "landmarknet_128", "facefinder", "landmarknet")}


def _guide_faces(n, size):
    """Letterboxed guide views of rendered people (the detector's inputs)."""
    frames = articulated_clip(n_frames=n, hw=(160, 320), seed=2, features=True).frames
    g = ops.resize_nearest(jnp.asarray(frames), (64, 128), method="half_pixel")
    fd_in = _letterbox_to_square(g.astype(jnp.float32) / 255.0, (64, 128), size, "mxu")
    return np.asarray(fd_in)


@pytest.mark.parametrize("ckpt,size", [("facefinder_128", 128), ("facefinder", 256)])
def test_face_finder_matches(face_trees, rng, ckpt, size):
    x = np.concatenate([_guide_faces(2, size), rng.random((1, size, size, 3), np.float32)])
    tree = face_trees[ckpt]
    want = models.FaceFinder(input_size=size).apply(tree, jnp.asarray(x))
    got = FaceFinder(tree, size)(T(x))
    _close(got["box_coords"], want["box_coords"], atol=2e-3, rtol=0)
    _close(got["box_scores"], want["box_scores"], atol=1e-2, rtol=0)
    assert float(np.asarray(want["box_scores"])[:2].max(axis=-1).min()) > 0.9  # faces found


@pytest.mark.parametrize("ckpt,size", [("landmarknet_128", 128), ("landmarknet", 192)])
def test_landmark_net_matches(face_trees, rng, ckpt, size):
    x = np.concatenate([_guide_faces(2, size), rng.random((1, size, size, 3), np.float32)])
    tree = face_trees[ckpt]
    want = models.LandmarkNet().apply(tree, jnp.asarray(x))
    got = LandmarkNet(tree)(T(x))
    assert got["landmarks"].shape == (3, 468, 3)
    _close(got["landmarks"][..., :2], np.asarray(want["landmarks"])[..., :2],
           atol=4e-3, rtol=0)
    _close(got["landmarks"][..., 2], np.asarray(want["landmarks"])[..., 2],
           atol=2.0 ** -7 + 1e-6, rtol=0)
    _close(got["scores"], want["scores"], atol=2e-3, rtol=0)


# ---- the compacted face subpath -------------------------------------------


def _people(frame_hw):
    """S=4 frames of rendered people: at 160x320 four renders, at 720p the
    two committed frames twice."""
    if frame_hw == (720, 1280):
        return bridge.load_frames()[0][[0, 1, 0, 1]]
    return np.concatenate([
        articulated_clip(n_frames=1, hw=frame_hw, seed=sd, features=True).frames
        for sd in (2, 1, 4, 2)])


@pytest.mark.parametrize("frame_hw,mask_hw", [((160, 320), (64, 128)),
                                              ((720, 1280), (288, 512))])
@pytest.mark.parametrize("name,ckpts", [
    ("fast_int8_pico", ("facefinder_128", "landmarknet_128")),
    ("fast_int8_micro", ("facefinder", "landmarknet")),
])
def test_face_subpath_compact_matches(face_trees, name, ckpts, frame_hw, mask_hw):
    """S=4 guides of rendered people, at a small mask and at the presets'
    own 288x512 (the face models at the presets' fd/lmk sizes); streams 0,
    1, 3 at a cadence frame, stream 2 not; face_batch=2, so stream 3
    overflows and skips the round, as in the reference."""
    s = 4
    geom = dict(frame_hw=frame_hw, mask_hw=mask_hw, face_batch=2)
    frames = _people(frame_hw)
    guide = np.asarray(ops.guide_from_s2d(
        ops.space_to_depth(jnp.asarray(frames), 10), frame_hw, mask_hw, 10,
        planar=True))
    frame_idx = np.asarray([0, 6, 3, 12], np.int32)
    gate = np.asarray([True, True, True, True])

    jst = jax_preset(name, **geom)
    fd, lm = face_trees[ckpts[0]], face_trees[ckpts[1]]
    bundle = ModelBundle(None, None, models.FaceFinder(input_size=jst.fd_size), fd,
                         models.LandmarkNet(), lm)
    state = init_state(s, mask_hw)
    state = state.__class__(**{**state.__dict__, "frame_idx": jnp.asarray(frame_idx)})
    fstat = jax_preset(name, **{**geom, "frame_hw": mask_hw})
    want = _face_subpath_compact(bundle, bundle.params, jnp.asarray(guide), state, fstat,
                                 jnp.asarray(gate), src_planar=True, prior_form="params")
    want = [np.asarray(w) for w in want]

    tst = preset(name, **geom)
    tm = TPL.FaceModels(FaceFinder(fd, tst.fd_size), LandmarkNet(lm))
    got = TPL.face_subpath_compact(tm, T(guide), T(frame_idx), T(gate), tst)
    got = [g.numpy() for g in got]
    prior, has_prior, affine, has_update, score = range(5)
    # the premise: the reference's detections are clear of the threshold
    assert want[has_prior].tolist() == [True, True, False, False]
    assert np.all(np.abs(want[score][:2] - tst.face_score_thresh) > 0.05)
    for i in (has_prior, has_update):
        np.testing.assert_array_equal(got[i], want[i])
    _close(got[score], want[score], atol=1e-2, rtol=0)
    _close(got[prior], want[prior], atol=1.0, rtol=0)
    _close(got[affine][:, [2, 5]], want[affine][:, [2, 5]], atol=0.3, rtol=0)
    _close(got[affine][:, [0, 1, 3, 4]], want[affine][:, [0, 1, 3, 4]], atol=1e-2, rtol=0)
    assert np.all(got[prior][2:] == 0) and np.all(got[score][2:] == 0)


def test_first_k_pads_with_s():
    fire = T(np.asarray([False, True, True, False, True]))
    np.testing.assert_array_equal(TPL.first_k(fire, 2).numpy(), [1, 2])
    np.testing.assert_array_equal(TPL.first_k(fire, 4).numpy(), [1, 2, 4, 5])
    np.testing.assert_array_equal(TPL.first_k(T(np.zeros(3, bool)), 2).numpy(), [3, 3])
