"""The port's stateless entry points (api.py) against the reference's
``segment``, ``composite`` and ``process_frame`` on the CPU: 80x160
frames, a 32x64 mask, the float MatteNet from one seeded tree (the
reference's default model swapped for it, so that its flax init and
checkpoint read are skipped).

Tolerances: the mask within 2e-3 (the bf16 MatteNet, as
tests/test_torch_active.py holds it with seeded weights); the composites
one u8 step, on under 0.1 % of values where the mask is given (f32 in
another order: the blur's sums) and anywhere where it is the model's
(2e-3 of alpha is half a u8 step).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu import api as japi
from video_stream_segmenetation_tpu import models as jm
from video_stream_segmenetation_tpu_torch import api
from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.models.modnet import init_mattenet_params

MASK = (32, 64)
BACKGROUNDS = {
    "black": dict(),
    "blur": dict(bg_blur_sigma=3.0),
    "color": dict(background=(0.2, 0.5, 0.9)),
    "image": dict(background="image"),
    "image u8": dict(background="image u8"),
}


@pytest.fixture(scope="module")
def tree():
    return init_mattenet_params(0)


@pytest.fixture(scope="module")
def reference(tree):
    """The reference's api with its default model swapped for the tree's."""
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    mp = pytest.MonkeyPatch()
    mp.setattr(japi, "_default_matting", lambda model_name="mattenet": (jm.MatteNet(), params))
    yield params
    mp.undo()


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(3)
    f = (rng.random((2, 80, 160, 3)) * 100).astype(np.uint8)
    yy, xx = np.mgrid[0:80, 0:160]
    for s in range(2):
        f[s][((xx - 70 - 15 * s) / 30.0) ** 2 + ((yy - 45) / 32.0) ** 2 <= 1.0] = (225, 190, 160)
    return f


def _bg(kw, rng):
    kw = dict(kw)
    if kw.get("background") == "image":
        kw["background"] = rng.random((40, 60, 3), dtype=np.float32)
    elif kw.get("background") == "image u8":
        kw["background"] = rng.integers(0, 256, (80, 160, 3), dtype=np.uint8)
    return kw


def _close_u8(got, want, rare=True):
    d = np.abs(got.numpy().astype(np.int32) - np.asarray(want).astype(np.int32))
    assert d.max() <= 1
    if rare:
        assert (d > 0).mean() < 1e-3


def test_segment_matches_the_reference(reference, tree, frames):
    want = np.asarray(japi.segment(frames, params=reference, mask_hw=MASK))
    got = api.segment(frames, params=tree, mask_hw=MASK, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, *MASK)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)
    one = api.segment(frames[0], params=tree, mask_hw=MASK, device="cpu")
    assert tuple(one.shape) == MASK


@pytest.mark.parametrize("bg", sorted(BACKGROUNDS))
def test_composite_matches_the_reference(reference, frames, bg):
    rng = np.random.default_rng(9)
    mask = rng.random((2, *MASK), dtype=np.float32)
    mask[0, :, :10] = 0.0
    kw = _bg(BACKGROUNDS[bg], rng)
    want = japi.composite(frames, mask, **kw)
    got = api.composite(frames, mask, device="cpu", **kw)
    assert got.dtype == torch.uint8 and tuple(got.shape) == frames.shape
    _close_u8(got, want)
    one = api.composite(frames[0], mask[0], device="cpu", **kw)
    _close_u8(one, np.asarray(japi.composite(frames[0], mask[0], **kw)))


@pytest.mark.parametrize("bg", ["blur", "color", "image"])
def test_process_frame_matches_the_reference(reference, tree, frames, bg):
    kw = _bg(BACKGROUNDS[bg], np.random.default_rng(2))
    want_out, want_mask = japi.process_frame(frames, params=reference, mask_hw=MASK, **kw)
    out, mask = api.process_frame(frames, params=tree, mask_hw=MASK, device="cpu", **kw)
    np.testing.assert_allclose(mask.numpy(), np.asarray(want_mask), rtol=0, atol=2e-3)
    _close_u8(out, want_out, rare=False)
    # one upload: the same as segment then composite
    seg = api.segment(frames, params=tree, mask_hw=MASK, device="cpu")
    assert torch.equal(mask, seg)
    assert torch.equal(out, api.composite(frames, seg, device="cpu", **kw))


def test_default_weights_are_the_committed_export(frames):
    api._default_matting.cache_clear()
    want = api.segment(frames, params=bridge.load_export(bridge.WEIGHTS_DIR / "mattenet.npz"),
                       mask_hw=MASK, device="cpu")
    assert torch.equal(api.segment(frames, mask_hw=MASK, device="cpu"), want)


def test_unreadable_weights_warn_and_fall_back(tmp_path, monkeypatch, tree, frames):
    (tmp_path / "mattenet.npz").write_bytes(b"not an archive")
    monkeypatch.setattr(api, "WEIGHTS_DIR", tmp_path)
    api._default_matting.cache_clear()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = api.segment(frames, mask_hw=MASK, device="cpu")
    finally:
        api._default_matting.cache_clear()
    assert any("weights restore failed" in str(w.message) for w in caught)
    assert torch.equal(got, api.segment(frames, params=tree, mask_hw=MASK, device="cpu"))


def test_entry_points_need_a_card_unless_asked_for_the_cpu(frames):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    for call in (lambda: api.segment(frames), lambda: api.composite(frames, np.ones(MASK)),
                 lambda: api.process_frame(frames)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_top_level_exports():
    import video_stream_segmenetation_tpu_torch as vst
    from video_stream_segmenetation_tpu_torch.service.engine import Engine

    assert vst.segment is api.segment and vst.composite is api.composite
    assert vst.process_frame is api.process_frame and vst.Engine is Engine
    with pytest.raises(AttributeError):
        vst.no_such_name


def test_trained_segment_iou_720p(monkeypatch, record_property):
    """The committed 720p frames through both packages' segment with the
    trained MatteNet (weights/mattenet.npz, the reference given the same
    tree): each IoU against the ground truth at the mask grid, within 0.01
    of each other (the bf16 MatteNet sits on knife edges at 720p, see
    tests/test_torch_active_720p.py).  The reference's IoU is
    chip_smoke.py's REFERENCE_IOU['api']."""
    frames, gt = bridge.load_frames()
    truth = gt > 127
    tree = bridge.load_export(bridge.WEIGHTS_DIR / "mattenet.npz")
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    monkeypatch.setattr(japi, "_default_matting", lambda model_name="mattenet": (jm.MatteNet(),
                                                                                  params))

    def iou(alpha):
        pred = np.asarray(alpha) > 0.5
        inter = (pred & truth).sum(axis=(1, 2))
        return float(np.mean(inter / np.maximum((pred | truth).sum(axis=(1, 2)), 1)))

    want = iou(japi.segment(frames))
    got = iou(api.segment(frames, device="cpu").numpy())
    print(f"[segment, trained, 720p] IoU vs ground truth: reference {want:.4f}, port {got:.4f}")
    record_property("iou_reference", want)
    record_property("iou_port", got)
    assert abs(got - want) < 0.01 and want > 0.6
