"""The port's photo-background batches (train/realdata.py) against the
reference's, on banks the tests make (the repository holds no photos), at
24x32 and 48x64, batch 3, from the reference's own draws.

- ``person_alpha`` and the two-ellipse batch over photo crops (person,
  crop window, flip, gain, texture, noise) within 1e-6; the articulated
  batch with its parts within 1e-5 (train/person.py's bar); u8 banks too.
- ``load_background_bank`` on PNGs written to ``tmp_path``: equal to the
  reference's, f32 and u8; FileNotFoundError where there is no photo.
- ``make_mixed_data_fn`` and the reference's own shape properties
  (tests/test_train_loop.py's real-background tests).
"""

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from tests.torch_threads import one_torch_thread  # noqa: F401
from tests.torch_train_helpers import ref_occluder_draws
from video_stream_segmenetation_tpu.train import person as JP
from video_stream_segmenetation_tpu.train import realdata as JR
from video_stream_segmenetation_tpu_torch.train import person as PP
from video_stream_segmenetation_tpu_torch.train import realdata as PR

HW = (24, 32)
B = 3


def _t(d: dict) -> dict:
    return {k: torch.tensor(np.array(v)) for k, v in d.items()}


def ref_person_draws(key, batch, hw) -> dict:
    h, w = hw
    ks = jax.random.split(key, 7)
    b1 = (batch, 1, 1)

    def u(k, lo, hi):
        return jax.random.uniform(k, b1, minval=lo, maxval=hi)

    return {"cx": u(ks[0], 0.25 * w, 0.75 * w), "cy": u(ks[1], 0.45 * h, 0.85 * h),
            "rx": u(ks[2], 0.12 * w, 0.28 * w), "ry": u(ks[3], 0.28 * h, 0.5 * h),
            "edge": u(ks[4], 0.05, 0.2), "head_dy": u(ks[5], 0.9, 1.2),
            "head_r": u(ks[6], 0.35, 0.55)}


def ref_crop_draws(ks, batch, n, bank_hw, hw) -> dict:
    """The crop draws of keys ``ks[0..5]`` (idx, scale, y0, x0, flip, gain)."""
    return {"idx": jax.random.randint(ks[0], (batch,), 0, n),
            "scale": jax.random.uniform(ks[1], (batch,), minval=1.0, maxval=bank_hw[0] / hw[0]),
            "y0u": jax.random.uniform(ks[2], (batch,)), "x0u": jax.random.uniform(ks[3], (batch,)),
            "flip_u": jax.random.uniform(ks[4], (batch,)),
            "gain": jax.random.uniform(ks[5], (batch, 1, 1, 3), minval=0.7, maxval=1.2)}


def _bank(u8: bool, n=3, hw=(48, 72)):
    g = np.random.default_rng(n)
    if u8:
        return g.integers(0, 256, (n, *hw, 3), dtype=np.uint8)
    return g.random((n, *hw, 3), dtype=np.float32)


def test_person_alpha_matches_reference():
    key = jax.random.PRNGKey(1)
    want = JR.person_alpha(key, B, HW)
    got = PR.render_person_alpha(_t(ref_person_draws(key, B, HW)), HW)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("u8", [False, True])
def test_ellipse_batch_matches_reference(u8):
    bank = _bank(u8)
    key = jax.random.PRNGKey(2)
    want = JR.make_real_bg_data_fn(bank)(key, B, HW)
    ks = jax.random.split(key, 8)
    k2 = jax.random.fold_in(ks[7], 1)
    img = (B, *HW, 3)
    crop_keys = ks[1:7]
    draws = {"person": _t(ref_person_draws(ks[0], B, HW)),
             "crop": _t(ref_crop_draws(crop_keys, B, len(bank), bank.shape[1:3], HW)),
             "fg_color": torch.tensor(np.array(jax.random.uniform(
                 ks[7], (B, 1, 1, 3), minval=0.25, maxval=0.9))),
             "fg_tex": torch.tensor(np.array(jax.random.uniform(k2, img, minval=-0.15,
                                                                maxval=0.15))),
             "noise": torch.tensor(np.array(jax.random.normal(jax.random.fold_in(k2, 2), img)))}
    got = PR.render_ellipse_batch(torch.tensor(bank), draws, HW)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


def test_articulated_batch_matches_reference():
    bank = _bank(False, hw=(96, 128))
    hw = (48, 64)
    key = jax.random.PRNGKey(3)
    want = JR.make_real_bg_data_fn(bank, person="articulated", return_parts=True)(key, B, hw)
    ks = jax.random.split(key, 7)
    bg = PR.crop_backgrounds(torch.tensor(bank), _t(ref_crop_draws(ks, B, len(bank),
                                                                   bank.shape[1:3], hw)), hw)
    k1, k2, k3, k4 = jax.random.split(ks[6], 4)
    draws = {"ident": _t(JP.sample_identity(k1, B)), "pose": _t(JP.sample_pose(k2, B, hw)),
             "occ": _t(ref_occluder_draws(k3, B, hw)),
             "noise": torch.tensor(np.array(jax.random.normal(k4, (B, *hw, 3))))}
    frame, gt, _, parts = PP.render_scene(draws, hw, bg, features=True, occluder_p=0.3,
                                          return_parts=True)
    for g, w in zip((frame, gt), want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    for name in want[2]:
        np.testing.assert_allclose(parts[name].numpy(), np.asarray(want[2][name]), rtol=0,
                                   atol=1e-5, err_msg=name)
    fn = PR.make_real_bg_data_fn(bank, person="articulated", return_parts=True, device="cpu")
    out = fn(torch.Generator().manual_seed(0), B, hw)
    assert len(out) == 3 and set(out[2]) == {"a_body", "a_head", "feat"}
    with pytest.raises(ValueError):
        PR.make_real_bg_data_fn(bank, return_parts=True, device="cpu")


@pytest.mark.parametrize("u8", [False, True])
def test_load_background_bank_matches_reference(tmp_path, u8):
    g = np.random.default_rng(7)
    for i, ext in enumerate(("png", "jpg", "PNG")):
        Image.fromarray(g.integers(0, 256, (40 + 8 * i, 60, 3), dtype=np.uint8)).save(
            tmp_path / f"bg{i}.{ext}")
    (tmp_path / "notes.txt").write_text("not a photo")
    kw = dict(max_images=2, oversample=1.5, as_uint8=u8)
    want = JR.load_background_bank((24, 32), directory=str(tmp_path), **kw)
    got = PR.load_background_bank((24, 32), tmp_path, **kw)
    assert got.dtype == want.dtype and got.shape == (2, 36, 48, 3)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(FileNotFoundError):
        PR.load_background_bank((24, 32), tmp_path / "absent")
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        PR.load_background_bank((24, 32), tmp_path / "empty")
    with pytest.raises(ValueError):
        PR.load_background_bank((24, 32), tmp_path, oversample=0.5)


def test_real_bg_data_fn_and_mixed():
    """The reference's properties: shapes and ranges, live augmentation,
    u8 banks converted after the crop, the mixed batch with both halves."""
    bank8 = _bank(True, n=2, hw=(36, 48))
    fn = PR.make_real_bg_data_fn(bank8, device="cpu")
    gen = torch.Generator().manual_seed(0)
    frames, alpha = fn(gen, 3, HW)
    assert frames.shape == (3, *HW, 3) and alpha.shape == (3, *HW)
    assert frames.dtype == torch.float32 and frames.min() >= 0 and frames.max() <= 1
    assert 0.0 < float(alpha.mean()) < 1.0
    frames2, _ = fn(gen, 3, HW)
    assert float((frames2 - frames).abs().max()) > 0.05
    mixed = PR.make_mixed_data_fn(fn, real_frac=0.5)
    frames, alpha = mixed(gen, 4, HW)
    assert frames.shape == (4, *HW, 3) and alpha.shape == (4, *HW)
    frames, _ = PR.make_mixed_data_fn(fn, real_frac=1.0)(gen, 2, HW)
    assert frames.shape[0] == 2
    frames, _ = mixed(gen, 1, HW)
    assert frames.shape[0] == 1
