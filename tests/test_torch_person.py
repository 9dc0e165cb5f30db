"""The port's articulated people (train/person.py) and clips
(utils/clips.py::articulated_clip) against the reference's, at 60x80 and
72x128, from the reference's own draws.

- ``render`` (features and parts), the occluder (panned) and
  ``person_scene``: within 1e-5 (the same arithmetic; sin, atan2, sqrt
  and division may round apart, and the capsules' soft edges magnify it).
- ``articulated_clip`` rendered by the port from the reference's draws,
  procedural background with a wave, and a photo bank: u8 frames within
  1, alpha within 1e-5, ``head_box`` within 1e-4 px (the host's numpy half
  is the reference's, from the same seed).
- The reference's own properties (tests/test_person.py) hold on the port.
"""

import jax
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from tests.torch_train_helpers import ref_occluder_draws
from video_stream_segmenetation_tpu.train import person as JP
from video_stream_segmenetation_tpu.utils import clips as JC
from video_stream_segmenetation_tpu_torch.train import person as PP
from video_stream_segmenetation_tpu_torch.utils import clips as PC

HW = (60, 80)


def _t(d: dict) -> dict:
    return {k: torch.tensor(np.array(v)) for k, v in d.items()}


def _close(got, want, atol, name=""):
    np.testing.assert_allclose(got.numpy() if torch.is_tensor(got) else got, np.asarray(want),
                               rtol=0, atol=atol, err_msg=name)


def test_render_matches_reference():
    k = jax.random.PRNGKey(4)
    ident = JP.sample_identity(k, 3)
    pose = JP.sample_pose(jax.random.fold_in(k, 1), 3, HW)
    want = jax.jit(lambda i, p: JP.render(i, p, HW, features=True, return_parts=True))(ident,
                                                                                     pose)
    got = PP.render(_t(ident), _t(pose), HW, features=True, return_parts=True)
    for name in ("alpha", "rgb", "head_box"):
        _close(got[name], want[name], 1e-5, name)
    for name in want["parts"]:
        _close(got["parts"][name], want["parts"][name], 1e-5, name)


def test_occluder_and_scene_match_reference():
    key = jax.random.PRNGKey(6)
    want = JP.sample_occluder(key, 4, HW, p=0.9, shift=(2.0, -3.0))
    got = PP.render_occluder(_t(ref_occluder_draws(key, 4, HW)), HW, p=0.9, shift=(2.0, -3.0))
    assert float(np.asarray(want["alpha"]).max()) > 0.5  # an occluder is drawn
    _close(got["alpha"], want["alpha"], 1e-5, "alpha")
    _close(got["rgb"], want["rgb"], 1e-5, "rgb")
    bg = np.random.default_rng(0).random((4, *HW, 3), dtype=np.float32)
    want = jax.jit(lambda kk, b: JP.person_scene(kk, 4, HW, b, features=True, occluder_p=0.6,
                                                 return_parts=True))(key, bg)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    draws = {"ident": _t(JP.sample_identity(k1, 4)), "pose": _t(JP.sample_pose(k2, 4, HW)),
             "occ": _t(ref_occluder_draws(k3, 4, HW)),
             "noise": torch.tensor(np.array(jax.random.normal(k4, (4, *HW, 3))))}
    got = PP.render_scene(draws, HW, torch.tensor(bg), features=True, occluder_p=0.6,
                          return_parts=True)
    for name, g, w in zip(("frame", "gt", "head_box"), got[:3], want[:3]):
        _close(g, w, 1e-5, name)
    for name in want[3]:
        _close(got[3][name], want[3][name], 1e-5, name)


@pytest.mark.parametrize("case", ["procedural-wave", "bank"])
def test_articulated_clip_from_reference_draws(case):
    hw, seed = (72, 128), 3
    bank = None
    if case == "bank":
        bank = np.random.default_rng(1).random((2, 100, 160, 3), dtype=np.float32)
    kw = dict(n_frames=3, hw=hw, seed=seed, bank=bank, features=True, occluder_p=1.0,
              wave=case.endswith("wave"))
    want = JC.articulated_clip(**kw)
    k_id, k_pose, k_occ, _, _ = jax.random.split(jax.random.PRNGKey(seed), 5)
    draws = {"ident": JP.sample_identity(k_id, 1), "pose": JP.sample_pose(k_pose, 1, hw),
             "occ": ref_occluder_draws(k_occ, 1, hw)}
    draws = {k: {n: np.array(v) for n, v in d.items()} for k, d in draws.items()}
    got = PC.articulated_clip(**kw, device="cpu", draws=draws)
    assert got.frames.dtype == np.uint8 and got.frames.shape == want.frames.shape
    assert np.abs(got.frames.astype(np.int16) - want.frames).max() <= 1
    _close(got.alpha, want.alpha, 1e-5, "alpha")
    _close(got.head_box, want.head_box, 1e-4, "head_box")


# ---- the reference's own properties (tests/test_person.py) ----------------------


def test_render_shapes_and_ranges():
    gen = torch.Generator().manual_seed(0)
    r = PP.render(PP.sample_identity(gen, 3), PP.sample_pose(gen, 3, HW), HW, features=True)
    a, rgb, hb = r["alpha"], r["rgb"], r["head_box"]
    assert a.shape == (3, *HW) and rgb.shape == (3, *HW, 3)
    assert a.min() >= 0.0 and a.max() <= 1.0 and rgb.min() >= -1e-6 and rgb.max() <= 1 + 1e-6
    cover = a.mean(dim=(1, 2))
    assert bool(((cover > 0.05) & (cover < 0.95)).all())
    assert bool(((hb[:, 2] > hb[:, 0]) & (hb[:, 3] > hb[:, 1])).all())


def test_occluder_cuts_ground_truth():
    bg = torch.full((4, *HW, 3), 0.5)
    draws = PP.scene_draws(torch.Generator().manual_seed(2), 4, HW)
    frame, gt, _ = PP.render_scene(draws, HW, bg, occluder_p=1.0)
    _, gt0, _ = PP.render_scene(draws, HW, bg, occluder_p=0.0)
    assert float(gt.sum()) <= float(gt0.sum()) + 1e-3 and frame.shape == (4, *HW, 3)


def test_raised_arm_mixture_present():
    pose = PP.sample_pose(torch.Generator().manual_seed(3), 512, HW)
    assert 0.10 < float((pose["armR_u"] > 1.0).float().mean()) < 0.45


def test_clip_generator_temporal_coherence():
    c = PC.articulated_clip(4, HW, seed=0, features=True, occluder_p=1.0, device="cpu")
    assert c.frames.shape == (4, *HW, 3) and c.alpha.shape == (4, *HW)
    assert c.head_box is not None and c.head_box.shape == (4, 4)
    d = np.abs(c.alpha[1:] - c.alpha[:-1]).mean(axis=(1, 2))
    assert (d < 0.15).all() and c.alpha.max() > 0.5
