"""The variant quality gates (video_stream_segmenetation_tpu_torch/
evaluate.py) against the reference's tools/eval_variants.py and
tools/eval_variants_realistic.py on the CPU, at a small geometry (frames
80x160), the committed trained matting weights on both sides (the
reference's checkpoints, the port's numpy exports of them), the face path
off (each side's seeded face models differ).

- ``device_clip`` on the reference's draws: the alpha within 1e-5 (XLA's
  CPU code rounds the last bits of the ellipse's division and square root
  otherwise: at most 2.4e-6 seen), so the u8 frames equal but where such
  a bit crosses a rounding of the frame: one step on at most 2 of the 24
  frames' 921,600 values (1 seen);
- the synthetic gate's ``eval_case`` on the int8 pico and on the
  SaliencyNet, the reference's clip draws: moving and static IoU within chip_smoke.py's
  IOU_SLACK of 0.02 (the REFERENCE_IOU bars), the static flicker within
  0.01;
- the realistic gate's case on the int8 pico and on the SaliencyNet, both
  sides fed the reference's two articulated clips over photos the test
  writes: IoU (mean, least, 5th percentile) within 0.02, temporal
  stability within 0.01.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests import torch_realbg_helpers as RH
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu import ops as jops
from video_stream_segmenetation_tpu.train.realdata import load_background_bank
from video_stream_segmenetation_tpu.utils.clips import articulated_clip
from video_stream_segmenetation_tpu_torch import evaluate as EV

_cache_dir = jax.config.jax_compilation_cache_dir
import eval_variants as JEV  # noqa: E402  (tools/, on the path torch_realbg_helpers sets)
import eval_variants_realistic as JER  # noqa: E402

jax.config.update("jax_compilation_cache_dir", _cache_dir)

HW = (80, 160)
SMALL = {"frame_hw": HW, "mask_hw": (32, 64), "fd_size": 64, "lmk_size": 48,
         "face_path": False}
IOU_TOL, FLICKER_TOL = chip_smoke.IOU_SLACK, 0.01
N_FRAMES = 8


def _ref_draws(hw, n):
    k_bg, k_tex, k_noise = jax.random.split(jax.random.PRNGKey(EV.CLIP_SEED), 3)
    t = lambda x: torch.as_tensor(np.array(x))  # noqa: E731
    return {"bg": t(jax.random.uniform(k_bg, (*hw, 3))),
            "tex": t(jax.random.uniform(k_tex, (*hw, 3))),
            "noise": torch.stack([t(jax.random.normal(jax.random.fold_in(
                k_noise, jnp.float32(i)), (*hw, 3))) for i in range(n)])}


def test_device_clip_renders_the_reference_draws():
    n = 12
    d = _ref_draws(HW, n)
    key = jax.random.PRNGKey(EV.CLIP_SEED)
    clip = jax.jit(JEV.device_clip, static_argnums=(1,))
    apart = 0
    for _, motion in EV.MOTIONS:
        for i in range(n):
            want_f, want_a = clip(jnp.float32(i), HW, jnp.float32(motion), key)
            got_f, got_a = EV.device_clip(i, HW, motion, d["bg"], d["tex"], d["noise"][i])
            assert got_f.dtype == torch.uint8
            np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=0, atol=1e-5)
            diff = np.abs(got_f.numpy().astype(int) - np.asarray(want_f))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4, (i, motion, diff.max(),
                                                                  (diff > 0).sum())
            apart += int((diff > 0).sum())
    assert apart <= 2, apart


# the float nets compute in bf16, where PyTorch and XLA round at other
# places: at this geometry the trained RVM's refined alpha departs by up to
# 0.26 on single pixels from the first frame (its mean by 3e-3, the bar
# tests/test_torch_zoo.py holds it to), which moves a person IoU of 0.35 by
# 0.037; the SaliencyNet's stays inside the bar
SYNTHETIC = [("fast_int8_pico", "mattenet_hd10_pico", SMALL),
             ("u2", "u2net", dict(SMALL, mask_hw=(64, 64)))]


@pytest.mark.parametrize("preset_name,ckpt,overrides", SYNTHETIC)
def test_synthetic_gate_matches_the_reference(preset_name, ckpt, overrides):
    want = JEV.eval_case(preset_name, overrides, ckpt, N_FRAMES)
    eng = EV.case_engine(preset_name, overrides, device="cpu")
    got = EV.eval_case(eng, N_FRAMES, _ref_draws(HW, N_FRAMES))
    for mode in ("moving", "static"):
        assert abs(got[mode]["iou_mean"] - want[mode]["iou_mean"]) <= IOU_TOL, (mode, got, want)
    assert abs(got["static"]["flicker"] - want["static"]["flicker"]) <= FLICKER_TOL, (got, want)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """The reference's two realistic clips over photos the test writes, and
    their ground truth at the gates' grid."""
    tmp = tmp_path_factory.mktemp("photos")
    RH.write_photos(tmp)
    bank = load_background_bank(HW, str(tmp), max_images=8, oversample=2)
    cs = [articulated_clip(N_FRAMES, HW, seed=1, bank=bank, wave=True, shake_px=3.0,
                           occluder_p=0.0),
          articulated_clip(N_FRAMES, HW, seed=2, bank=bank, occluder_p=1.0, motion=1.5)]
    gts = [np.asarray(jops.resize_bilinear(jnp.asarray(c.alpha), EV.EVAL_HW, method="half_pixel",
                                           channel_last=False)) for c in cs]
    return cs, gts


@pytest.mark.parametrize("preset_name,ckpt,overrides", SYNTHETIC)
def test_realistic_gate_matches_the_reference(clips, preset_name, ckpt, overrides):
    want = JER.eval_case(preset_name, overrides, ckpt, *clips)
    got = EV.realistic_case(EV.case_engine(preset_name, overrides, device="cpu"), *clips)
    assert got["frames"] == want["frames"] == 2 * (N_FRAMES - EV.WARM)
    for k in ("iou_mean", "iou_min", "iou_p05"):
        assert abs(got[k] - want[k]) <= IOU_TOL, (k, got, want)
    assert abs(got["temporal_stability"] - want["temporal_stability"]) <= FLICKER_TOL, (
        got, want)
