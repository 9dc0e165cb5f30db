"""parity_matting.py, diag_realistic_clips.py and tune_adaptive_ema.py on
the CPU: the oracle chain against the same chain built from the JAX
package's tests/oracles.py (exactly: the same Python and numpy
operations), the capture's keys, the flicker, and ``--small`` runs of the
three tools on two written photographs, which finish with the reference's
report keys (tools/parity_matting.py:359-426, tools/diag_realistic_clips.py,
tools/tune_adaptive_ema.py; the tools are not imported: their imports set
JAX's global config)."""

import numpy as np
import pytest
from PIL import Image

from tests import oracles as JO
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu.runtime import config as JC
from video_stream_segmenetation_tpu_torch import diag_realistic_clips as DG
from video_stream_segmenetation_tpu_torch import parity_matting as PM
from video_stream_segmenetation_tpu_torch import tune_adaptive_ema as TA
from video_stream_segmenetation_tpu_torch.runtime import config as TC
from video_stream_segmenetation_tpu_torch.utils.clips import articulated_clip

MASK_HW = (12, 20)
REPORT_KEYS = ["_acquisition_record", "_method", "checkpoint", "device", "clips",
               "int8_vs_float_pipeline", "engine_vs_reference_semantics_oracle",
               "engine_vs_oracle_face_path", "int8_pipeline_vs_gt", "float_pipeline_vs_gt",
               "float_pipeline_vs_gt_ema0"]
PARITY_KEYS = {"iou_mean", "iou_min", "iou_p05", "temporal_stability", "frames"}


def reference_chain(model_masks, frames, mask_hw, caps=None, warp_w=0.5):
    """tools/parity_matting.py::oracle_chain (with its prior_mask_oracle),
    on tests/oracles.py and the JAX package's defaults."""
    out = np.zeros_like(model_masks)
    prev = None
    mh, mw = mask_hw
    for t in range(len(model_masks)):
        a = model_masks[t].astype(np.float64)
        prior = None
        if caps is not None:
            c = caps[t]
            if c["has_affine"] and prev is not None:
                warped = JO.warp_affine_nearest_oracle(prev, tuple(c["affine"]))
                a = warped * warp_w + a * (1.0 - warp_w)
            if c.get("has_prior"):
                if "prior" in c:
                    cx, cy, rx, ry = [float(v) for v in c["prior"]]
                    box = (cx - rx / 1.12, cy - ry / 1.4, cx + rx / 1.12, cy + ry / 1.4)
                    prior = JO.face_prior_oracle(box, mw, mh, mw, mh)
                else:
                    prior = c["prior_plane"].astype(np.float64)
        prev, a = JO.ema_oracle(prev, a, JC.DEFAULT_EMA)
        a = JO.opening_oracle(a)
        a = JO.closing_in_prior_oracle(a, prior)
        guide = np.floor(JO.resize_bilinear_tfjs_oracle(frames[t].astype(np.float64), mh, mw)
                         + 0.5)
        a = JO.bilateral_oracle(a, guide, JC.DEFAULT_BILATERAL_SIGMA_SPATIAL,
                                JC.DEFAULT_BILATERAL_SIGMA_RANGE)
        out[t] = JO.refine_oracle(a, JC.DEFAULT_NOISE_CUTOFF, JC.DEFAULT_HIGH_THRESHOLD,
                                  JC.DEFAULT_GAMMA, prior)
    return out


def _inputs(rng, n=4):
    masks = rng.random((n,) + MASK_HW).astype(np.float32)
    frames = rng.integers(0, 256, (n, 30, 50, 3), dtype=np.uint8)
    return masks, frames


def test_oracle_chain_without_the_face_path(rng):
    masks, frames = _inputs(rng)
    got = PM.oracle_chain(masks, frames, MASK_HW)
    assert got.tobytes() == reference_chain(masks, frames, MASK_HW).tobytes()


def test_oracle_chain_with_captured_face_evidence(rng):
    """An affine from the second frame on, the analytic prior on two frames
    and a prior plane on one."""
    masks, frames = _inputs(rng)
    plane = rng.random(MASK_HW) * (rng.random(MASK_HW) > 0.5)
    caps = [{"has_affine": False, "affine": np.zeros(6)},
            {"has_affine": True, "affine": np.asarray([1.02, 0.01, 1.4, -0.02, 0.99, -0.8]),
             "has_prior": True, "prior": np.asarray([9.5, 6.0, 5.0, 4.0], np.float32)},
            {"has_affine": True, "affine": np.asarray([1.0, 0.0, -2.0, 0.0, 1.0, 1.0]),
             "has_prior": True, "prior_plane": plane},
            {"has_affine": True, "affine": np.asarray([0.97, 0.0, 0.5, 0.0, 1.03, 0.0]),
             "has_prior": True, "prior": np.asarray([4.0, 3.0, 6.0, 5.0], np.float32)}]
    got = PM.oracle_chain(masks, frames, MASK_HW, caps=caps, warp_w=0.35)
    want = reference_chain(masks, frames, MASK_HW, caps=caps, warp_w=0.35)
    assert got.tobytes() == want.tobytes()
    assert not np.array_equal(got, PM.oracle_chain(masks, frames, MASK_HW))


def test_run_with_capture_keys():
    """The face engine on a featured clip at 80x160: a capture a frame with
    the reference's keys, the masks at the mask geometry."""
    eng = PM.build_engine(face=True, frame_hw=(80, 160), mask_hw=(32, 64), device="cpu")
    clip = articulated_clip(4, (80, 160), seed=3, features=True, wave=True, occluder_p=0.0,
                            device="cpu")
    masks, caps = PM.run_with_capture(eng, clip)
    assert masks.shape == (4, 32, 64) and masks.dtype == np.float32
    assert len(caps) == 4
    for c in caps:
        assert set(c) == {"affine", "has_affine", "prior", "has_prior", "face_applied",
                          "det_score"}
        assert c["affine"].shape == (6,) and c["affine"].dtype == np.float64
        assert c["prior"].shape == (4,)
        assert isinstance(c["has_affine"], bool) and isinstance(c["det_score"], float)
    assert not caps[0]["has_affine"]  # the first frame: no state yet


def test_flicker(rng):
    m = rng.random((5, 8, 9))
    b = m > 0.5
    assert TA.flicker(m) == float(np.logical_xor(b[1:], b[:-1]).mean())
    assert TA.flicker(m[:1]) == 0.0
    assert TA.flicker(np.ones((3, 4, 4))) == 0.0


@pytest.fixture(scope="module")
def photos(tmp_path_factory):
    d = tmp_path_factory.mktemp("photos")
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:270, 0:480] / 270.0
    for i in range(2):
        base = rng.random(3) * 180 + 40
        img = base * (0.7 + 0.3 * np.sin(xx[..., None] * (3 + i) + yy[..., None] * 2))
        Image.fromarray(np.clip(img + rng.normal(0, 6, img.shape), 0, 255)
                        .astype(np.uint8)).save(d / f"photo{i}.png")
    return d


def test_parity_matting_small_report(photos, tmp_path):
    rep = PM.main(["--photos", str(photos), "--small", "--frames", "6", "--oracle-frames", "1",
                   "--device", "cpu", "--report", str(tmp_path / "r.json")])
    assert list(rep) == REPORT_KEYS
    assert (tmp_path / "r.json").exists()
    assert rep["clips"] == {"n": 4, "frames_per_clip": 6, "frame_hw": [240, 320],
                            "mask_hw": [96, 128], "oracle_frames": 1}
    for k in REPORT_KEYS[5:]:
        assert PARITY_KEYS <= set(rep[k]), k
    assert rep["int8_vs_float_pipeline"]["frames"] == 24
    assert {"prior_fired_frames", "affine_applied_frames"} <= set(rep["engine_vs_oracle_face_path"])


def test_tune_adaptive_ema_small(photos):
    """Two adapts at a moved gate; runtime/config.py's gate is put back."""
    res = TA.main(["--photos", str(photos), "--small", "--frames", "6", "--adapts", "0,1",
                   "--t0", "0.05", "--t1", "0.25", "--device", "cpu"])
    assert list(res) == ["adapt=0.0", "adapt=1.0"]
    for r in res.values():
        assert set(r) == {"iou_mean", "iou_min", "iou_p05", "temporal_stability", "flicker",
                          "per_clip"}
        assert len(r["per_clip"]) == 4
        assert all(set(p) == {"iou", "min", "stab", "flicker"} for p in r["per_clip"])
    assert (TC.EMA_ADAPT_T0, TC.EMA_ADAPT_T1) == (0.10, 0.40)


def test_diag_realistic_clips_small(photos):
    rep = DG.main(["--photos", str(photos), "--small", "--frames", "6", "--device", "cpu"])
    assert list(rep) == [*DG.CLIP_NAMES, "worst"]
    for name in DG.CLIP_NAMES:
        assert set(rep[name]) == {"full_mean", "full_min", "model_mean", "model_min"}
    assert set(rep["worst"]) == {"worst_clip", "mean", "worst_frame"}
    assert rep["worst"]["worst_clip"] in DG.CLIP_NAMES


def test_diag_realistic_clips_against_the_reference(photos):
    """``diagnose`` at ``--small`` with 6 frames against the reference's
    composition of the same steps (tools/diag_realistic_clips.py: one float
    ``fast_int8_pico`` engine, the four clips back to back on its one
    stream, each clip's masks against its alpha resized asymmetric): the
    JAX Engine on the same clips with the committed float pico tree
    (bridge.py), each clip's full_mean and full_min within 0.02
    (tests/test_torch_gates.py's bar).  That bar does not see a stream
    made cold between clips (at this size it moves a figure by 0.014 at
    most), so the port must also lie nearer the back-to-back reference
    than the same reference with each clip cold."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from video_stream_segmenetation_tpu import models as JM
    from video_stream_segmenetation_tpu import ops as JOps
    from video_stream_segmenetation_tpu import utils as JU
    from video_stream_segmenetation_tpu.runtime.pipeline import ModelBundle
    from video_stream_segmenetation_tpu.runtime.presets import preset as jax_preset
    from video_stream_segmenetation_tpu.service import Engine as JaxEngine
    from video_stream_segmenetation_tpu_torch import bridge

    frame_hw, mask_hw, _, _ = PM.GEOMETRY[True]
    got = DG.diagnose(photos, small=True, n_frames=6, device="cpu")
    statics = dataclasses.replace(
        jax_preset("fast_int8_pico"), frame_hw=frame_hw, mask_hw=mask_hw, background="color",
        face_path=False, fd_size=64, lmk_size=48, matting_precision="bf16")
    tree = jax.tree_util.tree_map(
        jnp.asarray, bridge.load_export(bridge.WEIGHTS_DIR / "mattenet_hd10_pico_f32.npz"))
    matte = JM.MatteNetHD(stem_stride=statics.s2d_block,
                          head_upsample=mask_hw[0] // -(-frame_hw[0] // statics.s2d_block),
                          decoder=statics.matting_decoder)
    eng = JaxEngine(num_streams=1, statics=statics, bundle=ModelBundle(matte, tree),
                    donate_state=False)
    clips, face_clip = PM.clips_of(photos, frame_hw, 6, "cpu")

    def reference(cold: bool) -> dict:
        eng.evict(0)
        eng.admit()
        figures = {}
        for name, c in zip(DG.CLIP_NAMES, clips + [face_clip]):
            if cold:
                eng.evict(0)
                eng.admit()
            alpha = np.asarray(c.alpha, np.float32)
            gt = np.asarray(JOps.resize_bilinear(jnp.asarray(alpha)[..., None], mask_hw,
                                                 method="asymmetric")[..., 0])
            iou = JU.mask_iou(JU.run_clip_through_engine(
                eng, JU.SyntheticClip(frames=np.asarray(c.frames), alpha=alpha)), gt)
            figures[name] = (float(iou.mean()), float(iou.min()))
        return figures

    def gaps(ref: dict) -> list:
        return [abs(got[n][k] - ref[n][i]) for n in DG.CLIP_NAMES
                for i, k in enumerate(("full_mean", "full_min"))]

    back_to_back = gaps(reference(cold=False))
    assert max(back_to_back) <= 0.02, back_to_back
    assert sum(back_to_back) < sum(gaps(reference(cold=True)))
