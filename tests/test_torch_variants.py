"""The reference's alternative pipelines in the port against the JAX package
on the CPU: the ops they add (``hole_filling_ema``, ``warp_translate``,
``warp_affine_separable``, ``binarize_alpha``), the refine routing of
``make_step`` (read from the reference step's closure), what
``check_statics`` serves and refuses, every route of the refine stages
step by step (each blend x temporal filter x morphology case, the fused
refine after an eager prefix, ``use_fused_refine=False``) and the
translation tracking of ``blaze_tracking``.

Geometry as tests/test_presets.py: 80x160 frames, 32x64 masks.  The step
comparisons take a stand-in matting model on both sides (the alpha is the
green channel of the resized frame, exact in f32) and the same face
outputs (the face subpath replaced on both sides), so that every stage
after the model is held on the same inputs.

Tolerances, with their reasons:
* the ops: the same f32 operations, held exactly;
* the steps: the same f32 stages; the alpha and new_prev within 2e-5 (the
  bilateral's exponentials and the gamma's pow differ by ulps between XLA
  and PyTorch, as the refine bodies are held), the composited frame within
  one u8 step (its upsample in f32 on both sides), the affine within 1e-6
  (XLA fuses the low-pass's multiply-add: an ulp), the flags exactly;
* the translation subpath with a stand-in detector: exactly; with the
  trained detector (bf16): the decisions equal, the score within 1e-2,
  the centre within one mask pixel.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu import ops as jops
from video_stream_segmenetation_tpu.runtime import pipeline as JPL
from video_stream_segmenetation_tpu.runtime.config import default_knobs as jax_knobs
from video_stream_segmenetation_tpu.runtime.pipeline import ModelBundle
from video_stream_segmenetation_tpu.runtime.presets import preset as jax_preset
from video_stream_segmenetation_tpu.runtime.state import StreamState as JaxState
from video_stream_segmenetation_tpu_torch.ops import composite as TC
from video_stream_segmenetation_tpu_torch.ops import prior as TP
from video_stream_segmenetation_tpu_torch.ops import temporal as TT
from video_stream_segmenetation_tpu_torch.ops import warp as TW
from video_stream_segmenetation_tpu_torch.runtime import pipeline as TPL
from video_stream_segmenetation_tpu_torch.runtime.config import default_knobs
from video_stream_segmenetation_tpu_torch.runtime.presets import list_presets, preset
from video_stream_segmenetation_tpu_torch.runtime.state import init_state

T = torch.tensor
S = 2
FH, FW, MH, MW = 80, 160, 32, 64
GEOM = dict(frame_hw=(FH, FW), mask_hw=(MH, MW), fd_size=64, lmk_size=48)
ALPHA_TOL = 2e-5
PREV_TOL = 2e-5
AFFINE_TOL = 1e-6


# ---- the ops ------------------------------------------------------------------


def test_hole_filling_ema_matches(rng):
    """Holes (current < 0.1 under prev > 0.3) keep prev * 0.9, elsewhere
    the EMA, the first frame copied; exact."""
    prev = rng.random((3, 16, 24), dtype=np.float32)
    cur = rng.random((3, 16, 24), dtype=np.float32)
    cur[:, ::3] *= 0.15  # plenty of holes
    ema = np.asarray([0.55, 0.9, 0.2], np.float32)
    init = np.asarray([True, True, False])
    want = jops.hole_filling_ema(jnp.asarray(prev), jnp.asarray(cur), jnp.asarray(ema),
                                 jnp.asarray(init))
    got = TT.hole_filling_ema(T(prev), T(cur), T(ema), T(init))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    holes = (cur < 0.1) & (prev > 0.3)
    assert holes[:2].any()
    np.testing.assert_array_equal(got[0].numpy()[2], cur[2])


@pytest.mark.parametrize("per_stream", [True, False], ids=["per_stream", "scalar"])
def test_warp_translate_matches(rng, per_stream):
    """Truncated toward zero (the JS ``| 0``), out of range reads 0: a
    shift a stream, or one shift of one plane."""
    if per_stream:
        src = rng.random((3, 20, 36), dtype=np.float32)
        dx, dy = np.asarray([2.7, -3.9, 40.0], np.float32), np.asarray([-1.2, 5.99, 0.0],
                                                                       np.float32)
    else:
        src = rng.random((20, 36), dtype=np.float32)
        dx, dy = np.float32(-4.5), np.float32(2.2)
    want = np.asarray(jops.warp_translate(jnp.asarray(src), jnp.asarray(dx), jnp.asarray(dy)))
    got = TW.warp_translate(T(src), T(dx), T(dy)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0).any() and (got != 0).any()


def test_warp_affine_separable_matches(rng):
    src = rng.random((4, 32, 64), dtype=np.float32)
    aff = np.asarray([[1.05, 0.02, 2.5, -0.02, 0.97, -1.5], [1, 0, 0, 0, 1, 0],
                      [1.0, 0, 30.0, 0, 1.0, 12.0], [0.9, 0.1, -1.0, 0.0, 1.1, 3.0]],
                     np.float32)
    want = np.asarray(jops.warp_affine_separable(jnp.asarray(src), jnp.asarray(aff)))
    np.testing.assert_array_equal(TW.warp_affine_separable(T(src), T(aff)).numpy(), want)


def test_binarize_alpha_matches(rng):
    a = rng.random((2, 8, 8), dtype=np.float32)
    a[0, 0, :3] = (0.5, np.nextafter(np.float32(0.5), np.float32(0)), 1.0)
    want = np.asarray(jops.binarize_alpha(jnp.asarray(a)))
    got = TC.binarize_alpha(T(a))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(TC.binarize_alpha(T(a), 0.8).numpy(),
                                  np.asarray(jops.binarize_alpha(jnp.asarray(a), 0.8)))


# ---- routing and what is served ------------------------------------------------

# (preset, overrides): the port serves 'auto' as the fused refine on; the
# reference resolves it off a TPU, so its side takes use_fused_refine=True
# unless the case sets it
ROUTES = {
    "active": ("active", {}),
    "active_unfused": ("active", {"use_fused_refine": False}),
    "active_exact": ("active", {"warp_impl": "exact"}),
    "active_plane": ("active", {"prior_impl": "plane"}),
    "active_max": ("active", {"warp_blend_mode": "max"}),
    "active_hole": ("active", {"temporal_filter": "hole_fill"}),
    "active_none": ("active", {"temporal_filter": "none"}),
    "active_morph_off": ("active", {"morphology": False}),
    "blaze_tracking": ("blaze_tracking", {}),
    "branch": ("branch", {}),
    "rvm": ("rvm", {}),
    "u2": ("u2", {"mask_hw": (40, 40)}),
    "pico_unfused": ("fast_int8_pico", {"use_fused_refine": False}),
    "pico_unfused_fast": ("fast_int8_pico", {"use_fused_refine": False,
                                             "refine_alpha_src": "lowres",
                                             "guide_kernel_unfold": True,
                                             "guide_source": "host"}),
    "fast_int8_unfused": ("fast_int8", {"use_fused_refine": False}),
    "nano": ("fast_int8_nano", {}),
    "femto": ("fast_int8_femto", {}),
}


def _jax_model_for(st):
    from video_stream_segmenetation_tpu import models as jm

    if st.frame_layout == "s2d":
        return jm.QuantizedMatteNetHD(10, st.mask_hw[0] // 8, decoder=st.matting_decoder)
    return jm.MatteNet()


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_refine_routing_matches_reference(case):
    """use_fused, use_fused_tr, analytic_prior and the fast refine's four
    switches equal the reference make_step's, read from its closure."""
    name, over = ROUTES[case]
    geom = dict(GEOM, **({"mask_hw": over["mask_hw"]} if "mask_hw" in over else {}))
    over = {k: v for k, v in over.items() if k != "mask_hw"}
    jover = dict(over)
    jover.setdefault("use_fused_refine", True)
    jst = jax_preset(name, **jover, **geom)
    step = JPL.make_step(ModelBundle(_jax_model_for(jst), None), jst)
    cells = dict(zip(step.__code__.co_freevars, (c.cell_contents for c in step.__closure__)))
    st = preset(name, **over, **geom)
    TPL.check_statics(st)
    got = TPL.refine_routing(st)
    want = {k: bool(cells[k]) for k in ("use_fused", "use_fused_tr", "analytic_prior")}
    assert {k: bool(v) for k, v in got.items()} == want
    from video_stream_segmenetation_tpu_torch.service.engine import Engine

    fast = Engine(1, st, device="cpu").routing
    assert {k: bool(v) if k != "lane_geom" else v for k, v in fast.items()} == \
        {k: bool(cells[k]) if k != "lane_geom" else (tuple(cells[k]) if cells[k] else None)
         for k in ("use_lowres_alpha", "use_guide_lanes", "lane_geom", "host_lanes")}


SIX = ("fast_int8_nano", "fast_int8_femto", "blaze_tracking", "branch", "rvm", "u2")


def test_presets_as_the_reference_defines_them():
    """Every preset the port lists equals the reference's on every field
    the port's statics have."""
    fields = [f.name for f in dataclasses.fields(preset("active"))]
    for name in list_presets():
        ref = jax_preset(name)
        ours = preset(name)
        for f in fields:
            assert getattr(ours, f) == getattr(ref, f), (name, f)
    assert set(SIX) <= set(list_presets())


def test_check_statics_serves_the_six_and_refuses_three():
    """The six presets, fast and multiclass are served as they stand, and
    use_fused_refine=False on every single-class route (fast's included);
    every one of the reference's presets is served now (the last refused
    one, fast_int8_pico_refface, too: tests/test_torch_refface.py)."""
    for name in SIX + ("fast", "multiclass"):
        TPL.check_statics(preset(name))
    for name in list_presets():
        st = preset(name)
        TPL.check_statics(st)
        if st.num_classes == 1:
            TPL.check_statics(dataclasses.replace(st, use_fused_refine=False))


@pytest.mark.parametrize("override", [
    {"face_tracking": "optical_flow"}, {"matting_arch": "recurrent"},
    {"matting_arch": "saliency"}, {"temporal_filter": "median"}, {"warp_blend_mode": "min"}])
def test_check_statics_refuses_what_stays_unserved(override):
    """The recurrent and saliency models on the s2d layout, and values the
    reference does not have, are refused by name (translation tracking on
    the s2d layout is served: tests/test_torch_face_sources.py)."""
    with pytest.raises(NotImplementedError, match=next(iter(override))):
        TPL.check_statics(preset("fast_int8_pico", **override, **GEOM))


# ---- the refine stages, step by step ----------------------------------------------


class _JaxGreen(nn.Module):
    """The stand-in matting model: alpha = the resized frame's green."""

    @nn.compact
    def __call__(self, x, train=False):
        return {"alpha": x[..., 1].astype(jnp.float32)}


class _TorchGreen(torch.nn.Module):
    def forward(self, x):
        return {"alpha": x[..., 1].to(torch.float32)}


# (overrides of active): each route of the refine stages
CHAIN = {
    # the unfused chain with morphology and the prior (the reference's CPU
    # default for active)
    "unfused": {"use_fused_refine": False},
    "unfused_exact": {"use_fused_refine": False, "warp_impl": "exact"},
    "unfused_max_hole": {"use_fused_refine": False, "warp_blend_mode": "max",
                         "temporal_filter": "hole_fill"},
    "unfused_none": {"use_fused_refine": False, "temporal_filter": "none"},
    # morphology off: the chain whatever use_fused_refine says
    "lerp_ema": {"morphology": False},
    "max_ema": {"morphology": False, "warp_blend_mode": "max"},
    "lerp_hole": {"morphology": False, "temporal_filter": "hole_fill"},
    "max_hole": {"morphology": False, "warp_blend_mode": "max", "temporal_filter": "hole_fill",
                 "warp_blend_weight": 0.75},
    "lerp_none": {"morphology": False, "temporal_filter": "none"},
    "max_none": {"morphology": False, "warp_blend_mode": "max", "temporal_filter": "none"},
    "exact_max": {"morphology": False, "warp_impl": "exact", "warp_blend_mode": "max"},
    # the fused refine (stages 5/7/8/9) after the eager warp, blend, filter
    "fused_max": {"warp_blend_mode": "max"},
    "fused_hole": {"temporal_filter": "hole_fill"},
    "fused_none": {"temporal_filter": "none"},
    # translation tracking: the zero prior, the one-shot affine merge
    "translation": {"face_tracking": "translation", "morphology": False},
}
# the affine state going in: stream 0 a scale and shift with a small
# rotation (the separable warp drops it, the exact warp keeps it), stream 1
# a pure shift
AFFINE0 = np.asarray([[1.04, 0.03, 2.6, -0.03, 0.98, -1.7], [1.0, 0, -3.0, 0, 1.0, 2.0]],
                     np.float32)


def _forced_face(rng, translation):
    """The face outputs both steps take: stream 0 with a prior plane and
    an update, stream 1 with neither."""
    box = np.asarray([[40.0, 10.0, 95.0, 70.0], [0.0, 0.0, 1.0, 1.0]], np.float32)
    prior = TP.face_prior_mask(T(box), (FH, FW), (MH, MW)).numpy()
    prior[1] = 0
    has_prior = np.asarray([True, False])
    if translation:
        upd = np.asarray([[1, 0, 3.0, 0, 1, -2.0], [1, 0, 0, 0, 1, 0]], np.float32)
    else:
        upd = np.asarray([[1.02, 0.01, 1.5, -0.01, 1.02, -0.5], [1, 0, 0, 0, 1, 0]],
                         np.float32)
    return prior, has_prior, upd, np.asarray([True, False]), np.asarray([0.9, 0.0], np.float32)


def _chain_inputs(rng):
    frames = [rng.integers(0, 256, (S, FH, FW, 3), dtype=np.uint8) for _ in range(2)]
    bgs = rng.integers(0, 256, (S, FH, FW, 3), dtype=np.uint8)
    prev = rng.random((S, MH, MW), dtype=np.float32)
    return frames, bgs, prev


@pytest.mark.parametrize("case", sorted(CHAIN))
def test_refine_route_matches_reference_step(case, monkeypatch):
    """Two steps of the port's make_step against the reference's (jitted;
    its fused refine in interpret mode), the same stand-in model and face
    outputs: alpha, new_prev, the composited frame, the affine merge."""
    over = CHAIN[case]
    translation = over.get("face_tracking") == "translation"
    rng = np.random.default_rng(5)
    frames, bgs, prev = _chain_inputs(rng)
    prior, has_prior, upd, has_upd, score = _forced_face(rng, translation)
    centre = (np.asarray([[20.0, 15.0], [3.0, 4.0]], np.float32), np.asarray([True, False]))

    def jax_face(*a, **k):
        return (jnp.asarray(prior), jnp.asarray(has_prior), jnp.asarray(upd),
                jnp.asarray(has_upd), jnp.asarray(score))

    def jax_translation(*a, **k):
        return (jnp.asarray(upd), jnp.asarray(has_upd), jnp.asarray(score),
                jnp.asarray(centre[0]), jnp.asarray(centre[1]))

    monkeypatch.setattr(JPL, "_face_subpath_compact", jax_face)
    monkeypatch.setattr(JPL, "_face_translation_subpath", jax_translation)
    monkeypatch.setattr(TPL, "face_subpath_compact",
                        lambda *a, **k: tuple(T(x) for x in (prior, has_prior, upd, has_upd,
                                                              score)))
    monkeypatch.setattr(TPL, "face_translation_subpath",
                        lambda *a, **k: (T(upd), T(has_upd), T(score), T(centre[0]),
                                         T(centre[1])))
    jover = dict(over)
    jover.setdefault("use_fused_refine", True)
    # the composite's upsample in f32 on both sides: the stand-in alpha is
    # noise, where the bf16 pass moves more than one u8 step
    jst = jax_preset("active", **jover, **GEOM, upsample_precision="exact")
    bundle = ModelBundle(_JaxGreen(), {}, face_model=object())
    jstep = jax.jit(JPL.make_step(bundle, jst))
    st = preset("active", **over, **GEOM, upsample_precision="exact")
    tstep = TPL.make_step(_TorchGreen(), st, TPL.FaceModels(None, None))

    jstate = JaxState(prev_alpha=jnp.asarray(prev), affine=jnp.asarray(AFFINE0),
                      has_affine=jnp.asarray([True, True]),
                      initialized=jnp.asarray([True, False]),
                      frame_idx=jnp.zeros((S,), jnp.int32), rec=(),
                      face_center=jnp.zeros((S, 2), jnp.float32),
                      has_center=jnp.zeros((S,), bool))
    tstate = dataclasses.replace(init_state(S, (MH, MW), device="cpu"), prev_alpha=T(prev),
                                 affine=T(AFFINE0), has_affine=T([True, True]),
                                 initialized=T([True, False]))
    jk = jax_knobs(S, ema_adapt=0.0)
    jk = dataclasses.replace(jk, ema_adapt=jnp.asarray([1.0, 0.0], jnp.float32),
                             use_bilateral=jnp.asarray([True, False]))
    tk = default_knobs(S)
    tk.ema_adapt = T([1.0, 0.0])
    tk.use_bilateral = T([True, False])
    gate = np.ones((S,), bool)
    for t, f in enumerate(frames):
        jstate, jout = jstep({"matte": {}, "face": None, "lmk": None}, jstate, jnp.asarray(f),
                             jnp.asarray(bgs), jk, jnp.asarray(gate))
        tstate, tout = tstep(tstate, T(f), T(bgs), tk, T(gate))
        assert tout["alpha"].dtype == torch.float32
        np.testing.assert_allclose(tout["alpha"].numpy(), np.asarray(jout["alpha"]), rtol=0,
                                   atol=ALPHA_TOL, err_msg=f"step {t}")
        np.testing.assert_allclose(tstate.prev_alpha.numpy(), np.asarray(jstate.prev_alpha),
                                   rtol=0, atol=PREV_TOL, err_msg=f"step {t}")
        diff = np.abs(tout["frame"].numpy().astype(np.int32)
                      - np.asarray(jout["frame"]).astype(np.int32))
        assert diff.max() <= 1, f"step {t}"
        for k in ("has_affine", "initialized", "frame_idx", "face_center", "has_center"):
            np.testing.assert_array_equal(getattr(tstate, k).numpy(),
                                          np.asarray(getattr(jstate, k)), err_msg=k)
        np.testing.assert_allclose(tstate.affine.numpy(), np.asarray(jstate.affine), rtol=0,
                                   atol=AFFINE_TOL)
        np.testing.assert_array_equal(tout["face_applied"].numpy(), has_upd)
    if translation:
        # the update applied once, then identity where no update came
        np.testing.assert_array_equal(tstate.affine.numpy()[1], [1, 0, 0, 0, 1, 0])
        assert not bool(tstate.has_affine[1])
    a = tout["alpha"].numpy()
    assert 0.05 < a.mean() < 0.95 and a.std() > 0.05


# ---- translation tracking ------------------------------------------------------

ANCHORS = 12


class _JaxDet(nn.Module):
    boxes: tuple
    scores: tuple

    @nn.compact
    def __call__(self, x):
        s = x.shape[0]
        return {"box_coords": jnp.broadcast_to(jnp.asarray(self.boxes), (s, ANCHORS, 16)),
                "box_scores": jnp.broadcast_to(jnp.asarray(self.scores), (s, ANCHORS))}


class _TorchDet(torch.nn.Module):
    def __init__(self, boxes, scores):
        super().__init__()
        self.boxes, self.scores = T(boxes), T(scores)

    def forward(self, x):
        s = x.shape[0]
        return {"box_coords": self.boxes.expand(s, ANCHORS, 16),
                "box_scores": self.scores.expand(s, ANCHORS)}


def test_translation_subpath_matches_with_a_stand_in_detector(rng):
    """The same detections into both: the box decode without letterbox,
    the centre with the JS round and clamp, the gated delta times the gain,
    truncated, the new centre; exactly."""
    boxes = np.zeros((ANCHORS, 16), np.float32)
    boxes[:, 0:2] = rng.random((ANCHORS, 2), dtype=np.float32) * 0.5
    boxes[:, 2:4] = boxes[:, 0:2] + 0.1 + rng.random((ANCHORS, 2), dtype=np.float32) * 0.4
    boxes[3, :4] = (0.3125, 0.25, 0.6875, 0.8125)  # the best: a centre on a half pixel
    scores = rng.random(ANCHORS, dtype=np.float32) * 0.5
    scores[3] = 0.8
    s = 4
    jst = jax_preset("blaze_tracking", **GEOM)
    st = preset("blaze_tracking", **GEOM)
    frames = rng.integers(0, 256, (s, FH, FW, 3), dtype=np.uint8)
    centre = np.asarray([[30.0, 10.0], [0.0, 0.0], [63.0, 31.0], [12.5, 7.0]], np.float32)
    has_c = np.asarray([True, False, True, True])
    idx = np.asarray([0, 0, 1, 0], np.int32)
    gate = np.asarray([True, True, True, False])
    jstate = JaxState(prev_alpha=jnp.zeros((s, MH, MW)), affine=jnp.zeros((s, 6)),
                      has_affine=jnp.zeros((s,), bool), initialized=jnp.zeros((s,), bool),
                      frame_idx=jnp.asarray(idx), face_center=jnp.asarray(centre),
                      has_center=jnp.asarray(has_c))
    bundle = ModelBundle(None, None, _JaxDet(tuple(map(tuple, boxes)), tuple(scores)), {})
    want = JPL._face_translation_subpath(bundle, bundle.params,
                                         jnp.asarray(frames, jnp.float32) / 255.0, jstate,
                                         jst, jnp.asarray(gate))
    tstate = dataclasses.replace(init_state(s, (MH, MW), device="cpu"), frame_idx=T(idx),
                                 face_center=T(centre), has_center=T(has_c))
    got = TPL.face_translation_subpath(_TorchDet(boxes, scores), T(frames), tstate, st, T(gate))
    for g, w, name in zip(got, want, ("affine_update", "has_update", "det_score", "centre",
                                      "has_centre")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    # lmk_interval=1: every gated stream fires; the first stream moves
    assert got[1].numpy().tolist() == [True, False, True, False]
    assert got[0][0, 2] != 0 or got[0][0, 5] != 0


def test_translation_subpath_with_the_trained_detector():
    """The trained FaceFinder on rendered people at fd 64: the same
    decisions, the score within 1e-2, the centre within one mask pixel."""
    from pathlib import Path

    from video_stream_segmenetation_tpu import models as jm
    from video_stream_segmenetation_tpu.utils.checkpoint import restore_params
    from video_stream_segmenetation_tpu.utils.clips import articulated_clip
    from video_stream_segmenetation_tpu_torch import bridge
    from video_stream_segmenetation_tpu_torch.models.blazeface import FaceFinder

    root = Path(__file__).resolve().parents[1]
    tree = jax.tree_util.tree_map(np.asarray, restore_params(str(root / "checkpoints/facefinder")))
    frames = np.stack([articulated_clip(n_frames=2, hw=(FH, FW), seed=sd, features=True)
                       .frames[1] for sd in (2, 1)])
    jst = jax_preset("blaze_tracking", **GEOM)
    st = preset("blaze_tracking", **GEOM)
    centre = np.asarray([[30.0, 12.0], [10.0, 20.0]], np.float32)
    jstate = JaxState(prev_alpha=jnp.zeros((S, MH, MW)), affine=jnp.zeros((S, 6)),
                      has_affine=jnp.zeros((S,), bool), initialized=jnp.zeros((S,), bool),
                      frame_idx=jnp.zeros((S,), jnp.int32), face_center=jnp.asarray(centre),
                      has_center=jnp.ones((S,), bool))
    bundle = ModelBundle(None, None, jm.FaceFinder(input_size=64),
                         jax.tree_util.tree_map(jnp.asarray, tree))
    sub = jax.jit(lambda p, f, state, g: JPL._face_translation_subpath(bundle, p, f, state,
                                                                      jst, g))
    want = sub(bundle.params, jnp.asarray(frames, jnp.float32) / 255.0, jstate,
               jnp.ones((S,), bool))
    tstate = dataclasses.replace(init_state(S, (MH, MW), device="cpu"),
                                 face_center=T(centre),
                                 has_center=T([True, True]))
    got = TPL.face_translation_subpath(FaceFinder(bridge.float_tree(tree), 64, device="cpu"),
                                       T(frames),
                                       tstate, st, T([True, True]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    assert np.asarray(want[1]).any()
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0, atol=1e-2)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=0, atol=1.0)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1.0)
