"""The port's multi-class serving (multiclass_fast_pico, multiclass_fast)
against the JAX package: the K-class plain trunk (the CUDA trunk's plain
version) against the Pallas megakernel's K-class form in interpret mode
and the reference's XLA int8 head, the trained K=4 checkpoints on the
committed 720p frames, the packed per-class composite, the planar blur,
the two Engines over 8 seeded steps and over 3 trained steps at 720p, and
what check_statics refuses.  Inputs are made from seeds with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stream_segmenetation_tpu import models, ops
from video_stream_segmenetation_tpu.kernels.trunk_int8 import (
    fused_nano_trunk_alpha,
    fused_nano_trunk_alpha_q,
)
from video_stream_segmenetation_tpu.models import quantized as JQ
from video_stream_segmenetation_tpu.ops.blur import (
    gaussian_blur_planar_mxu as jax_blur_planar,
)
from video_stream_segmenetation_tpu.runtime.presets import preset as jax_preset
from video_stream_segmenetation_tpu.service import Engine as JaxEngine
from video_stream_segmenetation_tpu.utils.checkpoint import restore_params
from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.kernels import trunk_int8 as TK
from video_stream_segmenetation_tpu_torch.models import quantized as TQ
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import init_params
from video_stream_segmenetation_tpu_torch.ops.blur import gaussian_blur_planar_mxu
from video_stream_segmenetation_tpu_torch.ops.layout import multiclass_composite_s2d
from video_stream_segmenetation_tpu_torch.runtime.presets import preset
from video_stream_segmenetation_tpu_torch.service.engine import Engine

SS = 10
FH, FW = 80, 160  # stem grid 8x16
MC_CKPT = {"pico": "checkpoints/mattenet_hd10_mc_pico", "nano": "checkpoints/mattenet_hd10_mc"}
PRESET_PLAN = {"multiclass_fast_pico": "pico", "multiclass_fast": "nano"}


def _npt(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_q(plan, k, seed=0):
    model = models.MatteNetHD(stem_stride=SS, head_upsample=4, num_classes=k, decoder=plan)
    return JQ.quantize_mattenet_hd(model, model.init(jax.random.PRNGKey(seed),
                                                     jnp.zeros((1, FH, FW, 3))))


def _stem_x0(q, xp):
    """The reference's bf16 stem on packed frames -> s8 x0."""
    y = jnp.asarray(xp).astype(jnp.bfloat16) @ q["stem_w"]
    return np.asarray(JQ._requant(y.astype(jnp.float32) + q["stem_b"]))


def _split_conv_up(small, skip, layer):
    ca = small.shape[-1]
    la = {"wq": layer["wq"][:, :, :ca], "mult": layer["mult"], "bias": layer["bias"]}
    lb = {"wq": layer["wq"][:, :, ca:], "mult": layer["mult"],
          "bias": jnp.zeros_like(layer["bias"])}
    return JQ._requant(JQ._nearest_x2(JQ._conv_i8(small, la)) + JQ._conv_i8(skip, lb))


def _xla_logits(q, x0):
    """The reference's XLA int8 graph of the pico/nano plans
    (models/quantized.py, decoder_impl='xla', head_impl='int8') up to the
    K-class head's logits."""
    x0 = jnp.asarray(x0)
    d2 = JQ._qconv(JQ._requant(JQ._conv_i8(x0, q["d2dn"], strides=(2, 2))), q["d2b"], "xla")
    d3 = JQ._qconv(JQ._requant(JQ._conv_i8(d2, q["d3dn"], strides=(2, 2))), q["d3b"], "xla")
    ctx_f = jax.nn.relu6(JQ._conv_i8(d3, q["ctx"], dilation=(3, 3))
                         + d3.astype(jnp.float32) * JQ.ACT_SCALE)
    ctx_f = JQ._se_f32(ctx_f, q["ctxse/Dense_0"], q["ctxse/Dense_1"])
    ctx = jnp.round(jnp.clip(ctx_f, 0.0, 6.0) * (127.0 / 6.0)).astype(jnp.int8)
    u1 = _split_conv_up(_split_conv_up(ctx, d2, q["u2red"]), x0, q["u1red"])
    return np.asarray(JQ._conv_i8(u1, q["alpha_q"]))


# ---- the K-class trunk -----------------------------------------------------


@pytest.mark.parametrize("plan,k", [("pico", 3), ("pico", 4), ("nano", 3), ("nano", 4)])
def test_k_class_plain_trunk_matches_reference(rng, plan, k):
    """Seeded weights, frame 80x160 (stem grid 8x16).  The logits
    [S, H, W, K] come out class for class as the Pallas kernel's K-class
    form unfolds its quad columns (qo*K + k), and equal its XLA int8 head:
    exact s32 sums and the same f32 epilogue on all sides, the SE in
    float64 (port) and f32 (reference) picking the same lattice steps
    here.  K = 3 as well as 4, so that a transposed class axis cannot pass
    by symmetry.  Tolerance 1e-5."""
    q = _jax_q(plan, k, seed=k)
    xp = rng.integers(0, 256, (2, FH // SS, FW // SS, SS * SS * 3), dtype=np.uint8)
    x0 = _stem_x0(q, xp)
    tp = TQ.trunk_params(bridge.load_quantized(_npt(q)))
    assert TQ.plan_of(tp) == plan and TQ.num_classes_of(tp) == k
    got = TK.fused_nano_trunk_alpha(torch.tensor(x0), tp).numpy()
    assert got.shape == (2, 8, 16, k) and got.dtype == np.float32
    xla = _xla_logits(q, x0)
    np.testing.assert_allclose(got, xla, rtol=0, atol=1e-5)
    s, h, w, c0 = x0.shape
    pallas_q = np.asarray(fused_nano_trunk_alpha_q(
        jnp.asarray(x0).reshape(s, h // 4, 4, w // 4, 4 * c0), q, interpret=True))
    np.testing.assert_allclose(got, pallas_q, rtol=0, atol=1e-5)
    pallas = np.asarray(fused_nano_trunk_alpha(jnp.asarray(x0), q, interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5)
    # the classes differ, so their order is seen
    assert np.abs(np.diff(got, axis=-1)).max() > 1e-3


@pytest.fixture(scope="module")
def committed_frames():
    frames, gt = bridge.load_frames()
    return frames, gt


@pytest.mark.parametrize("plan", ["pico", "nano"])
def test_trained_k4_logits_match_reference(committed_frames, plan):
    """The trained K=4 checkpoints on the two committed 720p frames at the
    72x128 stem grid: the port's plain K-class logits (from the committed
    export) equal the reference's XLA int8 path bit for bit.  The trained
    export is the reference's quantized dict (tests/test_torch_weights.py).
    The Pallas megakernel's K-class form (interpret mode) departs from that
    XLA path at about 28 % of these logits, by up to 0.0086 (pico) and
    0.0124 (nano): its SE sums its f32 mean in another order, which moves
    ctx and u1 lattice steps; it is held within the reach of one u1
    lattice step through the head (127 * max mult)."""
    model = models.MatteNetHD(stem_stride=SS, head_upsample=4, num_classes=4, decoder=plan)
    q = JQ.quantize_mattenet_hd(model, restore_params(MC_CKPT[plan]))
    st = preset({"pico": "multiclass_fast_pico", "nano": "multiclass_fast"}[plan])
    tp = TQ.trunk_params(bridge.trained_weights(st)["params"])
    frames, _ = committed_frames
    xp = np.asarray(ops.space_to_depth(jnp.asarray(frames), SS))
    x0 = _stem_x0(q, xp)
    assert x0.shape == (2, 72, 128, 128)
    got = TK.fused_nano_trunk_alpha(torch.tensor(x0), tp).numpy()
    want = _xla_logits(q, x0)
    assert got.shape == want.shape == (2, 72, 128, 4)
    n_diff = int((got != want).sum())
    pallas = np.asarray(fused_nano_trunk_alpha(jnp.asarray(x0), q, interpret=True))
    reach = 127 * float(np.max(np.asarray(q["alpha_q"]["mult"])))
    print(f"[trained {plan} K=4] logits departing from the reference's XLA path: "
          f"{n_diff} of {got.size}, max {np.abs(got - want).max():.3e}; from its Pallas "
          f"kernel: {int((got != pallas).sum())}, max {np.abs(got - pallas).max():.3e} "
          f"(reach {reach:.3e})")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=reach)


# ---- composite and blur ----------------------------------------------------

EFFECTS = (
    {"blur": 6.0},
    {"keep": True},
    {"tint": (0.9, 0.2, 0.2), "strength": 0.4},
    {"color": (0.1, 0.8, 0.3)},
)


@pytest.mark.parametrize("block,mask_hw", [(5, (32, 64)), (10, (8, 16))])
@pytest.mark.parametrize("highest", [False, True])
def test_multiclass_composite_matches_reference(rng, block, mask_hw, highest):
    """Frame 80x160; mask 32x64 (b=5) and mask = the stem grid 8x16
    (b=10, one guide tap a patch); effects blur, keep, tint and colour.
    DEFAULT precision (bf16 passes): within one u8 step -- the bf16
    roundings are the reference's, but the f32 class-field contraction
    and the blur sum in another order, which may move a value across a
    bf16 or a u8 rounding edge.  HIGHEST: within one u8 step for the
    same reason (f32 throughout)."""
    frames = rng.integers(0, 256, (2, FH, FW, 3), dtype=np.uint8)
    a = rng.random((2, *mask_hw, 4)).astype(np.float32) + 0.05
    a /= a.sum(-1, keepdims=True)
    fp = np.asarray(ops.space_to_depth(jnp.asarray(frames), block))
    prec = jax.lax.Precision.HIGHEST if highest else None
    want = np.asarray(ops.multiclass_composite_s2d(
        jnp.asarray(fp), jnp.asarray(a), list(EFFECTS), (FH, FW), block, precision=prec,
        assume_simplex=True))
    got = multiclass_composite_s2d(torch.tensor(fp), torch.tensor(a), list(EFFECTS),
                                   (FH, FW), block, highest=highest).numpy()
    assert got.shape == want.shape == fp.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.01


@pytest.mark.parametrize("hw,sigma", [((72, 128), 0.8), ((32, 64), 3.2), ((288, 512), 3.2)])
def test_planar_blur_matches_reference(rng, hw, sigma):
    """The banded-matrix blur at the served geometries (72x128 with sigma
    8*72/720, 288x512 with 8*288/720), f32: within 1e-6 (the same taps,
    summed in another order)."""
    x = rng.random((2, 3, *hw)).astype(np.float32)
    want = np.asarray(jax_blur_planar(jnp.asarray(x), sigma))
    got = gaussian_blur_planar_mxu(torch.tensor(x), sigma).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ---- the Engines -----------------------------------------------------------

S = 2
T_SEEDED = 8
SEEDED_MASK = {"multiclass_fast_pico": (8, 16), "multiclass_fast": (32, 64)}


def _ellipse_frames(t):
    """A bright ellipse moving over noise, per stream."""
    rng = np.random.default_rng(100 + t)
    f = (rng.random((S, FH, FW, 3)) * 120).astype(np.uint8)
    yy, xx = np.mgrid[0:FH, 0:FW]
    for s in range(S):
        cx, cy = 50 + 9 * t + 20 * s, 40 + 2 * t
        inside = ((xx - cx) / 28.0) ** 2 + ((yy - cy) / 30.0) ** 2 <= 1.0
        f[s][inside] = (220, 190, 170)
    return f


@pytest.fixture(scope="module", params=sorted(SEEDED_MASK))
def seeded_engines(request):
    """The JAX Engine (the trunk megakernel's K-class form in interpret
    mode) and the port's, seeded weights crossing through the bridge, 8
    steps; stream 1's EMA knob moved."""
    name = request.param
    geom = dict(frame_hw=(FH, FW), mask_hw=SEEDED_MASK[name])
    je = JaxEngine(num_streams=S, statics=jax_preset(name, int8_decoder_impl="trunk", **geom),
                   rng_seed=0, donate_state=False)
    te = Engine(S, preset(name, **geom), params=bridge.load_quantized(
        _npt(je.bundle.matte_params)), device="cpu")
    outs = []
    for e in (je, te):
        e.admit_all()
        e.set_knobs(1, ema=0.7)
        outs.append([e.process(_ellipse_frames(t)) for t in range(T_SEEDED)])
    return name, je, te, outs


def _assert_engine_outputs_match(jo, to, mask_hw):
    ca_j = np.asarray(jo["class_alpha"])
    ca_t = to["class_alpha"].numpy()
    assert ca_t.shape == ca_j.shape == (S, *mask_hw, 4)
    np.testing.assert_allclose(ca_t, ca_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(to["alpha"].numpy(), np.asarray(jo["alpha"]), rtol=0,
                               atol=1e-5)
    diff = np.abs(to["frame"].numpy().astype(np.int32)
                  - np.asarray(jo["frame"]).astype(np.int32))
    assert diff.max() <= 1
    assert not to["face_applied"].any() and not to["det_score"].any()


@pytest.mark.parametrize("step", range(T_SEEDED))
def test_seeded_engine_matches_reference(seeded_engines, step):
    """class_alpha and alpha within 1e-5, the frame within one u8 step
    (the composite's tolerance)."""
    name, _, _, (jouts, touts) = seeded_engines
    _assert_engine_outputs_match(jouts[step], touts[step], SEEDED_MASK[name])


def test_seeded_engine_state_and_evict(seeded_engines):
    """rec (the class maps) within 1e-5 and frame_idx equal after 8 steps;
    the adaptive EMA branch ran (the maps moved); evict zeroes the slot's
    rec on both engines and leaves the other slot's."""
    _, je, te, (jouts, touts) = seeded_engines
    np.testing.assert_allclose(te.state.rec[0].numpy(), np.asarray(je.state.rec), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(te.state.frame_idx.numpy(), np.asarray(je.state.frame_idx))
    np.testing.assert_allclose(te.state.prev_alpha.numpy(), np.asarray(je.state.prev_alpha),
                               rtol=0, atol=1e-5)
    moved = np.abs(touts[-1]["class_alpha"].numpy() - touts[-2]["class_alpha"].numpy())
    assert moved.max() > 1e-3
    rec1 = te.state.rec[0][1].clone()
    for e in (je, te):
        e.evict(0)
    assert not te.state.rec[0][0].any() and not np.asarray(je.state.rec)[0].any()
    assert torch.equal(te.state.rec[0][1], rec1)
    assert int(te.state.frame_idx[0]) == 0 and not bool(te.state.initialized[0])


T_TRAINED = 3


def reference_stem(q):
    """The reference's bf16 stem (its XLA dot on the CPU) as a drop-in for
    the port's ``QuantizedMatteNetHD.stem``."""
    def stem(frames_p):
        return torch.tensor(_stem_x0(q, frames_p.numpy()))
    return stem


def _run_trained(name, frames, order, *, forced):
    """Both engines over T_TRAINED steps at 720p, S=2, trained weights (the
    reference restores the checkpoint, the port loads the committed
    export).  ``forced``: the reference steps with jit disabled (its graph
    op by op, as the trained-logits test runs it) and the port's stem is
    the reference's; else both serve as they stand (the reference jitted,
    its CPU default XLA paths: the megakernel in interpret mode at 72x128
    takes minutes a step)."""
    je = JaxEngine(num_streams=S, statics=jax_preset(name), rng_seed=0, donate_state=False)
    je.load_matting_params(MC_CKPT[PRESET_PLAN[name]])
    st = preset(name)
    te = Engine(S, st, params=bridge.trained_weights(st)["params"], device="cpu")
    if forced:
        te.model.stem = reference_stem(je.bundle.matte_params)
    outs = []
    for e in (je, te):
        e.admit_all()
        steps = []
        for t in range(T_TRAINED):
            if forced and e is je:
                with jax.disable_jit():
                    steps.append(e.process(frames[order[t % 2]]))
            else:
                steps.append(e.process(frames[order[t % 2]]))
        outs.append(steps)
    return je, te, outs


@pytest.fixture(scope="module", params=sorted(PRESET_PLAN))
def trained_engines(request, committed_frames):
    """Both presets as they stand, the two committed frames swapped between
    the streams each step; a teacher-forced run and a free-running one."""
    name = request.param
    frames, gt = committed_frames
    order = [np.arange(S) % 2, (np.arange(S) + 1) % 2]
    forced = _run_trained(name, frames, order, forced=True)
    free = _run_trained(name, frames, order, forced=False)
    truth = [gt[order[t % 2]] > 127 for t in range(T_TRAINED)]
    xp = np.asarray(ops.space_to_depth(jnp.asarray(frames), SS))
    stem_flips = int((forced[1].model.stem(torch.tensor(xp)).numpy()
                      != free[1].model.stem(torch.tensor(xp)).numpy()).sum())
    return name, forced, free, truth, stem_flips


def foreground_iou(class_alpha: np.ndarray, truth: np.ndarray) -> float:
    """Mean IoU of ``1 - class_alpha[..., 0] > 0.5`` against the ground
    truth at 288x512 (taken at [::4, ::4] for a 72x128 map: the export's
    nearest taps make that the same grid)."""
    pred = (1.0 - class_alpha[..., 0]) > 0.5
    step = truth.shape[1] // pred.shape[1]
    t = truth[:, ::step, ::step]
    inter = (pred & t).sum(axis=(1, 2))
    union = np.maximum((pred | t).sum(axis=(1, 2)), 1)
    return float(np.mean(inter / union))


@pytest.mark.parametrize("step", range(T_TRAINED))
def test_trained_engine_matches_reference(trained_engines, step):
    """Teacher-forced: with the reference's stem output and the reference's
    step run op by op, the seeded test's tolerances hold (class_alpha and
    alpha 1e-5, the frame one u8 step), and rec after the last step."""
    name, (je, te, (jouts, touts)), _, _, _ = trained_engines
    _assert_engine_outputs_match(jouts[step], touts[step], preset(name).mask_hw)
    if step == T_TRAINED - 1:
        np.testing.assert_allclose(te.state.rec[0].numpy(), np.asarray(je.state.rec), rtol=0,
                                   atol=1e-5)


def test_trained_engine_free_running_iou(trained_engines, record_property):
    """Both engines as they serve.  The port's bf16 stem product rounds
    from an f32 sum in another order than the reference's XLA dot, which
    puts a knife-edge x0 value on the other relu6 lattice step (2 of 2.36 M
    on these frames; the reference's own jitted step also departs from
    its op-by-op graph, by up to 2.5e-3 for the nano trunk).  Those
    flips reach class_alpha through the trunk's SE, so the free-running
    engines are held by what users see: the foreground IoU against the
    frames' ground truth within 0.005 at every step, printed and
    recorded, and the frames' mean u8 difference under 0.05."""
    name, _, (_, _, (jouts, touts)), truth, stem_flips = trained_engines
    assert stem_flips <= 8
    ious = []
    for t, (jo, to) in enumerate(zip(jouts, touts)):
        iou_ref = foreground_iou(np.asarray(jo["class_alpha"]), truth[t])
        iou_port = foreground_iou(to["class_alpha"].numpy(), truth[t])
        ious.append((iou_ref, iou_port))
        diff = np.abs(to["frame"].numpy().astype(np.int32)
                      - np.asarray(jo["frame"]).astype(np.int32))
        print(f"[{name} trained, 720p, step {t}] foreground IoU: reference "
              f"{iou_ref:.4f}, port {iou_port:.4f}; class_alpha max diff "
              f"{np.abs(to['class_alpha'].numpy() - np.asarray(jo['class_alpha'])).max():.2e}"
              f", frame mean diff {diff.mean():.4f}; stem flips {stem_flips}")
        assert abs(iou_ref - iou_port) < 0.005
        assert diff.mean() < 0.05
    record_property("iou_reference", [r for r, _ in ious])
    record_property("iou_port", [p for _, p in ious])


# ---- what the port refuses -------------------------------------------------


def test_check_statics_refuses_unserved_multiclass():
    """The natural-layout multiclass preset (the K=4 float MatteNet) builds
    and steps; face_path=True with K > 1 is served and ignored, as the
    reference's multi-class step never reads it; a micro trunk with K > 1
    and an unknown effect are refused, each by name."""
    frames = np.zeros((1, FH, FW, 3), np.uint8)
    out = Engine(1, preset("multiclass", frame_hw=(FH, FW), mask_hw=(32, 64)),
                 device="cpu").process(frames)
    assert tuple(out["class_alpha"].shape) == (1, 32, 64, 4) and not out["passthrough"]
    e = Engine(1, preset("multiclass_fast", face_path=True, frame_hw=(FH, FW),
                         mask_hw=(32, 64)), device="cpu")
    out = e.process(frames)
    assert not out["face_applied"].any() and not out["passthrough"]
    with pytest.raises(NotImplementedError, match="matting_decoder"):
        Engine(1, preset("multiclass_fast", matting_decoder="micro", frame_hw=(FH, FW),
                         mask_hw=(32, 64)), device="cpu")
    effects = ({"blur": 8.0}, {"keep": True}, {"sparkle": True}, {"keep": True})
    with pytest.raises(ValueError, match="sparkle"):
        Engine(1, preset("multiclass_fast_pico", class_effects=effects, frame_hw=(FH, FW),
                         mask_hw=(8, 16)), device="cpu")


def test_head_classes_must_match_statics():
    """One-class weights are refused by a K=4 preset."""
    q = TQ.quantize_mattenet_hd(init_params("pico", 0, SS), SS)
    with pytest.raises(ValueError, match="classes"):
        Engine(1, preset("multiclass_fast_pico", frame_hw=(FH, FW), mask_hw=(8, 16)),
               params=q, device="cpu")

