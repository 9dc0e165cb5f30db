"""Shared engine pairs of the rollout comparisons (tests/test_torch_rollout
.py, test_torch_rollout_round.py): the JAX Engine and the port's on the
same weights and frames, S=4, the face path off, each admitted and stepped
once, so that the rollouts start from a warm state.

* ``natural``: the reference's own rollout test geometry
  (tests/test_rollout.py: 48x64 frames, mask 32x64, fd 64 / lmk 48, a
  colour background, face off) with the exact upsample, the port's seed-0
  MatteNet tree on both sides;
* ``pico`` and ``pico_fast``: fast_int8_pico at 80x160 / mask 32x64 on the
  trained pico checkpoint, quantized by the reference's Engine and handed
  to the port through bridge.load_quantized, as it stands and on the fast
  route (refine_alpha_src='lowres', guide_kernel_unfold=True,
  guide_source='host': frames as a (packed, lanes) tuple);
* ``pico_face``: ``pico`` with the face path on, the trained 128 face
  models (tests/test_torch_face_options.py's);
* ``mc_pico`` and ``mc_natural``: the K=4 presets multiclass_fast_pico
  (mask at the 8x16 stem grid) and multiclass (the K-class MatteNet at
  mask 32x64), seed-0 trees on both sides.

The JAX side gets a ``ModelBundle`` (no flax init) and
``use_fused_refine=True``, so that its Pallas kernels run in interpret
mode."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests import torch_natural_engines as NE
from video_stream_segmenetation_tpu import models as jm
from video_stream_segmenetation_tpu import runtime as jrt
from video_stream_segmenetation_tpu.runtime.pipeline import ModelBundle
from video_stream_segmenetation_tpu.runtime.presets import preset as jax_preset
from video_stream_segmenetation_tpu.service import Engine as JaxEngine
from video_stream_segmenetation_tpu.utils.checkpoint import restore_params
from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import init_params
from video_stream_segmenetation_tpu_torch.models.modnet import init_mattenet_params
from video_stream_segmenetation_tpu_torch.runtime.config import PipelineStatics
from video_stream_segmenetation_tpu_torch.runtime.presets import preset
from video_stream_segmenetation_tpu_torch.service.engine import Engine

S = 4
PICO_CKPT = "checkpoints/mattenet_hd10_pico"
FACE_CKPTS = ("checkpoints/facefinder_128", "checkpoints/landmarknet_128")
K = 4
# upsample_precision='exact': the plain composite's f32 products, which the
# CPU reference computes too (with 'fast' the port takes the TPU's bf16
# pass, tests/test_torch_active_options.py)
NATURAL = dict(frame_hw=(48, 64), mask_hw=(32, 64), fd_size=64, lmk_size=48,
               background="color", face_path=False, upsample_precision="exact")
S2D = dict(frame_hw=(80, 160), mask_hw=(32, 64), fd_size=64, lmk_size=48, face_path=False)
FAST = dict(refine_alpha_src="lowres", guide_kernel_unfold=True, guide_source="host")


@functools.lru_cache(maxsize=None)
def _restored(path):
    return restore_params(path)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def frames_for(kind: str, seed: int = 0) -> np.ndarray:
    """``[S, h, w, 3]`` u8: noise at 48x64 (the reference test's), or the
    rendered people of tests/torch_natural_engines.py at 80x160."""
    if kind == "natural":
        rng = np.random.default_rng(seed)
        return (rng.random((S, *NATURAL["frame_hw"], 3)) * 255).astype(np.uint8)
    if kind == "mc_natural":
        return frames_for("pico", seed)
    fr = NE.engine_frames()
    return np.ascontiguousarray(np.concatenate([fr[seed], fr[seed + 1]]))


def engines(kind: str):
    """``(je, te)``: the engine pair of ``kind``, admitted, a background set
    on each stream (s2d), one step served (none with the face path on, so
    that the next step's cadence fires)."""
    if kind == "natural":
        tree = init_mattenet_params(0)
        jst = jrt.PipelineStatics(use_fused_refine=True, **NATURAL)
        bundle = ModelBundle(jm.MatteNet(), jax.tree_util.tree_map(jnp.asarray, tree))
        je = JaxEngine(num_streams=S, statics=jst, bundle=bundle, donate_state=False)
        te = Engine(S, PipelineStatics(**NATURAL), params=tree, device="cpu")
    elif kind == "mc_natural":
        tree = init_mattenet_params(0, K)
        over = dict(S2D)
        bundle = ModelBundle(jm.MatteNet(num_classes=K), jax.tree_util.tree_map(jnp.asarray, tree))
        je = JaxEngine(num_streams=S, statics=jax_preset("multiclass", **over), bundle=bundle,
                       donate_state=False)
        te = Engine(S, preset("multiclass", **over), params=tree, device="cpu")
    elif kind == "mc_pico":
        over = dict(S2D, mask_hw=(8, 16))
        jst = jax_preset("multiclass_fast_pico", int8_decoder_impl="trunk", **over)
        bundle = ModelBundle(jm.MatteNetHD(stem_stride=10, head_upsample=1, num_classes=K,
                                           decoder="pico"),
                             jax.tree_util.tree_map(jnp.asarray, init_params("pico", 0, 10, K)))
        je = JaxEngine(num_streams=S, statics=jst, bundle=bundle, donate_state=False)
        te = Engine(S, preset("multiclass_fast_pico", **over),
                    params=bridge.load_quantized(_np(je.bundle.matte_params)), device="cpu")
    else:
        over = dict(S2D, **(FAST if kind == "pico_fast" else {}),
                    face_path=kind == "pico_face")
        jst = jax_preset("fast_int8_pico", use_fused_refine=True, int8_decoder_impl="trunk",
                         **over)
        faces = [_restored(c) for c in FACE_CKPTS]
        bundle = ModelBundle(jm.MatteNetHD(stem_stride=10, head_upsample=4, decoder="pico"),
                             _restored(PICO_CKPT), jm.FaceFinder(input_size=jst.fd_size),
                             faces[0], jm.LandmarkNet(), faces[1])
        je = JaxEngine(num_streams=S, statics=jst, bundle=bundle, donate_state=False)
        te = Engine(S, preset("fast_int8_pico", **over),
                    params=bridge.load_quantized(_np(je.bundle.matte_params)),
                    face_params={"face": bridge.float_tree(_np(faces[0])),
                                 "lmk": bridge.float_tree(_np(faces[1]))}, device="cpu")
    rng = np.random.default_rng(7)
    bgs = rng.integers(0, 256, (S, 80, 160, 3), dtype=np.uint8)
    for e in (je, te):
        e.face_min_interval_s = 0.0
        e.admit_all()
        if kind not in ("natural", "mc_natural"):
            for s in range(S):
                e.set_background(s, bgs[s])
    if kind != "pico_face":
        f0 = frames_for(kind, 1)
        je.process(f0)
        te.process(f0)
    return je, te


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def u8_gap(a, b) -> int:
    """The largest difference of two u8 arrays modulo 256 (a buffer that
    wrapped on one side and not the other counts as 1, not 255)."""
    d = (as_np(a).astype(np.int32) - as_np(b).astype(np.int32)) % 256
    return int(np.minimum(d, 256 - d).max())


N = 3
# the round rollouts' groups and tick
SIZES = [3, 1]
TICK = 1.0 / 30.0
# the per-step bars of the port's step-parity tests: (refined alpha, new_prev)
BARS = {"natural": (5e-3, 1e-3), "pico": (4e-3, 2e-5), "pico_fast": (4e-3, 2e-5)}


def pair(cache: dict, kind: str):
    """The engine pair of ``kind``, built once into ``cache``."""
    if kind not in cache:
        cache[kind] = engines(kind)
    return cache[kind]


def assert_step_rollout_matches(engine_pair, kind, acc, perturb, seed=2):
    """Both packages' step rollouts of N steps on the same frames (the
    reference's jitted, the port's with the odd iterations' models for
    'weights'), held to the per-step bars times N; the 'reduce' sums to
    those times a stream's values."""
    from video_stream_segmenetation_tpu.runtime import rollout as JR
    from video_stream_segmenetation_tpu_torch.runtime import rollout as TR

    je, te = engine_pair
    frames = frames_for(kind, seed)
    jroll = jax.jit(JR.make_step_rollout(je.bundle, je.statics, acc_mode=acc, perturb=perturb),
                    static_argnums=(6,))
    jst, jf, ja = jroll(je.bundle.params, je.state, je._ingest(frames)[1], je.backgrounds,
                        je.knobs, jnp.ones((S,), bool), N)
    perturbed = TR.perturbed_models(te) if perturb == "weights" else None
    troll = TR.make_step_rollout(te.model, te.statics, te.face_models, acc, perturb, perturbed)
    tst, tf, ta = troll(te.state, te._ingest(frames)[1][0], te.backgrounds, te.knobs,
                        torch.ones((S,), dtype=torch.bool), N)
    alpha_bar, prev_bar = BARS[kind]
    np.testing.assert_allclose(tst.prev_alpha.numpy(), np.asarray(jst.prev_alpha), rtol=0,
                               atol=prev_bar * N)
    for field in ("frame_idx", "initialized", "has_affine", "affine"):
        np.testing.assert_array_equal(getattr(tst, field).numpy(),
                                      np.asarray(getattr(jst, field)))
    assert int(tst.frame_idx[0]) == int(np.asarray(je.state.frame_idx)[0]) + N
    if acc == "buffer":
        assert tf.dtype == torch.uint8 and tuple(tf.shape) == tuple(jf.shape)
        assert str(ta.dtype).split(".")[-1] == str(ja.dtype)
        assert u8_gap(tf, jf) <= N
        np.testing.assert_allclose(as_np(ta), as_np(ja), rtol=0, atol=alpha_bar * N)
        return
    assert tf.dtype == torch.int32 and tuple(tf.shape) == (S,)
    values = int(np.prod(frames.shape[1:]))
    pixels = int(np.prod(te.statics.mask_hw))
    assert np.abs(tf.numpy().astype(np.int64) - np.asarray(jf, np.int64)).max() \
        <= N * 0.01 * values
    np.testing.assert_allclose(as_np(ta), as_np(ja), rtol=0, atol=alpha_bar * N * pixels)


def groups(e, frames):
    """Each group's rows of ``frames``, as engine ``e`` steps them (the
    port's ingest gives a list a shard: one here)."""
    offs = np.cumsum([0, *SIZES])
    ins = [e._ingest(frames[offs[g]:offs[g + 1]], rows=SIZES[g])[1] for g in range(len(SIZES))]
    return [x[0] if isinstance(x, list) else x for x in ins]


def clock():
    """The port's face clock (never stamped), ``now0`` and the interval."""
    return (torch.full((S,), -1e9), torch.tensor(5.0), torch.tensor(0.1))


def assert_round_rollout_matches(engine_pair, kind, acc, perturb):
    """Both packages' round rollouts of N rounds in groups SIZES, the
    port's on a copy of its state (written in place), held to the per-step
    bars times N."""
    from video_stream_segmenetation_tpu.runtime import rollout as JR
    from video_stream_segmenetation_tpu_torch.runtime import rollout as TR
    from video_stream_segmenetation_tpu_torch.runtime.state import map_state

    je, te = engine_pair
    frames = frames_for(kind, 2)
    jroll = jax.jit(JR.make_round_rollout(je.bundle, je.statics, SIZES, tick_dt=TICK,
                                          acc_mode=acc, perturb=perturb), static_argnums=(8,))
    jst, jlast, jaccs = jroll(je.bundle.params, je.state, groups(je, frames), je.backgrounds,
                              je.knobs, jnp.full((S,), -1e9, jnp.float32),
                              jnp.asarray(5.0, jnp.float32), jnp.asarray(0.1, jnp.float32), N)
    perturbed = TR.perturbed_models(te) if perturb == "weights" else None
    troll = TR.make_round_rollout(te.model, te.statics, SIZES, te.face_models, TICK, acc,
                                  perturb, perturbed)
    state = map_state(torch.clone, te.state)
    tst, tlast, taccs = troll(state, groups(te, frames), te.backgrounds, te.knobs, *clock(),
                              N)
    assert tst is state  # rows written in place: the caller's tensors
    alpha_bar, prev_bar = BARS[kind]
    np.testing.assert_allclose(tst.prev_alpha.numpy(), np.asarray(jst.prev_alpha), rtol=0,
                               atol=prev_bar * N)
    np.testing.assert_array_equal(tst.frame_idx.numpy(), np.asarray(jst.frame_idx))
    np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))
    assert len(taccs) == len(jaccs) == len(SIZES)
    for g, ((tf, ta), (jf, ja)) in enumerate(zip(taccs, jaccs)):
        if acc == "buffer":
            assert tf.dtype == torch.uint8 and tuple(tf.shape) == tuple(jf.shape)
            assert u8_gap(tf, jf) <= N, g
            np.testing.assert_allclose(as_np(ta), as_np(ja), rtol=0, atol=alpha_bar * N)
            continue
        assert tf.dtype == torch.int32 and tuple(tf.shape) == (SIZES[g],)
        values = int(np.prod(frames_for(kind).shape[1:]))
        assert np.abs(tf.numpy().astype(np.int64) - np.asarray(jf, np.int64)).max() \
            <= N * 0.01 * values
        np.testing.assert_allclose(as_np(ta), as_np(ja), rtol=0,
                                   atol=alpha_bar * N * int(np.prod(te.statics.mask_hw)))


# one step's bars by kind: (alpha and class maps, new_prev, frame values one
# u8 step apart at most this share); mc: tests/test_torch_multiclass_plans.py
# (int8: 1e-5) and test_torch_multiclass_natural.py (the bf16 K=4 MatteNet:
# 2e-3, 1 % of the frame's values)
STEP_BARS = {"natural": (5e-3, 1e-3, 1e-2), "pico": (4e-3, 2e-5, 1e-2),
             "pico_fast": (4e-3, 2e-5, 1e-2), "pico_face": (4e-3, 2e-5, 1e-2),
             "mc_pico": (1e-5, 1e-5, 1e-2), "mc_natural": (2e-3, 2e-3, 1e-2)}


def step_both(engine_pair, kind: str, debug_stage: str, seed: int = 2):
    """One step of each package's ``make_step`` with ``debug_stage``, both
    from the reference engine's state (teacher-forced: a warm-up's face
    update moves the affine by fractions of a pixel), on the same frames,
    the face gate open.  Returns ``((new_state, outputs) of the reference,
    of the port, the port's step input)``."""
    import dataclasses

    from video_stream_segmenetation_tpu_torch.runtime.pipeline import make_step
    from video_stream_segmenetation_tpu_torch.runtime.state import StreamState

    je, te = engine_pair
    frames = frames_for(kind, seed)
    jst = dataclasses.replace(je.statics, debug_stage=debug_stage)
    jstep = jax.jit(jrt.make_step(je.bundle, jst))
    jres = jstep(je.bundle.params, je.state, je._ingest(frames)[1], je.backgrounds, je.knobs,
                 jnp.ones((S,), bool))
    tst = dataclasses.replace(te.statics, debug_stage=debug_stage)
    fj = te._ingest(frames)[1][0]
    rec = te.state.rec
    if kind == "mc_natural" or kind == "mc_pico":
        rec = (torch.tensor(np.asarray(je.state.rec)),)
    state = StreamState(**{f: torch.tensor(np.asarray(getattr(je.state, f))) for f in
                           ("prev_alpha", "affine", "has_affine", "initialized", "frame_idx",
                            "face_center", "has_center")}, rec=rec)
    tres = make_step(te.model, tst, te.face_models)(state, fj, te.backgrounds, te.knobs,
                                                    torch.ones((S,), dtype=torch.bool))
    return jres, tres, fj


def assert_step_matches(jres, tres, fj, kind: str, debug_stage: str) -> None:
    """A debug step's outputs and state against the reference's, at the
    kind's one-step bars: the output keys the reference gives (the port adds
    face_has_prior), the alpha's dtype and values, the frame (with
    ``no_composite`` the step's input frames, byte for byte), the class maps
    with K classes, the face outputs (det_score within 1e-2, the decisions
    equal, the prior scalars within one mask pixel), the state."""
    (jns, jo), (tns, to) = jres, tres
    alpha_bar, prev_bar, share = STEP_BARS[kind]
    assert set(jo) - {"face_prior_plane"} <= set(to), (sorted(jo), sorted(to))
    assert str(to["alpha"].dtype).split(".")[-1] == str(jo["alpha"].dtype)
    np.testing.assert_allclose(as_np(to["alpha"]), as_np(jo["alpha"]), rtol=0, atol=alpha_bar)
    if "no_composite" in debug_stage:
        packed = fj[0] if isinstance(fj, tuple) else fj
        assert torch.equal(to["frame"], packed)
        np.testing.assert_array_equal(to["frame"].numpy(), np.asarray(jo["frame"]))
    else:
        gap = np.abs(as_np(to["frame"]).astype(np.int32) - as_np(jo["frame"]).astype(np.int32))
        assert gap.max() <= 1 and (gap > 0).mean() <= share, (gap.max(), (gap > 0).mean())
    if "class_alpha" in jo:
        np.testing.assert_allclose(to["class_alpha"].numpy(), np.asarray(jo["class_alpha"]),
                                   rtol=0, atol=alpha_bar)
    np.testing.assert_allclose(to["det_score"].numpy(), np.asarray(jo["det_score"]), rtol=0,
                               atol=1e-2)
    np.testing.assert_array_equal(to["face_applied"].numpy(), np.asarray(jo["face_applied"]))
    if "face_has_prior" in jo:
        np.testing.assert_array_equal(to["face_has_prior"].numpy(),
                                      np.asarray(jo["face_has_prior"]))
    if "face_prior_params" in jo:
        np.testing.assert_allclose(to["face_prior_params"].numpy(),
                                   np.asarray(jo["face_prior_params"]), rtol=0, atol=1.0)
    np.testing.assert_allclose(tns.prev_alpha.numpy(), np.asarray(jns.prev_alpha), rtol=0,
                               atol=prev_bar)
    for field in ("frame_idx", "initialized", "has_affine"):
        np.testing.assert_array_equal(getattr(tns, field).numpy(),
                                      np.asarray(getattr(jns, field)))
    ja, ta = np.asarray(jns.affine), tns.affine.numpy()
    np.testing.assert_allclose(ta[:, [2, 5]], ja[:, [2, 5]], rtol=0, atol=0.3)
    np.testing.assert_allclose(ta[:, [0, 1, 3, 4]], ja[:, [0, 1, 3, 4]], rtol=0, atol=1e-2)


def assert_rollout_equals_sequential_steps(te, frames) -> None:
    """The port's step rollout of N steps on ``frames`` (the step's input)
    against its own N sequential make_step calls on the tagged frames, bit
    for bit in the state and both buffers."""
    from video_stream_segmenetation_tpu_torch.runtime import rollout as TR
    from video_stream_segmenetation_tpu_torch.runtime.pipeline import make_step

    gate = torch.ones((S,), dtype=torch.bool)
    st_r, af, aa = TR.make_step_rollout(te.model, te.statics, te.face_models)(
        te.state, frames, te.backgrounds, te.knobs, gate, N)
    step = make_step(te.model, te.statics, te.face_models)
    st, ef, ea = te.state, None, None
    for i in range(N):
        st, out = step(st, frames if i == 0 else TR._perturb(frames, i), te.backgrounds,
                       te.knobs, gate)
        ef = out["frame"] if ef is None else ef + out["frame"]
        ea = out["alpha"] if ea is None else ea + out["alpha"]
    assert torch.equal(af, ef) and torch.equal(aa, ea)
    assert torch.equal(st_r.prev_alpha, st.prev_alpha)
    assert torch.equal(st_r.frame_idx, st.frame_idx)
