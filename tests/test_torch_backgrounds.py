"""The colour and blur backgrounds in the port's Engine against the JAX
Engine's, and the port's blur and colour ops against the reference's.

Engines at 80x160 (mask 32x64), S=2, 2 steps, the same frames, knobs and
seeded weights (the JAX side built with a ModelBundle, its refine and
composite kernels in interpret mode, its int8 trunk through XLA as it
resolves off a TPU): fast_int8_pico (the packed composite: the colour as
one packed u8 patch; with 'blur' the natural frames blurred and the plain
composite, natural frames out, as the reference serves it), active on its
plain composite (the unrounded f32 colour, the blurred frames) and active
with use_fused_composite=True and 'color' (the composite kernel's one-row
u8 background).  With the face path off the results are held element by
element; with it on (the trained 128-pixel face models, rendered people)
by the face decisions, the affine and the alpha's IoU, as
tests/test_torch_rounds.py holds its face-on runs.

Tolerances: the refined alpha 4e-3 (pico, bf16 out) and 5e-3 (active, the
bf16 MatteNet through the refine, as tests/test_torch_active.py), the
composited frames one u8 step (the composites' bf16 passes, as the TPU runs
them, against the CPU reference's f32); with the face path on the affine
0.3 mask pixels in translation and 1e-2 in its linear part and the IoU
within 0.01.  The ops: the separable blur and box blur in the reference's
tap order within 2e-6 (f32, 0..1 values), the banded-matrix blur within
1e-5, the colour ops exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stream_segmenetation_tpu import models as jm
from video_stream_segmenetation_tpu import ops as jops
from video_stream_segmenetation_tpu.runtime.pipeline import ModelBundle
from video_stream_segmenetation_tpu.runtime.presets import preset as jax_preset
from video_stream_segmenetation_tpu.service import Engine as JaxEngine
from video_stream_segmenetation_tpu.utils.clips import articulated_clip
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.kernels import composite_fused
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import init_params
from video_stream_segmenetation_tpu_torch.models.modnet import init_mattenet_params
from video_stream_segmenetation_tpu_torch.models.quantized import quantize_mattenet_hd
from video_stream_segmenetation_tpu_torch.ops import blur as TB
from video_stream_segmenetation_tpu_torch.ops import color as TCOL
from video_stream_segmenetation_tpu_torch.runtime.presets import preset
from video_stream_segmenetation_tpu_torch.service.engine import Engine

S, T = 2, 2
GEOM = dict(frame_hw=(80, 160), mask_hw=(32, 64), fd_size=64, lmk_size=48)
# run: (preset, overrides of both engines, face path)
RUNS = {
    "pico color": ("fast_int8_pico", {"background": "color"}, False),
    "pico blur": ("fast_int8_pico", {"background": "blur", "bg_blur_sigma": 3.0}, False),
    "active color": ("active", {"background": "color", "bg_color": (0.9, 0.1, 0.5)}, False),
    "active blur": ("active", {"background": "blur"}, False),
    "active fused color": ("active", {"background": "color", "use_fused_composite": True},
                           False),
    "pico color, face path": ("fast_int8_pico", {"background": "color"}, True),
}
ALPHA_TOL = {"fast_int8_pico": 4e-3, "active": 5e-3}


def _frames(t):
    rng = np.random.default_rng(40 + t)
    f = (rng.random((S, 80, 160, 3)) * 120).astype(np.uint8)
    yy, xx = np.mgrid[0:80, 0:160]
    for s in range(S):
        inside = ((xx - 60 - 8 * t - 20 * s) / 28.0) ** 2 + ((yy - 40) / 30.0) ** 2 <= 1.0
        f[s][inside] = (220, 190, 170)
    return f


@pytest.fixture(scope="module")
def face_trees():
    return {n: bridge.load_export(bridge.WEIGHTS_DIR / f"{n}.npz")
            for n in ("facefinder_128", "landmarknet_128")}


@pytest.fixture(scope="module")
def people():
    """A rendered person whose face the trained detector finds; stream s
    takes frame t + s at step t."""
    clip = articulated_clip(n_frames=T + S, hw=(80, 160), seed=2, features=True).frames
    return [clip[t:t + S] for t in range(T)]


@pytest.fixture(scope="module", params=sorted(RUNS))
def served(request, face_trees, people):
    name, over, face = RUNS[request.param]
    geom = dict(GEOM, face_path=face)
    if name == "active":
        tree = init_mattenet_params(0)
        jmodel, params = jm.MatteNet(), tree
    else:
        tree = init_params("pico", 0, 10)
        jmodel = jm.MatteNetHD(stem_stride=10, head_upsample=4, decoder="pico")
        params = quantize_mattenet_hd(tree, 10, "pico")
    fp = {"face": face_trees["facefinder_128"], "lmk": face_trees["landmarknet_128"]}
    bundle = ModelBundle(jmodel, jax.tree_util.tree_map(jnp.asarray, tree),
                         jm.FaceFinder(input_size=64), fp["face"], jm.LandmarkNet(), fp["lmk"])
    je = JaxEngine(num_streams=S, statics=jax_preset(name, use_fused_refine=True, **over, **geom),
                   bundle=bundle, donate_state=False)
    te = Engine(S, preset(name, **over, **geom), params=params, face_params=fp, device="cpu")
    outs = []
    for e in (je, te):
        e.face_min_interval_s = 0.0
        e.admit_all()
        e.set_knobs(1, ema=0.7, gamma=0.6)
        run = []
        for t in range(T):
            last = np.array(e._last_face_at)
            out = e.process(people[t] if face else _frames(t))
            run.append({k: np.array(v.float() if isinstance(v, torch.Tensor) else v)
                        for k, v in out.items() if k in ("frame", "alpha")})
            run[-1]["face_applied"] = np.array(e._last_face_at) != last
            run[-1]["affine"] = np.array(e.state.affine.float() if isinstance(
                e.state.affine, torch.Tensor) else e.state.affine)
        outs.append(run)
    return request.param, name, face, outs


def test_backgrounds_match_the_reference(served):
    run, name, face, (jouts, touts) = served
    for j, t in zip(jouts, touts):
        assert t["frame"].shape == j["frame"].shape == (S, 80, 160, 3)
        if face:
            np.testing.assert_array_equal(t["face_applied"], j["face_applied"])
            d = np.abs(t["affine"] - j["affine"])
            assert d[:, [2, 5]].max() <= 0.3 and d[:, [0, 1, 3, 4]].max() <= 1e-2
            pt, pj = t["alpha"] > 0.5, j["alpha"] > 0.5
            iou = lambda a, b: (a & b).sum() / max((a | b).sum(), 1)  # noqa: E731
            assert abs(iou(pt, pj) - 1.0) <= 0.01
            continue
        np.testing.assert_allclose(t["alpha"], j["alpha"], rtol=0, atol=ALPHA_TOL[name])
        assert np.abs(t["frame"].astype(np.int32) - j["frame"].astype(np.int32)).max() <= 1
    assert touts[0]["face_applied"].any() == face


@pytest.mark.parametrize("over, launches", [
    ({"background": "color"}, T),
    ({"background": "image"}, T),
    ({"background": "blur"}, 0),
])
def test_fused_composite_routes(over, launches):
    """use_fused_composite=True takes the composite kernel's route with an
    image or a colour (one u8 row) and the plain composite with 'blur', as
    the reference's use_fc; a CPU tensor counts no launch, so the route is
    read from the wrapper's calls."""
    calls = []
    orig = composite_fused.fused_composite
    from video_stream_segmenetation_tpu_torch.runtime import pipeline

    def spy(frames, alpha, bg, method="half_pixel"):
        # the kernel takes contiguous tensors only
        assert frames.is_contiguous() and alpha.is_contiguous() and bg.is_contiguous()
        calls.append(tuple(bg.shape))
        return orig(frames, alpha, bg, method=method)

    pipeline.fused_composite = spy
    try:
        e = Engine(S, preset("active", use_fused_composite=True, face_path=False, **over, **GEOM),
                   device="cpu")
        e.admit_all()
        for t in range(T):
            e.process(_frames(t))
    finally:
        pipeline.fused_composite = orig
    assert len(calls) == launches
    if over["background"] == "color":
        assert calls[0] == (1, 80, 160, 3)


def test_blur_route_on_s2d_serves_natural_frames():
    e = Engine(S, preset("fast_int8_pico", background="blur", face_path=False, **GEOM),
               device="cpu", output_layout="packed")
    e.admit_all()
    assert tuple(e.process(_frames(0))["frame"].shape) == (S, 80, 160, 3)


@pytest.mark.parametrize("sigma, radius", [(1.0, None), (3.0, None), (8.0, None), (2.0, 3)])
def test_gaussian_blurs_match_the_reference(rng, sigma, radius):
    img = rng.random((2, 24, 40, 3), dtype=np.float32)
    want = np.asarray(jops.gaussian_blur(jnp.asarray(img), sigma, radius))
    t = torch.as_tensor(img)
    np.testing.assert_allclose(TB.gaussian_blur(t, sigma, radius).numpy(), want, rtol=0,
                               atol=2e-6)
    np.testing.assert_array_equal(TB.gaussian_blur_auto(t, sigma, radius).numpy(),
                                  TB.gaussian_blur(t, sigma, radius).numpy())
    np.testing.assert_allclose(TB.gaussian_blur_mxu(t, sigma, radius).numpy(),
                               np.asarray(jops.gaussian_blur_mxu(jnp.asarray(img), sigma,
                                                                 radius)),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("radius", [1, 4])
def test_box_blur_matches_the_reference(rng, radius):
    img = rng.random((1, 20, 30, 3), dtype=np.float32)
    np.testing.assert_allclose(TB.box_blur(torch.as_tensor(img), radius).numpy(),
                               np.asarray(jops.box_blur(jnp.asarray(img), radius)),
                               rtol=0, atol=2e-6)


@pytest.mark.parametrize("mode", ["unit", "centered", "imagenet"])
def test_normalize_frame_matches_the_reference(rng, mode):
    f = rng.integers(0, 256, (2, 6, 8, 3), dtype=np.uint8)
    np.testing.assert_allclose(TCOL.normalize_frame(torch.as_tensor(f), mode).numpy(),
                               np.asarray(jops.normalize_frame(jnp.asarray(f), mode)),
                               rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="normalize mode"):
        TCOL.normalize_frame(torch.as_tensor(f), "sepia")


def test_color_ops_match_the_reference(rng):
    from video_stream_segmenetation_tpu.ops import color as JC

    x = rng.random((3, 5, 7), dtype=np.float32) * 1.4 - 0.2
    m = rng.integers(0, 256, (3, 5, 7), dtype=np.uint8)
    for fn in ("denormalize_to_u8", "quantize_alpha_u8"):
        np.testing.assert_array_equal(getattr(TCOL, fn)(torch.as_tensor(x)).numpy(),
                                      np.asarray(getattr(JC, fn)(jnp.asarray(x))), err_msg=fn)
    for arr in (m, x, x.astype(np.float16)):
        np.testing.assert_array_equal(TCOL.mask_to_f32(torch.as_tensor(arr)).numpy(),
                                      np.asarray(JC.mask_to_f32(jnp.asarray(arr))))
    np.testing.assert_array_equal(TCOL.u8_mask_to_f32(torch.as_tensor(m)).numpy(),
                                  np.asarray(JC.u8_mask_to_f32(jnp.asarray(m))))
