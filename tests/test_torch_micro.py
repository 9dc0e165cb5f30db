"""The port's micro plan (fast_int8_micro's trunk) against the JAX package:
the numpy quantizer's dict, the seeded float tree's layout, and the plain
micro trunk (models/quantized.py::xla_micro_trunk_alpha, the CUDA trunk's
plain version) against the reference's int8 graph with its decoder levels
in XLA (``decoder_impl='xla'``) and through the Pallas decoder kernel in
interpret mode (``'pallas'``), on the same s8 stem output."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu import models
from video_stream_segmenetation_tpu.models import quantized as JQ
from video_stream_segmenetation_tpu.utils.checkpoint import restore_params
from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.kernels import trunk_int8 as TK
from video_stream_segmenetation_tpu_torch.models import quantized as TQ
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import init_params

SS = 10
MICRO_CKPT = "checkpoints/mattenet_hd10_micro"


def _model():
    return models.MatteNetHD(stem_stride=SS, head_upsample=4, decoder="micro")


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def trees():
    model = _model()
    return {"trained": jax.tree_util.tree_map(np.asarray, restore_params(MICRO_CKPT)),
            "seeded": jax.tree_util.tree_map(np.asarray, model.init(
                jax.random.PRNGKey(1), jnp.zeros((1, 80, 160, 3))))}


@pytest.mark.parametrize("which", ["trained", "seeded"])
def test_micro_quantizer_matches_reference(trees, which):
    """Bit-exact dict: the same float64 fold and rounding in numpy.  The
    port keeps ``stem_w`` in f32 and serves it as bf16 (the reference
    stores the bf16 values), so that entry is compared as served."""
    want = _leaves(bridge.load_quantized(jax.tree_util.tree_map(
        np.asarray, JQ.quantize_mattenet_hd(_model(), trees[which]))))
    got = _leaves(bridge.params_from_jax(trees[which], SS, decoder="micro"))
    got["stem_w"] = torch.tensor(got["stem_w"]).to(torch.bfloat16).float().numpy()
    assert got.keys() == want.keys()
    assert "d2b/ConvBN_1/wq" in got and "d3b/SEBlock_0/Dense_0/kernel" in got
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_seeded_micro_tree_has_flax_layout(trees):
    mine = {k: v.shape for k, v in _leaves(init_params("micro", 0, SS)).items()}
    flax = {k: v.shape for k, v in _leaves(trees["seeded"]).items()}
    assert mine == flax
    a, b = _leaves(init_params("micro", 3, SS)), _leaves(init_params("micro", 3, SS))
    assert all(np.array_equal(a[k], b[k]) for k in a)


def _stem_x0(q, xp):
    """The reference's bf16 stem on packed frames -> s8 x0."""
    y = jnp.asarray(xp).astype(jnp.bfloat16) @ q["stem_w"]
    return np.asarray(JQ._requant(y.astype(jnp.float32) + q["stem_b"]))


def _packed(rng, s, fh, fw):
    x = rng.integers(0, 256, (s, fh // SS, fw // SS, SS * SS * 3), dtype=np.uint8)
    return x


def _reference_logits(q, xp, impl):
    jm = JQ.QuantizedMatteNetHD(SS, 4, decoder="micro", decoder_impl=impl, head_impl="int8")
    return np.asarray(jm.apply(q, jnp.asarray(xp))["alpha_logit_lr"])


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("which", ["trained", "seeded"])
def test_plain_micro_trunk_matches_reference(trees, rng, impl, which):
    """Exact logits at the 8x16 stem grid: exact s32 sums and the same f32
    epilogues on both sides; the SE means and dense layers (f32 in the
    reference, float64 in the port) picked no other lattice step here."""
    q = JQ.quantize_mattenet_hd(_model(), trees[which])
    xp = _packed(rng, 2, 80, 160)
    want = _reference_logits(q, xp, impl)
    tp = TQ.trunk_params(bridge.load_quantized(jax.tree_util.tree_map(np.asarray, q)))
    got = TK.micro_trunk_alpha(torch.tensor(_stem_x0(q, xp)), tp).numpy()
    assert got.shape == want.shape == (2, 8, 16) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_micro_model_alpha_matches_reference(trees, rng):
    """QuantizedMatteNetHD (micro) forward vs the reference's int8 graph on
    packed frames.  The stem's bf16 product may round a knife-edge x0 value
    to the other lattice step, so alpha is held to 1e-5, not bit-exact."""
    q = JQ.quantize_mattenet_hd(_model(), trees["trained"])
    xp = _packed(rng, 2, 80, 160)
    jm = JQ.QuantizedMatteNetHD(SS, 4, decoder="micro", decoder_impl="xla", head_impl="int8")
    want = np.asarray(jm.apply(q, jnp.asarray(xp))["alpha"])
    tm = TQ.QuantizedMatteNetHD(bridge.load_quantized(jax.tree_util.tree_map(np.asarray, q)),
                                SS, 4, device="cpu")
    assert tm.decoder == "micro"
    got = tm(torch.tensor(xp))["alpha"].numpy()
    assert got.shape == want.shape == (2, 32, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def full_grid(trees):
    """The main path's 72x128 stem grid: the committed 720p frames, the
    trained micro weights, S=1 each."""
    q = JQ.quantize_mattenet_hd(_model(), trees["trained"])
    frames, _ = bridge.load_frames()
    from video_stream_segmenetation_tpu.ops.layout import space_to_depth

    xp = np.asarray(space_to_depth(jnp.asarray(frames), SS))
    tp = TQ.trunk_params(bridge.load_quantized(jax.tree_util.tree_map(np.asarray, q)))
    return q, xp, tp


@pytest.mark.parametrize("frame", [0, 1])
def test_plain_micro_trunk_full_stem_grid_trained(full_grid, frame):
    """At the 72x128 grid the SEs average 2304 (d2b), 576 (d3b, ctx) values
    a channel; float64 against the reference's f32 could pick another
    lattice step.  Measured: none does.

    * Against the reference's XLA path the logits are bit-exact.
    * Against its Pallas decoder levels (interpret mode) a few logits
      differ (9 and 15 of 9216 on these frames, at most 0.0031): exactly
      where the reference's Pallas path departs from its own XLA path, by
      the reach of one u1 lattice step through the alpha head."""
    q, xp, tp = full_grid
    xs = xp[frame:frame + 1]
    want = _reference_logits(q, xs, "xla")
    got = TK.micro_trunk_alpha(torch.tensor(_stem_x0(q, xs)), tp).numpy()
    assert got.shape == want.shape == (1, 72, 128)
    np.testing.assert_array_equal(got, want)

    pallas = _reference_logits(q, xs, "pallas")
    np.testing.assert_array_equal(got != pallas, want != pallas)
    reach = 127 * float(np.max(np.asarray(q["alpha_q"]["mult"])))
    assert (got != pallas).sum() < 32
    np.testing.assert_allclose(got, pallas, rtol=0, atol=reach)


# ---- micro's whole step at 720p against the JAX Engine ----------------------

WHOLE_S, WHOLE_T = 2, 3


def _reference_stem(q):
    """The reference's bf16 stem (its XLA dot on the CPU) as a drop-in for
    the port's ``QuantizedMatteNetHD.stem``."""
    def stem(frames_p):
        return torch.tensor(_stem_x0(q, frames_p.numpy()))
    return stem


def _iou(alpha, truth):
    pred = alpha > 0.5
    inter = (pred & truth).sum(axis=(1, 2))
    return float(np.mean(inter / np.maximum((pred | truth).sum(axis=(1, 2)), 1)))


def _whole_step_run(forced):
    """fast_int8_micro as its preset stands (face path on, fd 256 / lmk
    192) on both engines, the trained micro, facefinder and landmarknet
    weights, the two committed 720p frames swapped between the S=2
    streams each step, the wall-clock face gate off.  The reference takes
    its CPU defaults, the XLA paths (its Pallas decoder and refine in
    interpret mode at 720p take minutes a step).  ``forced``: the
    reference steps with jit disabled (its graph op by op) and the port's
    stem is the reference's."""
    from video_stream_segmenetation_tpu.runtime.presets import preset as jax_preset
    from video_stream_segmenetation_tpu.service import Engine as JaxEngine
    from video_stream_segmenetation_tpu_torch.runtime.presets import preset
    from video_stream_segmenetation_tpu_torch.service.engine import Engine

    frames, gt = bridge.load_frames()
    order = [np.arange(WHOLE_S) % 2, (np.arange(WHOLE_S) + 1) % 2]
    je = JaxEngine(num_streams=WHOLE_S, statics=jax_preset("fast_int8_micro"), rng_seed=0,
                   donate_state=False)
    je.load_matting_params(MICRO_CKPT)
    je.load_face_params("checkpoints/facefinder", "checkpoints/landmarknet")
    st = preset("fast_int8_micro")
    te = Engine(WHOLE_S, st, **bridge.trained_weights(st), device="cpu")
    if forced:
        te.model.stem = _reference_stem(je.bundle.matte_params)
    outs = []
    for e in (je, te):
        e.face_min_interval_s = 0.0
        e.admit_all()
        steps = []
        for t in range(WHOLE_T):
            if forced and e is je:
                with jax.disable_jit():
                    out = e.process(frames[order[t % 2]])
            else:
                out = e.process(frames[order[t % 2]])
            out["prev_alpha"] = np.asarray(e.state.prev_alpha).copy()
            steps.append(out)
        outs.append(steps)
    truth = [gt[order[t % 2]] > 127 for t in range(WHOLE_T)]
    return outs, truth


@pytest.fixture(scope="module")
def whole_step():
    return {"forced": _whole_step_run(True), "free": _whole_step_run(False)}


@pytest.mark.parametrize("step", range(WHOLE_T))
def test_micro_whole_step_matches_jax_engine_720p(whole_step, step):
    """Teacher-forced (the reference's stem output; its step run op by
    op): the tolerances of test_torch_engine.py::
    test_face_alpha_matches_jax_engine -- alpha 4e-3, new_prev 1e-4, the
    frame one u8 step -- and the same face decisions and det_score within
    1e-2.  The face path fires on stream 0 at step 0 (the cadence)."""
    (jouts, touts), _ = whole_step["forced"]
    j, g = jouts[step], touts[step]
    assert g["alpha"].shape == (WHOLE_S, 288, 512) and g["alpha"].dtype == torch.float32
    np.testing.assert_allclose(g["alpha"].numpy(), np.asarray(j["alpha"], np.float32),
                               rtol=0, atol=4e-3)
    np.testing.assert_allclose(g["prev_alpha"], j["prev_alpha"], rtol=0, atol=1e-4)
    diff = np.abs(g["frame"].numpy().astype(np.int32) - np.asarray(j["frame"]).astype(np.int32))
    assert diff.max() <= 1
    np.testing.assert_allclose(g["det_score"].numpy(), np.asarray(j["det_score"]), rtol=0,
                               atol=1e-2)
    np.testing.assert_array_equal(g["det_score"].numpy() > 0, np.asarray(j["det_score"]) > 0)
    if step == 0:
        assert bool(g["face_applied"][0])


def test_micro_whole_step_free_running_iou(whole_step, record_property):
    """Both engines as they serve.  Two things depart from the op-by-op
    comparison above, both on the reference's side: its bf16 stem product
    puts a few knife-edge x0 values on the other relu6 lattice step, and
    its jitted step departs from its own op-by-op graph (the threshold and
    gamma stages turn a lattice flip into up to 0.6 of alpha at a few
    pixels).  So the free-running engines are held by the foreground IoU
    against the frames' ground truth (alpha > 0.5 against alpha_288x512):
    within 0.005 at every step, printed and recorded.  The reference's own
    IoU on these frames (about 0.25) is the trained micro checkpoint's."""
    (jouts, touts), truth = whole_step["free"]
    ious = []
    for t in range(WHOLE_T):
        ref = _iou(np.asarray(jouts[t]["alpha"], np.float32), truth[t])
        port = _iou(touts[t]["alpha"].numpy(), truth[t])
        print(f"[fast_int8_micro trained, 720p, step {t}] IoU vs ground truth: reference "
              f"{ref:.4f}, port {port:.4f}")
        ious.append((ref, port))
        assert abs(ref - port) < 0.005
    record_property("iou_reference", [r for r, _ in ious])
    record_property("iou_port", [p for _, p in ious])
