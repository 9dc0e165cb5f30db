"""``active``'s three natural-layout options that no preset sets, in the
port against the JAX package on the CPU (80x160, mask 32x64, fd 64, lmk
48): ``refined_dtype='bf16'`` (the refine kernel's bf16 out, read by the
plain composite and by the composite kernel), ``upsample_impl='gather'``
(the composite's two-tap upsample) and ``resize_impl='mxu'`` with
``preprocess_precision`` (the resize to the mask and the face path's
letterbox as interpolation products): the ops, then the Engine over 8
steps on each option.

Tolerances, with their reasons:
* the bf16 alpha's upsample follows the reference's dtype flow (bf16
  operands and products' results): the served frame within one u8 step on
  under 1 % of values (f32 sums of two products in another order move a
  value across a bf16 rounding edge, which can move the blend a step);
* the gathers in f32 and in bf16: the same operations, within one u8 step
  on under 0.1 % (f32) or 1 % (bf16: PyTorch rounds each bf16 operation,
  XLA may keep the f32 in between) of values;
* the composite kernel's plain version with a bf16 alpha (read as f32,
  as the reference's kernel reads it): tests/test_torch_composite.py's
  tolerance, one u8 step on under 0.1 % of values;
* the 'mxu' resize: 'exact' (f32) within 1e-6 of the reference's HIGHEST
  products; 'fast' is the TPU's DEFAULT precision, one bf16 pass, which
  the CPU reference does not round: within 2**-8 (one bf16 step at 1,
  the operands' and the partial result's roundings) of its f32;
* the Engine, teacher-forced as tests/test_torch_active.py holds it: the
  alpha within 5e-3 (bf16: plus one bf16 step at 1, 2**-8), new_prev
  within 1e-3, the frame within one u8 step (bf16: two, on under 1 % of
  values one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_natural_engines as NE
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu import models, ops
from video_stream_segmenetation_tpu.kernels.composite_fused import fused_composite as jfc
from video_stream_segmenetation_tpu_torch.kernels import composite_fused as KC
from video_stream_segmenetation_tpu_torch.models.modnet import init_mattenet_params
from video_stream_segmenetation_tpu_torch.ops import composite as TC
from video_stream_segmenetation_tpu_torch.ops import resize as TRS

T = torch.tensor


def _case(rng):
    frames = rng.integers(0, 256, (2, 80, 160, 3), dtype=np.uint8)
    bg = rng.integers(0, 256, (2, 80, 160, 3), dtype=np.uint8)
    alpha = rng.random((2, 32, 64), dtype=np.float32)
    alpha[0, :4] = 0.0
    alpha[1, -4:] = 1.0
    return frames, alpha, bg


def _held(got, want, share):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < share, (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("impl,dtype", [("mxu", "bf16"), ("gather", "f32"),
                                        ("gather", "bf16")])
def test_plain_composite_matches_reference(rng, impl, dtype):
    """The reference step's plain composite (runtime/pipeline.py:899-938):
    the bf16 alpha through the planar products in bf16 (DEFAULT: the
    operands and results bf16), or the alpha through alpha_composite's
    gathers in its own dtype."""
    frames, alpha, bg = _case(rng)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    a = jnp.asarray(alpha).astype(jdt)
    f32 = jnp.asarray(frames, jnp.float32) / 255.0
    if impl == "mxu":
        a = jnp.clip(ops.resize_bilinear_mxu(a, (80, 160), method="half_pixel",
                                             channel_last=False,
                                             precision=jax.lax.Precision.DEFAULT), 0.0, 1.0)
    want = np.asarray(ops.alpha_composite(f32, a, background=jnp.asarray(bg, jnp.float32)
                                          / 255.0, upsample_method="half_pixel", out_u8=True))
    ta = T(alpha).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    got = TC.natural_composite(T(frames), ta, T(bg), impl=impl).numpy()
    assert got.dtype == np.uint8 and got.shape == frames.shape
    _held(got, want, 1e-3 if dtype == "f32" else 1e-2)


def test_composite_kernel_reads_a_bf16_alpha(rng):
    """The composite kernel's plain version on the refine kernel's bf16 out
    against the reference's Pallas kernel (interpret mode) on the same
    values."""
    frames, alpha, bg = _case(rng)
    a16 = T(alpha).to(torch.bfloat16)
    want = np.asarray(jfc(jnp.asarray(frames), jnp.asarray(a16.float().numpy()),
                          jnp.asarray(bg), interpret=True))
    _held(KC.fused_composite(T(frames), a16, T(bg)).numpy(), want, 1e-3)


@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_mxu_resize_down_matches_reference(rng, precision):
    """The step's 'mxu' resize of the u8 frames to the mask (asymmetric)."""
    frames = rng.integers(0, 256, (2, 80, 160, 3), dtype=np.uint8)
    want = np.asarray(ops.resize_bilinear_mxu(jnp.asarray(frames, jnp.float32) / 255.0,
                                              (32, 64), method="asymmetric",
                                              precision=jax.lax.Precision.HIGHEST))
    got = TRS.resize_bilinear_mxu(T(frames).float() / 255.0, (32, 64), "asymmetric",
                                  bf16_pass=precision == "fast").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 if precision == "exact"
                               else 2.0 ** -8)


# ---- the Engine on each option ------------------------------------------------

OPTIONS = {
    "bf16": {"refined_dtype": "bf16"},
    "gather": {"upsample_impl": "gather"},
    "mxu_exact": {"resize_impl": "mxu", "preprocess_precision": "exact"},
}


@pytest.fixture(scope="module", params=sorted(OPTIONS))
def engines(request):
    name = request.param
    return (name, *NE.run_engines("active", OPTIONS[name], models.MatteNet(),
                                  init_mattenet_params(0), NE.engine_frames()))


def test_engine_face_decisions_match(engines):
    _, jouts, touts, _ = engines
    NE.assert_face_decisions_match(jouts, touts)


@pytest.mark.parametrize("step", range(NE.ENGINE_T))
def test_engine_step_matches(engines, step):
    name, jouts, _, forced = engines
    j, g = jouts[step], forced[step]
    bf16 = name == "bf16"
    assert g["alpha"].dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert np.asarray(j["alpha"]).dtype == (jnp.bfloat16 if bf16 else np.float32)
    np.testing.assert_allclose(g["alpha"].float().numpy(), np.asarray(j["alpha"], np.float32),
                               rtol=0, atol=5e-3 + (2.0 ** -8 if bf16 else 0.0))
    np.testing.assert_allclose(g["state"]["prev_alpha"], j["state"]["prev_alpha"],
                               rtol=0, atol=1e-3)
    diff = np.abs(g["frame"].numpy().astype(np.int32) - np.asarray(j["frame"]).astype(np.int32))
    if bf16:
        assert diff.max() <= 2 and (diff > 1).mean() < 1e-2
    else:
        assert diff.max() <= 1
