"""The s2d layout's warp, guide and upsample options on fast_int8_pico, the
port's Engine against the JAX Engine on the CPU (tests/torch_s2d_engines.py
::run_pico: trained pico and 128 face models, 80x160, mask 32x64, S=2, 8
steps, free-running and teacher-forced):

* ``warp_impl='exact'`` with ``upsample_precision='exact'`` and
  ``upsample_method='align_corners'``: the 2-D nearest warp, the blend and
  the EMA in PyTorch, then ``fused_refine`` (the reference's Pallas kernel
  in interpret mode) on the planar u8 guide and the plane prior, then the
  packed composite's f32 products at the align-corners taps (chip_smoke.py's
  phase);
* ``guide_impl='bilinear'``: the guide is the unpacked frames' resize
  (never planar in the reference, so its route is the HWC guide) into the
  fused temporal refine, and the face path's source; with
  ``preprocess_precision='exact'``, the resize's f32 products, which the
  CPU reference's DEFAULT precision computes too (with 'fast' the port
  takes the TPU's bf16 pass, tests/test_torch_active_options.py);
* ``upsample_method='asymmetric'``: the packed composite at the asymmetric
  taps.

Tolerances (tests/test_torch_face_options.py's for the same outputs):
the face decisions and state as its ``assert_face_matches``; teacher-forced,
the refined alpha within 4e-3 (bf16 out: one bf16 step near 1 plus exp/pow
ulps), new_prev within 1e-4, the frame within one u8 step.
"""

import pytest

from tests import torch_s2d_engines as SE
from tests.test_torch_face_options import assert_face_matches, assert_step_matches
from tests.torch_threads import one_torch_thread  # noqa: F401

ROUTES = {
    "exact_warp_exact_align_corners": {"warp_impl": "exact", "upsample_precision": "exact",
                                       "upsample_method": "align_corners"},
    "bilinear_guide": {"guide_impl": "bilinear", "preprocess_precision": "exact"},
    "asymmetric": {"upsample_method": "asymmetric"},
}


@pytest.fixture(scope="module", params=sorted(ROUTES))
def engines(request):
    return SE.run_pico(ROUTES[request.param])


def test_face_decisions_match(engines):
    jouts, touts, _ = engines
    assert_face_matches(jouts, touts)
    assert not any(g["passthrough"] for g in touts)


@pytest.mark.parametrize("step", range(8))
def test_step_matches(engines, step):
    jouts, _, forced = engines
    assert_step_matches(jouts[step], forced[step], alpha_tol=4e-3, prev_tol=1e-4)
