"""Port's fused temporal refine (plain version of the CUDA kernel) vs the
JAX Pallas kernel fused_temporal_refine in its analytic-prior form, run in
interpret mode: planar u8 guide, bf16 refined output.

Tolerances (tests/test_temporal_refine_kernel.py): new_prev within 2e-5,
refined alpha within 4e-3 (bf16 output; the gamma curve is pow() here and
exp(g*log t) in the reference).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu import runtime
from video_stream_segmenetation_tpu.kernels.refine_fused import fused_temporal_refine as jax_refine
from video_stream_segmenetation_tpu_torch.kernels import refine_fused as TR
from video_stream_segmenetation_tpu_torch.runtime import config as TC

S, H, W = 4, 32, 64

# (name, affines, use_warp, initialized, has_prior, use_bilateral)
CASES = {
    "warp_prior_mixed": (
        [[1.02, 0.0, 1.5, 0.0, 0.98, -1.0], [1.0, 0, 0, 0, 1.0, 0],
         [1.1, 0.0, -3.2, 0.0, 0.9, 2.6], [0.95, 0.0, 4.0, 0.0, 1.05, -2.0]],
        [True, False, True, True], [True, True, True, True],
        [True, False, True, False], [True, True, False, True],
    ),
    # large translations: whole rows/columns read out of range (-> 0)
    "out_of_range": (
        [[1.0, 0.0, 40.0, 0.0, 1.0, -20.0], [1.0, 0.0, -70.0, 0.0, 1.0, 0.0],
         [2.0, 0.0, 0.0, 0.0, 2.0, 0.0], [1.0, 0.0, 0.0, 0.0, 1.0, 40.0]],
        [True, True, True, True], [True, True, True, True],
        [False, True, False, True], [True, True, True, True],
    ),
    # first frame: EMA copies, warp gated off by initialized
    "cold_start": (
        [[1.05, 0.0, 2.0, 0.0, 1.05, 1.0]] * 4,
        [False, False, False, False], [False, False, True, False],
        [True, True, False, False], [True, False, True, True],
    ),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_refine_matches_pallas_analytic(rng, case):
    affine, use_warp, init, has_prior, use_bi = (np.asarray(v) for v in CASES[case])
    affine = affine.astype(np.float32)
    alpha = rng.random((S, H, W), dtype=np.float32)
    prev = rng.random((S, H, W), dtype=np.float32)
    guide = rng.integers(0, 256, (S, 3, H, W), dtype=np.uint8)
    pp = np.asarray([[30.0, 14.0, 12.0, 10.0], [10.0, 20.0, 8.0, 6.0],
                     [50.0, 5.0, 20.0, 9.0], [32.0, 16.0, 1e-6, 7.0]], np.float32)
    ema_adapt = np.asarray([1.0, 0.0, 0.5, 1.0], np.float32)

    k = runtime.default_knobs(S)
    want_prev, want = jax_refine(
        jnp.asarray(alpha), jnp.asarray(prev), jnp.asarray(affine),
        jnp.asarray(use_warp & init), jnp.asarray(init), 0.3,
        jnp.asarray(guide), None, k.ema, k.noise_cutoff, k.high_threshold,
        k.gamma, jnp.asarray(use_bi), k.sigma_spatial, k.sigma_range,
        jnp.asarray(has_prior), knobs_ema_adapt=jnp.asarray(ema_adapt),
        interpret=True, guide_planar=True, prior_params=jnp.asarray(pp),
        out_dtype=jnp.bfloat16,
    )
    tk = TC.default_knobs(S)
    tk.use_bilateral = torch.as_tensor(use_bi)
    tk.ema_adapt = torch.as_tensor(ema_adapt)
    got_prev, got = TR.fused_temporal_refine(
        torch.as_tensor(alpha), torch.as_tensor(prev), torch.as_tensor(affine),
        torch.as_tensor(use_warp & init), torch.as_tensor(init), 0.3,
        torch.as_tensor(guide), torch.as_tensor(pp), torch.as_tensor(has_prior), tk,
    )
    assert got.dtype == torch.bfloat16 and got_prev.dtype == torch.float32
    np.testing.assert_allclose(got_prev.numpy(), np.asarray(want_prev), rtol=0, atol=2e-5)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=4e-3)


def test_scalar_table_columns():
    """The kernel's per-stream scalar table is laid out as KNOB_COLUMNS."""
    tk = TC.default_knobs(2)
    pp = torch.tensor([[1.0, 2.0, 3.0, 4.0], [5.0, 6.0, 7.0, 8.0]])
    t = TR.scalar_table(tk, torch.tensor([True, False]), torch.tensor([False, True]),
                        0.3, pp, torch.tensor([True, True]))
    assert t.shape == (2, len(TR.KNOB_COLUMNS)) and t.dtype == torch.float32
    col = dict(zip(TR.KNOB_COLUMNS, t.unbind(1)))
    assert col["use_warp"].tolist() == [1.0, 0.0]
    assert col["initialized"].tolist() == [0.0, 1.0]
    assert col["prior_ry"].tolist() == [4.0, 8.0]
    assert torch.allclose(col["warp_blend"], torch.tensor(0.3))
