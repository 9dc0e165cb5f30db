"""The fused composite's plain version (kernels/composite_fused.py, the CPU
side of csrc/composite_fused.cu) against the reference's Pallas kernel
``fused_composite`` in interpret mode, and the tap tables the kernel reads.

Tolerance: equal at all but a few values, none more than one u8 step.
Both compute the upsample as the reference's kernel does (the rows of
``V @ alpha`` rounded to bf16, then bf16 horizontal weights with f32 sums,
clip, blend in u8 units, round half up); the port sums each row's two
vertical taps in f64 and rounds once, where the interpret-mode f32 dot may
round the two products apart, one f32 step that can flip the bf16
rounding of a row value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu.kernels.composite_fused import fused_composite as jfc
from video_stream_segmenetation_tpu_torch.kernels import composite_fused as TC
from video_stream_segmenetation_tpu_torch.ops.resize import _interp_matrix

T = torch.tensor


def _case(rng, s, h, w, mh, mw, bg_rows=None):
    frames = rng.integers(0, 256, (s, h, w, 3), dtype=np.uint8)
    bg = rng.integers(0, 256, (bg_rows or s, h, w, 3), dtype=np.uint8)
    alpha = rng.random((s, mh, mw), dtype=np.float32)
    alpha[0, : mh // 4] = 0.0  # fully background rows
    alpha[-1, -(mh // 4):] = 1.0  # fully foreground rows
    return frames, alpha, bg


def _held(got, want, share=1e-3):
    got, want = got.astype(np.int32), want.astype(np.int32)
    diff = np.abs(got - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= share, (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("s,h,w,mh,mw", [(2, 80, 160, 32, 64), (2, 160, 128, 64, 64),
                                         (1, 80, 100, 36, 40)],
                         ids=["80x160", "160x128", "ragged-80x100"])
def test_plain_matches_pallas(rng, s, h, w, mh, mw):
    frames, alpha, bg = _case(rng, s, h, w, mh, mw)
    want = np.asarray(jfc(jnp.asarray(frames), jnp.asarray(alpha), jnp.asarray(bg),
                          interpret=True))
    got = TC.fused_composite(T(frames), T(alpha), T(bg))
    assert got.dtype == torch.uint8 and tuple(got.shape) == frames.shape
    _held(got.numpy(), want)


def test_plain_broadcasts_one_background(rng):
    frames, alpha, bg = _case(rng, 2, 80, 160, 32, 64, bg_rows=1)
    want = np.asarray(jfc(jnp.asarray(frames), jnp.asarray(alpha), jnp.asarray(bg),
                          interpret=True))
    _held(TC.fused_composite(T(frames), T(alpha), T(bg)).numpy(), want)


def test_plain_extremes(rng):
    """alpha 1 passes the frame through, alpha 0 the background (bf16 alpha
    is read as f32)."""
    frames, _, bg = _case(rng, 2, 80, 160, 32, 64)
    ones = torch.ones((2, 32, 64), dtype=torch.bfloat16)
    np.testing.assert_array_equal(TC.fused_composite(T(frames), ones, T(bg)).numpy(), frames)
    np.testing.assert_array_equal(
        TC.fused_composite(T(frames), torch.zeros((2, 32, 64)), T(bg)).numpy(), bg)


@pytest.mark.parametrize("out_size,in_size", [(720, 288), (1280, 512), (80, 32), (100, 40),
                                              (64, 64)])
def test_two_taps_rebuild_the_matrix(out_size, in_size):
    """The kernel's tap tables hold every nonzero of the interpolation
    matrix (at most two a row; one-tap rows carry a zero second weight)."""
    idx, wgt = TC._two_taps(out_size, in_size, "half_pixel")
    m = np.zeros((out_size, in_size), np.float32)
    for r in range(out_size):
        for k in range(2):
            m[r, idx[r, k]] += wgt[r, k]
    np.testing.assert_array_equal(m, _interp_matrix(out_size, in_size, "half_pixel"))
    assert np.all(idx[:, 0] <= idx[:, 1])


def test_plain_refuses_nothing_on_cpu_and_counts_no_launch(rng):
    frames, alpha, bg = _case(rng, 1, 80, 160, 32, 64)
    n = TC.fused_composite.launches
    TC.fused_composite(T(frames), T(alpha), T(bg))
    assert TC.fused_composite.launches == n
