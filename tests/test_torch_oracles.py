"""The port's copy of the per-pixel oracles (utils/oracles.py) against the
JAX package's tests/oracles.py on seeded inputs: equal, exactly (the same
Python and numpy operations)."""

import numpy as np
import pytest

from tests import oracles as J
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu_torch.utils import oracles as T

H, W = 12, 20


def _same(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_the_copy_has_the_eight_oracles():
    names = sorted(n for n in dir(T) if n.endswith("_oracle"))
    assert names == ["bilateral_oracle", "closing_in_prior_oracle", "ema_oracle",
                     "face_prior_oracle", "opening_oracle", "refine_oracle",
                     "resize_bilinear_tfjs_oracle", "warp_affine_nearest_oracle"]
    for n in names:
        assert getattr(T, n).__doc__ == getattr(J, n).__doc__


@pytest.mark.parametrize("first", [True, False])
def test_ema(rng, first):
    prev = None if first else rng.random((H, W))
    cur = rng.random((H, W))
    _same(T.ema_oracle(prev, cur, 0.55), J.ema_oracle(prev, cur, 0.55))


def test_opening(rng):
    a = rng.random((H, W))
    _same(T.opening_oracle(a), J.opening_oracle(a))


@pytest.mark.parametrize("with_prior", [True, False])
def test_closing_in_prior(rng, with_prior):
    a = rng.random((H, W))
    prior = (rng.random((H, W)) - 0.4).clip(0) if with_prior else None
    _same(T.closing_in_prior_oracle(a, prior), J.closing_in_prior_oracle(a, prior))


def test_bilateral(rng):
    a = rng.random((H, W))
    guide = np.floor(rng.random((H, W, 3)) * 256)
    _same(T.bilateral_oracle(a, guide, 1.0, 12.0), J.bilateral_oracle(a, guide, 1.0, 12.0))


@pytest.mark.parametrize("with_prior", [True, False])
def test_refine(rng, with_prior):
    a = rng.random((H, W))
    prior = rng.random((H, W)) * (rng.random((H, W)) > 0.3) if with_prior else None
    _same(T.refine_oracle(a, 0.06, 0.95, 0.4, prior), J.refine_oracle(a, 0.06, 0.95, 0.4, prior))


@pytest.mark.parametrize("box", [(3.2, 1.5, 14.7, 10.1), (-4.0, 2.0, 30.0, 7.5)])
def test_face_prior(box):
    _same(T.face_prior_oracle(box, 40, 24, W, H), J.face_prior_oracle(box, 40, 24, W, H))


@pytest.mark.parametrize("affine", [(1.02, 0.05, 1.5, -0.03, 0.98, -2.0),
                                    (1.0, 0.0, 30.0, 0.0, 1.0, -15.0), (0, 0, 1, 0, 0, 1)])
def test_warp_affine_nearest(rng, affine):
    src = rng.random((H, W))
    _same(T.warp_affine_nearest_oracle(src, affine), J.warp_affine_nearest_oracle(src, affine))


@pytest.mark.parametrize("out_hw", [(5, 8), (30, 44)])
def test_resize_bilinear_tfjs(rng, out_hw):
    img = rng.random((H, W, 3)) * 255
    _same(T.resize_bilinear_tfjs_oracle(img, *out_hw), J.resize_bilinear_tfjs_oracle(img, *out_hw))
