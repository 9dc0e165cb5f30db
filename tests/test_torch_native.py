"""The port's native frame pool (runtime/native.py, its own build of
native/framebuf.cpp) against the reference's (the JAX package's
runtime/native.py over the committed library): the same frames pushed,
byte-equal batches, guide lanes, zeroed empty streams, the ring depth and
the I420 paths.  Small geometry: 80x160 frames, s2d block 10, a 32x64
mask (lanes geometry (4, 4), 48 lanes)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stream_segmenetation_tpu import ops as jops
from video_stream_segmenetation_tpu.runtime import native as jnative
from video_stream_segmenetation_tpu_torch.ops import layout as TL
from video_stream_segmenetation_tpu_torch.runtime import native as tnative

S, FH, FW, BLK = 5, 80, 160, 10
MASK = (32, 64)
SEL = TL.guide_s2d_sel((FH, FW), MASK, BLK)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(3)
    return (rng.random((2, S, FH, FW, 3)) * 255).astype(np.uint8)


def pools(depth=2, block=BLK, lanes=True):
    kw = dict(s2d_block=block, guide_lanes=SEL if lanes else None, depth=depth)
    return tnative.FramePool(S, FH, FW, **kw), jnative.FramePool(S, FH, FW, **kw)


def push(pool, frames, streams=range(S - 1)):
    """Every stream but the last gets a frame (the last stays empty)."""
    return [pool.push_rgb(s, frames[s]) for s in streams]


def test_port_builds_its_own_library():
    assert tnative.native_available()
    path = tnative.build()
    assert path.parent == tnative.BUILD_DIR and path.name.startswith("libvstio-")
    assert "native/libvstio.so" not in str(path)


def test_selection_is_the_references():
    want = jops.guide_s2d_sel((FH, FW), MASK, BLK, planar=True)
    np.testing.assert_array_equal(SEL, want)
    assert len(SEL) == 48


@pytest.mark.parametrize("block", [0, BLK])
def test_full_batch_byte_equal(frames, block):
    tp, jp = pools(block=block, lanes=bool(block))
    assert push(tp, frames[0]) == push(jp, frames[0])
    tb, tids = tp.assemble()
    jb, jids = jp.assemble()
    assert tb.dtype == np.uint8 and tb.shape == jb.shape
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tids, jids)
    if block:
        np.testing.assert_array_equal(tb, np.asarray(jops.space_to_depth(
            jnp.asarray(np.concatenate([frames[0][:-1], np.zeros_like(frames[0][:1])])), BLK)))
    tp.close()
    jp.close()


@pytest.mark.parametrize("rng_range", [(0, 2), (2, 5), (1, 4)])
def test_ranged_batch_and_lanes_byte_equal(frames, rng_range):
    i0, i1 = rng_range
    tp, jp = pools()
    push(tp, frames[0])
    push(jp, frames[0])
    tb, tids = tp.assemble_range(i0, i1)
    jb, jids = jp.assemble_range(i0, i1)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tids, jids)
    tl, jl = tp.lanes(), jp.lanes()
    assert tl.shape == (48, i1 - i0, FH // BLK, FW // BLK)
    np.testing.assert_array_equal(tl, jl)


def test_lanes_equal_the_gathered_lanes(frames):
    """The pool's lanes are guide_lanes_s2d of its packed batch, in both
    packages."""
    tp, _ = pools()
    push(tp, frames[1])
    tb, _ = tp.assemble()
    lanes = tp.lanes()
    got, geom = TL.guide_lanes_s2d(torch.as_tensor(tb), (FH, FW), MASK, BLK)
    want, _ = jops.guide_lanes_s2d(jnp.asarray(tb), (FH, FW), MASK, BLK)
    assert geom == (4, 4)
    np.testing.assert_array_equal(lanes, got.numpy())
    np.testing.assert_array_equal(lanes, np.asarray(want))


def test_empty_streams_are_zeroed(frames):
    tp, jp = pools()
    push(tp, frames[0])
    push(jp, frames[0])
    tb, tids = tp.assemble()
    jb, _ = jp.assemble()
    assert tids[-1] == 0 and (tb[-1] == 0).all() and (tp.lanes()[:, -1] == 0).all()
    assert (tb[0] != 0).any()
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tp.lanes(), jp.lanes())


@pytest.mark.parametrize("groups", [2, 3])
def test_ring_depth_keeps_a_rounds_views(frames, groups):
    """depth 2*G: the G group views (and their lanes) of one round survive
    the next round's G assembles, as the fused-round scheduler needs."""
    bounds = np.linspace(0, S, groups + 1).astype(int)
    tp, jp = pools(depth=2 * groups)
    views = []
    for pool in (tp, jp):
        push(pool, frames[0])
        kept = []
        for g in range(groups):
            b, _ = pool.assemble_range(bounds[g], bounds[g + 1])
            kept.append((b, b.copy(), pool.lanes(), pool.lanes().copy()))
        push(pool, frames[1])
        for g in range(groups):
            pool.assemble_range(bounds[g], bounds[g + 1])
        views.append(kept)
    for (tb, tb0, tl, tl0), (jb, jb0, jl, jl0) in zip(*views):
        np.testing.assert_array_equal(tb, tb0)
        np.testing.assert_array_equal(tl, tl0)
        np.testing.assert_array_equal(tb0, jb0)
        np.testing.assert_array_equal(tl0, jl0)


def test_depth_two_recycles_a_view(frames):
    """With depth 2 the third assemble writes the first one's buffer."""
    tp, _ = pools(depth=2)
    push(tp, frames[0])
    first, _ = tp.assemble()
    push(tp, frames[1])
    tp.assemble()
    tp.assemble()
    np.testing.assert_array_equal(first[0], np.asarray(jops.space_to_depth(
        jnp.asarray(frames[1][:1]), BLK))[0])


def test_bad_depth_and_lanes_are_refused():
    with pytest.raises(ValueError):
        tnative.FramePool(S, FH, FW, s2d_block=BLK, depth=1)
    with pytest.raises(ValueError):
        tnative.FramePool(S, FH, FW, s2d_block=0, guide_lanes=SEL)
    with pytest.raises(ValueError):
        tnative.FramePool(S, FH, FW, s2d_block=BLK, guide_lanes=[300])
    with pytest.raises(ValueError):
        tnative.FramePool(S, FH, FW, s2d_block=7)


def test_i420_push_and_encode_equal(frames):
    f = frames[0][0]
    ty, tu, tv = tnative.rgb_to_i420(f)
    jy, ju, jv = jnative.rgb_to_i420(f)
    for a, b in ((ty, jy), (tu, ju), (tv, jv)):
        np.testing.assert_array_equal(a, b)
    tp, jp = pools()
    assert tp.push_i420(1, ty, tu, tv) == jp.push_i420(1, jy, ju, jv)
    tb, _ = tp.assemble()
    jb, _ = jp.assemble()
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tp.lanes(), jp.lanes())
    packed = np.asarray(jops.space_to_depth(jnp.asarray(f), BLK))
    for a, b in zip(tnative.s2d_rgb_to_i420(packed, (FH, FW), BLK),
                    jnative.s2d_rgb_to_i420(packed, (FH, FW), BLK)):
        np.testing.assert_array_equal(a, b)


def test_drops_count_overwritten_frames(frames):
    tp, jp = pools()
    for pool in (tp, jp):
        for _ in range(5):
            pool.push_rgb(0, frames[0][0])
    assert tp.drops(0) == jp.drops(0) > 0
