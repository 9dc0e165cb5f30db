"""utils/checkpoint.py in the port's numpy format: the reference's
checkpoint round trip (tests/test_variants.py::test_checkpoint_roundtrip)
on the port's Engine; trees with bf16, int8, tensor, tuple and None leaves
round-tripped bit for bit; ``like`` casting; the geometry-keyed face
paths against the reference's; and a restored engine (s2d pico with the
face path on, and the natural engine) whose next steps equal the
uninterrupted engine's, bit for bit.
"""

import numpy as np
import pytest
import torch

from tests import torch_natural_engines as NE
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu.utils import checkpoint as JC
from video_stream_segmenetation_tpu_torch import bridge, utils
from video_stream_segmenetation_tpu_torch.runtime.config import PipelineStatics, default_knobs
from video_stream_segmenetation_tpu_torch.runtime.presets import preset
from video_stream_segmenetation_tpu_torch.runtime.state import init_state, state_tensors
from video_stream_segmenetation_tpu_torch.service.engine import Engine

FRAME_HW = (48, 64)
MASK_HW = (32, 64)
S2D = dict(frame_hw=(80, 160), mask_hw=(32, 64), fd_size=64, lmk_size=48)


def test_checkpoint_roundtrip(tmp_path, rng):
    """The reference's test on the port: state and a staged knob survive a
    snapshot into a reset engine, which keeps serving."""
    statics = PipelineStatics(frame_hw=FRAME_HW, mask_hw=MASK_HW, fd_size=64, lmk_size=48,
                              background="color", face_path=False)
    eng = Engine(2, statics, device="cpu")
    eng.admit()
    frames = (rng.random((2, *FRAME_HW, 3)) * 255).astype(np.uint8)
    eng.process(frames)
    eng.set_knobs(0, gamma=1.7)
    eng.process(frames)
    utils.save_engine(str(tmp_path / "ck"), eng)

    before = eng.state.prev_alpha.numpy().copy()
    eng.state = init_state(2, MASK_HW, device="cpu")
    eng.knobs = default_knobs(2)
    utils.restore_engine(str(tmp_path / "ck"), eng)
    np.testing.assert_array_equal(eng.state.prev_alpha.numpy(), before)
    assert float(eng.knobs.gamma[0]) == pytest.approx(1.7)
    out = eng.process(frames)
    assert np.isfinite(out["alpha"].numpy()).all()


def test_tree_round_trip_bit_for_bit(tmp_path):
    """bf16 tensors come back as bf16 tensors with the same bits; numpy
    leaves keep their dtype (int8, f32, uint8); tuples, lists, None and
    empty nodes keep their structure; keys holding '/' (the int8 serving
    dict's) survive."""
    g = torch.Generator().manual_seed(0)
    bf = torch.randn(3, 5, generator=g).to(torch.bfloat16)
    bf[0, 0] = float("inf")
    tree = {"stem_w": bf, "b1/c0": {"wq": np.arange(-4, 4, dtype=np.int8),
                                    "mult": np.linspace(0, 1, 7, dtype=np.float32)},
            "state": {"rec": (), "pair": (torch.ones(2, dtype=torch.bool), None),
                      "frame_idx": torch.tensor([3, 4], dtype=torch.int32)},
            "lst": [np.uint8(7), np.zeros((2, 2), np.float64)], "none": None, "empty": {}}
    utils.save_params(str(tmp_path / "t"), tree)
    got = utils.restore_params(str(tmp_path / "t"))
    assert got["stem_w"].dtype == torch.bfloat16
    assert torch.equal(got["stem_w"].view(torch.int16), bf.view(torch.int16))
    for k in ("wq", "mult"):
        np.testing.assert_array_equal(got["b1/c0"][k], tree["b1/c0"][k])
        assert got["b1/c0"][k].dtype == tree["b1/c0"][k].dtype
    assert got["state"]["rec"] == () and got["state"]["pair"][1] is None
    assert torch.equal(got["state"]["pair"][0], tree["state"]["pair"][0])
    assert got["state"]["frame_idx"].dtype == torch.int32
    assert isinstance(got["lst"], list) and got["lst"][1].dtype == np.float64
    assert got["none"] is None and got["empty"] == {}
    with pytest.raises(FileExistsError):
        utils.save_params(str(tmp_path / "t"), tree, overwrite=False)


def test_restore_like_casts_and_places(tmp_path):
    tree = {"a": np.arange(4, dtype=np.float32), "b": torch.arange(3, dtype=torch.int32)}
    utils.save_params(str(tmp_path / "t"), tree)
    like = {"a": torch.zeros(4, dtype=torch.float64), "b": np.zeros(3, np.int64)}
    got = utils.restore_params(str(tmp_path / "t"), like=like)
    assert got["a"].dtype == torch.float64 and got["a"].device == like["a"].device
    assert got["b"].dtype == np.int64
    np.testing.assert_array_equal(got["b"], [0, 1, 2])


@pytest.mark.parametrize("fd,lmk", [(256, 192), (128, 128), (128, 96)])
def test_face_checkpoint_paths_match_reference(fd, lmk):
    assert utils.face_checkpoint_paths("ck", fd, lmk) == JC.face_checkpoint_paths("ck", fd, lmk)


def _serve(eng, frames, steps):
    return [eng.process(frames[t % len(frames)]) for t in range(steps)]


def _same(a, b):
    for k in ("frame", "alpha", "face_applied", "det_score"):
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("kind", ["pico_face", "natural"])
def test_restored_engine_steps_as_the_uninterrupted_one(tmp_path, kind):
    """An engine served 3 steps is saved; a fresh engine of the same statics
    (another seed: its own weights are replaced) restores the snapshot; both
    then serve the same frames, and every output and the state are equal
    bit for bit."""
    frames = [np.ascontiguousarray(np.concatenate([f, f[::-1]])) for f in NE.engine_frames()]
    if kind == "pico_face":
        st = preset("fast_int8_pico", **S2D)
        kw = bridge.trained_weights(preset("fast_int8_pico"))  # the 128 face models
    else:
        st = PipelineStatics(frame_hw=(80, 160), mask_hw=(32, 64), fd_size=64, lmk_size=48)
        kw = {}
    a = Engine(4, st, device="cpu", **kw)
    a.face_min_interval_s = 0.0
    a.admit_all()
    _serve(a, frames, 3)
    a.set_knobs(1, gamma=0.8, ema=0.3)
    a.process(frames[3])
    utils.save_engine(str(tmp_path / "eng"), a)
    b = Engine(4, st, device="cpu", seed=9)
    b.face_min_interval_s = 0.0
    b.admit_all()
    utils.restore_engine(str(tmp_path / "eng"), b)
    for ta, tb in zip(state_tensors(a.state), state_tensors(b.state)):
        assert ta.dtype == tb.dtype and torch.equal(ta, tb)
    for ra, rb in zip(_serve(a, frames[4:], 4), _serve(b, frames[4:], 4)):
        _same(ra, rb)
    for ta, tb in zip(state_tensors(a.state), state_tensors(b.state)):
        assert torch.equal(ta, tb)
    assert float(b.knobs.ema[1]) == pytest.approx(0.3)


def test_missing_knob_restores_at_the_default(tmp_path):
    """A snapshot taken before a knob existed restores it at the engine's
    default (the reference's forward compatibility)."""
    st = PipelineStatics(frame_hw=FRAME_HW, mask_hw=MASK_HW, fd_size=64, lmk_size=48,
                         face_path=False, ema_adapt_default=0.25)
    eng = Engine(2, st, device="cpu")
    eng.set_knobs(0, gamma=1.3, ema_adapt=0.9)
    eng._apply_staged()
    utils.save_engine(str(tmp_path / "ck"), eng)
    snap = utils.restore_params(str(tmp_path / "ck"))
    del snap["knobs"]["ema_adapt"]
    utils.save_params(str(tmp_path / "ck"), snap)
    utils.restore_engine(str(tmp_path / "ck"), eng)
    assert float(eng.knobs.gamma[0]) == pytest.approx(1.3)
    np.testing.assert_allclose(eng.knobs.ema_adapt.numpy(), [0.25, 0.25])
