"""The face subpath on the card against the CPU port: the MediaPipe graphs
on the torch ONNX executor, the NMS, the int8 face models, the translation
subpath and its warps (blaze_tracking's card/CPU IoU gap, ROADMAP Queue 3),
and a round of fast_int8_pico_refface without a host synchronisation.
Marked ``gpu``: without a card each test skips.  The machine with the card
has no JAX, so this file imports none; run it there with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_face_gpu.py -q
"""

import time

import numpy as np
import pytest
import torch

from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.models.blazeface import FaceFinder
from video_stream_segmenetation_tpu_torch.models.quantized_face import (
    QuantizedFaceFinder,
    QuantizedLandmarkNet,
    quantize_face_finder,
    quantize_landmark_net,
)
from video_stream_segmenetation_tpu_torch.models.reference_face import (
    ReferenceFaceFinder,
    ReferenceLandmarkNet,
)
from video_stream_segmenetation_tpu_torch.ops.detect import best_box_decode, nms_padded
from video_stream_segmenetation_tpu_torch.ops.resize import resize_frames_u8
from video_stream_segmenetation_tpu_torch.ops.warp import warp_affine_separable, warp_translate
from video_stream_segmenetation_tpu_torch.runtime import pipeline as P
from video_stream_segmenetation_tpu_torch.runtime.precision import pinned
from video_stream_segmenetation_tpu_torch.runtime.presets import preset
from video_stream_segmenetation_tpu_torch.runtime.state import init_state
from video_stream_segmenetation_tpu_torch.service.engine import Engine


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _fd_inputs(size):
    """The committed 720p frames, resized as blaze_tracking's detector takes
    them (a plain asymmetric resize to the fd square)."""
    clip, _ = bridge.load_frames()
    return resize_frames_u8(torch.as_tensor(clip), (size, size), "asymmetric")


@pytest.mark.gpu
def test_reference_graphs_on_card_match_cpu(card):
    """f32 under pinned precision on both sides: rtol 1e-4, atol 1e-5 (the
    reference's bar for its own graph against its numpy oracle)."""
    x = _fd_inputs(256)
    for model, xx in ((ReferenceFaceFinder, x),
                      (ReferenceLandmarkNet, torch.nn.functional.interpolate(
                          x.permute(0, 3, 1, 2), size=(192, 192)).permute(0, 2, 3, 1))):
        want = model("cpu")(xx)
        got = model(card)(xx.to(card))
        for k, w in want.items():
            torch.testing.assert_close(got[k].cpu(), w, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_nms_on_card_matches_cpu(card):
    g = np.random.default_rng(1)
    c = g.random((60, 2)).astype(np.float32)
    sz = (g.random((60, 2)) * 0.3 + 0.05).astype(np.float32)
    boxes = torch.tensor(np.concatenate([c - sz / 2, c + sz / 2], 1))
    scores = torch.tensor(g.random(60).astype(np.float32))
    want = nms_padded(boxes, scores, 12, 0.3, 0.2)
    got = nms_padded(boxes.to(card), scores.to(card), 12, 0.3, 0.2)
    for w, o in zip(want, got):
        assert torch.equal(o.cpu(), w)


@pytest.mark.gpu
def test_int8_face_models_on_card_match_cpu(card):
    """Exact int8 sums on both sides, the same f32 epilogues: the outputs
    equal within float32 rounding of the pooled mean."""
    trees = {n: bridge.load_export(bridge.WEIGHTS_DIR / f"{n}.npz")
             for n in ("facefinder_128", "landmarknet_128")}
    x = _fd_inputs(128).to(torch.float32) / 255.0
    with pinned():
        for make in (lambda d: QuantizedFaceFinder(quantize_face_finder(trees["facefinder_128"]),
                                                   128, device=d),
                     lambda d: QuantizedLandmarkNet(
                         quantize_landmark_net(trees["landmarknet_128"]), device=d)):
            want = make("cpu")(x)
            got = make(card)(x.to(card))
            for k, w in want.items():
                torch.testing.assert_close(got[k].cpu(), w, rtol=1e-6, atol=1e-6)


class _Fixed(torch.nn.Module):
    """A detector stand-in that returns the same outputs on any device."""

    def __init__(self, coords, scores):
        super().__init__()
        self.coords, self.scores = coords, scores

    def forward(self, x):
        return {"box_coords": self.coords.to(x.device), "box_scores": self.scores.to(x.device)}


@pytest.mark.gpu
def test_translation_subpath_teacher_forced_matches_cpu(card):
    """blaze_tracking's translation subpath, teacher-forced: the same
    frames, the same detector outputs and the same state on both sides, S=2
    over several cadence steps: the centres, the whole-pixel translations,
    has_update and det_score equal exactly; and the warps the step applies
    with them (the separable warp of the refine chain, warp_translate)
    equal exactly."""
    st = preset("blaze_tracking")
    g = np.random.default_rng(2)
    frames = torch.as_tensor(bridge.load_frames()[0])
    state = {d: init_state(2, st.mask_hw, device=d) for d in ("cpu", card)}
    for t in range(6):
        coords = torch.tensor(g.random((2, 224, 16)).astype(np.float32))
        coords[..., 2:4] = coords[..., 0:2] + 0.2
        scores = torch.tensor(g.random((2, 224)).astype(np.float32))
        outs = {}
        for d in ("cpu", card):
            s = state[d]
            outs[d] = P.face_translation_subpath(_Fixed(coords, scores), frames.to(d), s, st,
                                                 torch.ones(2, dtype=torch.bool, device=d))
            s.face_center, s.has_center = outs[d][3], outs[d][4]
            s.frame_idx = s.frame_idx + 1
        for w, o in zip(outs["cpu"], outs[card]):
            assert torch.equal(o.cpu(), w), t
    alpha = torch.tensor(g.random((2, *st.mask_hw)).astype(np.float32))
    aff = torch.tensor([[1.0, 0.0, 7.0, 0.0, 1.0, -3.0], [1.0, 0.0, -2.0, 0.0, 1.0, 5.0]])
    assert torch.equal(warp_affine_separable(alpha.to(card), aff.to(card)).cpu(),
                       warp_affine_separable(alpha, aff))
    assert torch.equal(warp_translate(alpha.to(card), aff[:, 2].to(card), aff[:, 5].to(card))
                       .cpu(), warp_translate(alpha, aff[:, 2], aff[:, 5]))


@pytest.mark.gpu
def test_face_finder_card_vs_cpu_is_bounded(card):
    """What is left to split the card's blaze_tracking from the CPU's: the
    bf16 FaceFinder's convolutions (cuDNN and the CPU round in other
    places).  On the committed frames at blaze_tracking's 128 input its
    normalized boxes are within 2e-3 and its scores within 1e-2 (the
    reference's own bf16 bars, tests/test_torch_face.py), so the box centre
    in mask pixels moves by at most 2e-3 * 512 ~ 1 pixel, and the JS
    round of the centre can flip by one pixel, which the translation's
    truncation passes on as a one-pixel translation."""
    st = preset("blaze_tracking")
    tree = bridge.load_export(bridge.WEIGHTS_DIR / "facefinder_128.npz")
    x = _fd_inputs(st.fd_size).to(torch.float32) / 255.0
    with pinned():
        want = FaceFinder(tree, st.fd_size, device="cpu")(x)
        got = FaceFinder(tree, st.fd_size, device=card)(x.to(card))
    torch.testing.assert_close(got["box_coords"].cpu(), want["box_coords"], rtol=0, atol=2e-3)
    torch.testing.assert_close(got["box_scores"].cpu(), want["box_scores"], rtol=0, atol=1e-2)
    bw = best_box_decode(want["box_coords"], want["box_scores"], st.frame_hw, st.fd_size,
                         letterboxed=False)[0]
    bg = best_box_decode(got["box_coords"].cpu(), got["box_scores"].cpu(), st.frame_hw,
                         st.fd_size, letterboxed=False)[0]
    mh, mw = st.mask_hw
    fh, fw = st.frame_hw
    cw = torch.stack([(bw[:, 0] + bw[:, 2]) / 2 / fw * mw, (bw[:, 1] + bw[:, 3]) / 2 / fh * mh])
    cg = torch.stack([(bg[:, 0] + bg[:, 2]) / 2 / fw * mw, (bg[:, 1] + bg[:, 3]) / 2 / fh * mh])
    assert float((cw - cg).abs().max()) <= 1.0


@pytest.mark.gpu
def test_refface_round_makes_no_host_sync(card):
    """fast_int8_pico_refface's round step (the MediaPipe graphs on the
    compact batch) runs under set_sync_debug_mode('error') after a priming
    round."""
    from video_stream_segmenetation_tpu_torch.runtime.scheduler import StreamScheduler

    eng = Engine(6, preset("fast_int8_pico_refface", frame_hw=(80, 160), mask_hw=(32, 64)),
                 device=card)
    eng.face_min_interval_s = 0.0
    sched = StreamScheduler(eng, group_sizes=[4, 2], fused_rounds=True)
    sched.admit_all()
    g = np.random.default_rng(0)
    for _ in range(2):
        for s in range(6):
            sched.push_frame(s, g.integers(0, 256, (80, 160, 3), dtype=np.uint8))
        sched.step_round()
    sched.drain()
    offs = sched.group_offsets
    step_frames = [eng._ingest(sched._group_frames(offs[i], offs[i + 1])[0],
                               rows=offs[i + 1] - offs[i])[1] for i in range(2)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = eng.round_step([4, 2], step_frames, time.monotonic())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert [tuple(o["alpha"].shape) for o in outs] == [(4, 32, 64), (2, 32, 64)]
    sched.stop()
