"""On the card: ``Engine(mesh=...)`` over 4 virtual shards of it against the
one-device Engine (process and dispatch/collect; the trunk and the refine
kernel launched 4 times as often), the fused rotation in groups [11, 5]
with one more mesh round under ``set_sync_debug_mode('error')``, and
``fit(mesh=...)`` against one device.  The small geometry of
tests/torch_mesh_engines.py, the committed numpy weights.  Marked ``gpu``:
without a card each test skips.  The card's machine has no JAX, so this
file imports none; run it there with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_mesh_gpu.py -q

Bars: the reference's mesh bars (frames within one u8 step on all but
0.1 % of the pixels, alpha and prev_alpha within 2e-2, face_applied and
frame_idx equal); one step's loss within 1e-4 relative and its summed
gradients' least leaf cosine chip_smoke.py's MESH_GRAD_COS against one
device, and fit's losses within 1e-4 relative (chip_smoke.py's mesh
phase).
"""

import time

import numpy as np
import pytest
import torch

from video_stream_segmenetation_tpu_torch import bridge, parallel
from video_stream_segmenetation_tpu_torch.kernels import refine_fused, trunk_int8
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import MatteNetHD
from video_stream_segmenetation_tpu_torch.runtime.presets import preset
from video_stream_segmenetation_tpu_torch.runtime.scheduler import StreamScheduler
from video_stream_segmenetation_tpu_torch.service.engine import Engine
from video_stream_segmenetation_tpu_torch.train.loop import fit
from video_stream_segmenetation_tpu_torch.utils.clips import articulated_clip

S, N, SIZES = 16, 4, [11, 5]
GEOM = dict(frame_hw=(80, 160), mask_hw=(32, 64), fd_size=64, lmk_size=48)
COUNTERS = (trunk_int8.fused_nano_trunk_alpha, refine_fused.fused_temporal_refine)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _frames(steps=4):
    clips = [np.asarray(articulated_clip(n_frames=steps + S // 4, hw=(80, 160), seed=sd,
                                         features=True, device="cpu").frames)
             for sd in (2, 1)]
    return [np.stack([clips[s % 2][t + s // 4] for s in range(S)]) for t in range(steps)]


def _engine(card, mesh):
    w = bridge.WEIGHTS_DIR
    eng = Engine(S, preset("fast_int8_pico", **GEOM), device=card, mesh=mesh,
                 params=bridge.load_export(w / "mattenet_hd10_pico.npz"),
                 face_params={"face": bridge.load_export(w / "facefinder_128.npz"),
                              "lmk": bridge.load_export(w / "landmarknet_128.npz")})
    eng.face_min_interval_s = 0.0
    eng.admit_all()
    return eng


def _close(g, w, what):
    assert torch.equal(g["face_applied"].cpu(), w["face_applied"].cpu()), what
    d = (g["frame"].to(torch.int32) - w["frame"].to(torch.int32)).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 1e-3, what
    assert float((g["alpha"].float() - w["alpha"].float()).abs().max()) <= 2e-2, what


def _counted(fn):
    for c in COUNTERS:
        c.launches = 0
    out = fn()
    return out, [c.launches for c in COUNTERS]


@pytest.mark.gpu
def test_mesh_engine_matches_one_device_on_the_card(card):
    fr = _frames()
    mesh = parallel.make_mesh(N, devices=[card] * N)

    def serve(eng):
        return ([eng.process(fr[t]) for t in range(3)]
                + [eng.collect(eng.dispatch(fr[3]))])

    one_eng, mesh_eng = _engine(card, None), _engine(card, mesh)
    one, one_n = _counted(lambda: serve(one_eng))
    got, got_n = _counted(lambda: serve(mesh_eng))
    assert one_n == [4, 4] and got_n == [N * n for n in one_n]
    for t, (g, w) in enumerate(zip(got, one)):
        assert not g["passthrough"] and g["frame"].device == card
        _close(g, w, f"step {t}")
    assert torch.equal(mesh_eng.state.frame_idx, one_eng.state.frame_idx)
    assert float((mesh_eng.state.prev_alpha - one_eng.state.prev_alpha).abs().max()) <= 2e-2


@pytest.mark.gpu
def test_mesh_fused_round_makes_no_host_sync(card):
    fr = _frames()
    mesh = parallel.make_mesh(N, devices=[card] * N)
    results = {}
    for name, m in (("one", None), ("mesh", mesh)):
        eng = _engine(card, m)
        sched = StreamScheduler(eng, use_native_pool=False, group_sizes=SIZES,
                                fused_rounds=True, frame_source=lambda i0, i1: fr[0][i0:i1])
        outs = []
        for _ in range(3):
            outs.extend(sched.step_round() or [])
        outs.extend(sched.drain())
        results[name] = (eng, outs)
        sched.stop()
    for i, (g, w) in enumerate(zip(results["mesh"][1], results["one"][1])):
        assert g["slots"] == w["slots"]
        _close(g, w, f"group result {i}")
    eng = results["mesh"][0]
    step_frames = [eng._ingest(fr[1][a:b], rows=b - a, i0=a)[1]
                   for a, b in ((0, SIZES[0]), (SIZES[0], S))]
    torch.cuda.synchronize()
    eng._dispatches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = eng.round_step(SIZES, step_frames, time.monotonic())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert [o["frame"].shape[0] for o in outs] == SIZES


@pytest.mark.gpu
def test_fit_on_a_mesh_matches_one_device_on_the_card(card):
    runs = {}
    for name, mesh in (("one", None), ("mesh", parallel.make_mesh(N, devices=[card] * N))):
        model = MatteNetHD(10, 4, "pico", dtype=torch.float32, device=card)
        runs[name] = fit(model, hw=(80, 160), batch=8, steps=3, lr=5e-4, log_every=1,
                         mesh=mesh)
    (_, h1), (_, hm) = runs["one"], runs["mesh"]
    for a, b in zip(hm, h1):
        assert abs(a["loss"] - b["loss"]) <= 1e-4 * abs(b["loss"])
    import chip_smoke

    gap = chip_smoke.dp_grad_gap(parallel.make_mesh(N, devices=[card] * N), card, (80, 160), 8)
    assert gap["loss_rel"] <= 1e-4 and gap["min_cos"] >= chip_smoke.MESH_GRAD_COS, gap
