"""The photo-background trainers' batches (train/realbg.py) against the
reference's tools, on photos written under ``tmp_path``, from the
reference's own draws (tests/torch_realbg_helpers.py), at a small geometry:

- ``serve_down`` (the 720p render resized with ``asymmetric`` taps) within
  1e-5;
- the three-way batch of the active and u2 fine-tunes (the tools' own
  ``mixed_fn``), the two-way batch of the RVM fine-tune and the class-mixed
  batch of the multiclass pico (the tools' closures' arithmetic, written
  out with the reference's functions), the flagship's mixed batch
  (make_mixed_data_fn over the articulated people): frames and ground
  truth within 1e-5 (train/person.py's bar: sqrt, sin and the resize's
  taps may round differently);
- the schedules the tools hand their trainers (learning rates, batches,
  phases' steps) are the port's;
- the job and gate command lines: the refusals (no ``--photos``, a
  directory without a photo, a knob the job does not read, a candidate
  tree of no case) and one tiny run of each that writes its trees and
  report.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from tests import torch_realbg_helpers as RH
from tests.torch_threads import one_torch_thread  # noqa: F401
from tests.torch_train_helpers import TOOLS  # noqa: F401
from video_stream_segmenetation_tpu.ops.resize import resize_bilinear as j_resize
from video_stream_segmenetation_tpu.train import realdata as JR
from video_stream_segmenetation_tpu.train.face import synthetic_face_batch as j_face
from video_stream_segmenetation_tpu.train.loop import synthetic_matting_batch as j_batch
from video_stream_segmenetation_tpu_torch import evaluate as EV
from video_stream_segmenetation_tpu_torch.train import realbg as RB
from video_stream_segmenetation_tpu_torch.train import realdata as PR
from video_stream_segmenetation_tpu_torch.train.loop import render_matting_batch

import train_variants as TV  # noqa: E402  (tools/)

B, HW, RENDER = 4, (32, 48), (40, 64)
TOL = 1e-5


@pytest.fixture
def photos(tmp_path):
    (tmp_path / "photos").mkdir()
    RH.write_photos(tmp_path / "photos")
    return tmp_path


def _bank(photos, hw):
    return torch.as_tensor(PR.load_background_bank(hw, photos / "photos", oversample=2.0,
                                                   as_uint8=True))


def _close(got, want, what):
    for g, w, name in zip(got, want, ("frames", "ground truth")):
        assert g.shape == tuple(w.shape), (what, name, g.shape, w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL,
                                   err_msg=f"{what} {name}")


def _j_down(fr, a, hw):
    return (j_resize(fr, hw, method="asymmetric"),
            j_resize(a, hw, method="asymmetric", channel_last=False))


def test_serve_down_matches_reference():
    g = np.random.default_rng(0)
    fr = g.random((2, *RENDER, 3), dtype=np.float32)
    a = g.random((2, *RENDER), dtype=np.float32)
    _close(RB.serve_down(torch.as_tensor(fr), torch.as_tensor(a), HW), _j_down(fr, a, HW),
           "serve_down")


@pytest.mark.parametrize("tool", ["active", "u2"])
def test_three_way_batch_matches_the_tools(photos, monkeypatch, tool):
    calls = RH.run_tool(monkeypatch, photos, tool, hw=HW, batch=B, render_hw=RENDER)
    job = RB.JOBS[tool]
    key = jax.random.PRNGKey(3)
    want = calls[0]["data_fn"](key, B, HW)
    bank = _bank(photos, RENDER)
    draws = RH.ref_mix_draws(key, RB.THREE_WAY(B), len(bank), tuple(bank.shape[1:3]), HW,
                             RENDER)
    _close(RB.render_mix(bank, draws, HW, RENDER), want, tool)
    assert [c["lr"] for c in calls] == [job.lr, *(lr for lr, _ in job.phases)]
    if tool == "active":
        assert [c["steps"] for c in calls[1:]] == [s for _, s in job.phases]
        assert [c["hw"] for c in calls[1:]] == [job.small_hw, HW, job.small_hw]
    assert all(c["steps_per_call"] == RB.STEPS_PER_CALL and c["loss_fn"] is not None
               for c in calls)


def test_flagship_mixed_batch_matches_the_tool(photos, monkeypatch):
    calls = RH.run_tool(monkeypatch, photos, "flagship", hw=HW, batch=B)
    job, c = RB.JOBS["flagship"], calls[0]
    assert (c["lr"], c["seed"], c["steps_per_call"], c["log_every"]) == (
        job.lr, 3, RB.STEPS_PER_CALL, RB.LOG_EVERY)
    key = jax.random.PRNGKey(4)
    want = c["data_fn"](key, B, HW)
    bank = _bank(photos, HW)
    k1, k2 = jax.random.split(key)
    b_real = B // 2  # real_frac 0.5
    real = PR.render_articulated(bank, RH.ref_articulated_draws(
        k1, b_real, len(bank), tuple(bank.shape[1:3]), HW), HW)
    syn = render_matting_batch(RH.ref_synthetic_draws(k2, B - b_real, HW), HW)
    _close([torch.cat([r, s]) for r, s in zip(real, syn)], want, "flagship")


def test_two_way_batch_matches_the_tool(photos):
    """The RVM fine-tune's data_fn (tools/finetune_variants_realbg.py
    :118-125) written out with the reference's functions."""
    bank_np = JR.load_background_bank(RENDER, str(photos / "photos"), oversample=2.0,
                                      as_uint8=True)
    real = JR.make_real_bg_data_fn(bank_np, person="articulated")
    key = jax.random.PRNGKey(5)
    k1, k2 = jax.random.split(key)
    fr_r, a_r = _j_down(*real(k1, B // 2, RENDER), HW)
    fr_s, a_s = _j_down(*j_batch(k2, B - B // 2, RENDER), HW)
    want = (np.concatenate([fr_r, fr_s]), np.concatenate([a_r, a_s]))
    bank = torch.as_tensor(bank_np)
    draws = RH.ref_mix_draws(key, RB.TWO_WAY(B), len(bank), tuple(bank.shape[1:3]), HW, RENDER)
    _close(RB.render_mix(bank, draws, HW, RENDER), want, "two-way")


def test_class_mix_batch_matches_the_tool(photos):
    """The multiclass pico's batch (tools/finetune_variants_realbg.py
    :174-201) written out with the reference's functions."""
    bank_np = JR.load_background_bank(HW, str(photos / "photos"), oversample=2.0, as_uint8=True)
    real = JR.make_real_bg_data_fn(bank_np, person="articulated", return_parts=True)
    key = jax.random.PRNGKey(6)
    k1, k2, k3 = jax.random.split(key, 3)
    b_r, b_f = B // 2, max(1, B // 4)
    fr_r, _, parts_r = real(k1, b_r, HW)
    fr_s, _, _, parts_s = j_face(k2, b_f, HW, return_parts=True)
    fr_e, a_e = j_batch(k3, B - b_r - b_f, HW)
    parts_e = {"a_body": a_e, "a_head": np.zeros_like(a_e), "feat": np.zeros_like(a_e)}
    want = (np.concatenate([fr_r, fr_s, fr_e]),
            np.concatenate([TV._class_simplex(p) for p in (parts_r, parts_s, parts_e)]))
    bank = torch.as_tensor(bank_np)
    draws = RH.ref_mix_draws(key, RB.CLASS_MIX(B), len(bank), tuple(bank.shape[1:3]), HW, RENDER)
    _close(RB.render_mix(bank, draws, HW, RENDER, classes=True), want, "class mix")


def test_the_variant_tools_schedules_are_the_ports(photos, monkeypatch):
    calls = RH.run_tool(monkeypatch, photos, "rvm", hw=HW, batch=2, unroll=2, render_hw=RENDER)
    assert [c["lr"] for c in calls] == [RB.JOBS["rvm"].lr]
    calls = RH.run_tool(monkeypatch, photos, "multiclass_pico", hw=(40, 80), batch=B,
                        small_hw=(40, 60), small_batch=B)
    steps = 1
    assert [(c["lr"], c["steps"]) for c in calls] == [
        (3e-4, max(steps // 2, RB.MC_MIN_STEPS[0])), (RB.JOBS["multiclass_pico"].lr, steps),
        (7e-5, max(steps // 4, RB.MC_MIN_STEPS[1]))]
    calls = RH.run_tool(monkeypatch, photos, "realbg", hw=HW, batch=B)
    job = RB.JOBS["realbg"]
    assert [(c["lr"], c["seed"]) for c in calls] == [(job.lr, 0)] * 2
    assert calls[0].get("data_fn") is None and calls[1]["data_fn"] is not None


# ---- the command lines ----------------------------------------------------


def test_job_command_line_refusals(tmp_path, capsys):
    with pytest.raises(SystemExit):
        RB.parse_args(["u2", "--out", str(tmp_path)])
    assert "--photos" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        RB.parse_args(["u2", "--photos", str(tmp_path), "--out", str(tmp_path),
                       "--real-frac", "0.3"])
    assert "flagship only" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        RB.parse_args(["nope", "--photos", str(tmp_path), "--out", str(tmp_path)])
    (tmp_path / "empty").mkdir()
    (tmp_path / "empty" / "notes.txt").write_text("no photo")
    for where in ("empty", "absent"):
        with pytest.raises(FileNotFoundError):
            RB.main(["u2", "1", "--photos", str(tmp_path / where), "--out", str(tmp_path / "o"),
                     "--device", "cpu"])
    assert not (tmp_path / "o").exists()
    a = RB.parse_args(["flagship", "7", "--photos", "p", "--out", "o", "--real-frac", "0.3",
                       "--no-pipe-loss", "--promote", "--lr", "1e-4", "--batch", "2"])
    assert (a.steps, a.real_frac, a.no_pipe_loss, a.promote, a.lr, a.batch, a.device) == (
        7, 0.3, True, True, 1e-4, 2, "cuda")


def test_gate_command_line_refusals(capsys):
    with pytest.raises(SystemExit):
        EV.parse_args(["realistic"])
    assert "--photos" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        EV.parse_args(["variants", "--tree", "nocase=x"])
    with pytest.raises(SystemExit):
        EV.parse_args(["variants", "--tree", "u2"])
    with pytest.raises(ValueError, match="no case"):
        EV.variants(2, only="nope", device="cpu")


def test_a_job_and_both_gates_run_from_the_command_line(photos, monkeypatch):
    """u2 through ``main`` at a tiny geometry: its tree and report; then
    both gates serve that candidate for the u2 case at a small geometry."""
    monkeypatch.setattr(RB, "RENDER_HW", RENDER)
    monkeypatch.setattr(RB, "JOBS", {**RB.JOBS, "u2": dataclasses.replace(
        RB.JOBS["u2"], hw=(32, 32), batch=4)})
    out, report = photos / "out", photos / "u2.json"
    rep = RB.main(["u2", "2", "--photos", str(photos / "photos"), "--out", str(out),
                   "--report", str(report), "--device", "cpu"])
    assert json.loads(report.read_text()) == json.loads(json.dumps(rep))
    assert rep["trees"] == ["u2net_mix720"] and (out / "u2net_mix720" / "params.npz").exists()
    small = {"frame_hw": (40, 80), "mask_hw": (32, 32)}
    monkeypatch.setattr(EV, "CASES", (("u2", "u2", small),))
    for gate, extra in (("variants", []), ("realistic", ["--photos", str(photos / "photos")])):
        path = photos / f"{gate}.json"
        got = EV.main([gate, "--frames", "7", "--tree", f"u2={out / 'u2net_mix720'}", "--report",
                       str(path), "--device", "cpu", *extra])
        assert json.loads(path.read_text()) == json.loads(json.dumps(got))
        res = got["u2"]
        iou = res["static"]["iou_mean"] if gate == "variants" else res["iou_mean"]
        assert 0.0 <= iou <= 1.0 and got["trees"] == {"u2": str(out / "u2net_mix720")}
