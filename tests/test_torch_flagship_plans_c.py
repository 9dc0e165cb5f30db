"""The flagship's plan C (``mattenet_hd10_lite``) job on the port's ``fit``
against the reference's (tests/torch_flagship_jobs.py: one step's loss and
gradient in f32 and bf16, BatchNorm statistics included, three steps of
``fit`` in f32), the port's job table against the
jobs tools/train_flagship.py runs (its ``fit`` and ``save_params``
replaced by recorders), and ``main`` at a tiny geometry: the new jobs'
exports load back and plan A's and the MatteNet's serve a step of the
presets that serve them (``fast``, ``active``).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tests import torch_flagship_jobs as FJ
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import MatteNetHD
from video_stream_segmenetation_tpu_torch.runtime.presets import preset
from video_stream_segmenetation_tpu_torch.service.engine import Engine
from video_stream_segmenetation_tpu_torch.train import flagship as FL

import train_flagship as TFL  # noqa: E402  (tools/, on the path tests/torch_train_helpers.py sets)

KEYS = ("light",)


@pytest.fixture(scope="module")
def grads():
    return FJ.grads_of(KEYS)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("key", KEYS)
def test_gradients_match_reference(grads, key, dtype):
    FJ.check_grads(grads, key, dtype)


@pytest.mark.parametrize("key", KEYS)
def test_fit_f32_losses_match_reference(monkeypatch, key):
    FJ.check_fit(monkeypatch, key)


def test_jobs_are_the_references(tmp_path, monkeypatch):
    """Every job of tools/train_flagship.py, its model, geometry, batches
    and learning rates, is a row of the port's JOBS."""
    ran = []

    def fake_fit(model, hw, batch, steps, lr, log_every, init_params=None, seed=0):
        ran.append((model, tuple(hw), batch, lr, init_params is not None))
        return {}, [{"iou": 0.0}]

    monkeypatch.setattr(TFL.train, "fit", fake_fit)
    saved = []
    monkeypatch.setattr(TFL.utils, "save_params", lambda path, params: saved.append(
        os.path.basename(path)))
    monkeypatch.setattr(TFL, "OUT", str(tmp_path / "checkpoints"))
    os.makedirs(tmp_path / "benchmarks")
    TFL.main(steps=4)
    assert saved == [j.name for j in FL.JOBS.values()]
    pre = [r for r in ran if not r[4]]
    ft = [r for r in ran if r[4]]
    assert len(pre) == len(ft) == len(FL.JOBS)
    for job, (model, hw, b, lr, _), (_, shw, sb, slr, _) in zip(FL.JOBS.values(), pre, ft):
        if job.arch == "mattenet":
            assert type(model).__name__ == "MatteNet" and model.num_classes == 1
        else:
            assert (model.stem_stride, model.head_upsample, model.decoder) == (
                job.stem_stride, job.head_upsample, job.decoder)
        assert (hw, b, lr, shw, sb, slr) == (job.pretrain_hw, job.pretrain_batch, job.lr,
                                           job.serve_hw, job.serve_batch, job.lr / 3)


def test_main_writes_new_jobs(tmp_path, monkeypatch):
    small = {"plan_a": (40, 80), "full": (40, 80), "light": (40, 80), "mattenet": (32, 64)}
    monkeypatch.setattr(FL, "JOBS", {k: dataclasses.replace(
        j, pretrain_hw=small[k], pretrain_batch=2, serve_hw=small[k], serve_batch=2)
        for k, j in FL.JOBS.items() if k in small})
    monkeypatch.setattr(FL, "FT_MIN_STEPS", 1)
    quality = FL.main(tmp_path, steps=1, only={"plan_a", "mattenet_hd10", "light", "mattenet"},
                      device="cpu")
    assert set(quality) == {"mattenet_hd", "mattenet_hd10", "mattenet_hd10_lite", "mattenet"}
    trees = {n: bridge.load_export(tmp_path / f"{n}.npz") for n in quality}
    MatteNetHD(5, 2, "full", params=trees["mattenet_hd"], device="cpu")
    MatteNetHD(10, 4, "full", params=trees["mattenet_hd10"], device="cpu")
    MatteNetHD(10, 4, "light", params=trees["mattenet_hd10_lite"], device="cpu")
    frames = np.random.default_rng(0).integers(0, 256, (2, 80, 160, 3), dtype=np.uint8)
    for name, tree in (("fast", trees["mattenet_hd"]), ("active", trees["mattenet"])):
        eng = Engine(2, preset(name, frame_hw=(80, 160), mask_hw=(32, 64), face_path=False),
                     params=tree, device="cpu")
        eng.admit_all()
        out = eng.process(frames)
        assert out["alpha"].shape == (2, 32, 64) and eng.stats()["passthrough_steps"] == 0
