"""The port's K-class MatteNetHD trainer (train/variants.py::
train_multiclass_hd, ``_trainer``, ``main``) against the reference's
(tools/train_variants.py): the pico trunk with 4 classes at 80x160, batch 2
(tests/torch_variant_jobs.py).

- One step's loss and gradient, BatchNorm statistics included, at the bars
  of tests/torch_train_helpers.py.
- Three steps of each side's ``_trainer`` in f32 from the reference's init
  tree, the reference's own pretraining loss drawing its batches from the
  keys its loop hands it, the port fed those batches: losses within 1e-4
  relative (the updates feed back).
- ``main`` at a tiny geometry writes the five exports, which load back, and
  the quantized K-class pico tree serves a step of
  ``multiclass_fast_pico`` (class maps summing to 1 within 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_train_helpers as H
from tests import torch_variant_jobs as VJ
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import MatteNetHD
from video_stream_segmenetation_tpu_torch.models.modnet import MatteNet
from video_stream_segmenetation_tpu_torch.models.rvm import RecurrentMatteNet
from video_stream_segmenetation_tpu_torch.models.u2net import SaliencyNet
from video_stream_segmenetation_tpu_torch.runtime.presets import preset
from video_stream_segmenetation_tpu_torch.service.engine import Engine
from video_stream_segmenetation_tpu_torch.train import variants as PV

B = VJ.B


@pytest.fixture(scope="module")
def grads():
    return VJ.grads_of(["multiclass_hd"])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gradients_match_reference(grads, dtype):
    VJ.check_grads(grads, "multiclass_hd", dtype)


def test_trainer_f32_matches_reference(monkeypatch):
    steps, lr = 3, 5e-4
    tree, loss_fn = VJ.reference_job(monkeypatch, "multiclass_hd", jnp.float32)
    record, ref_losses = H.recorder()

    def recorded(params, key):
        loss, metrics = loss_fn(params, key)
        record(loss)
        return loss, metrics

    VJ.REF_TRAINER("multiclass_hd/pre", lambda: jax.tree_util.tree_map(jnp.asarray, tree),
                   recorded, steps, lr)
    model = VJ.port_model("multiclass_hd", tree, torch.float32)
    keys = iter(H.split_keys(1, steps))
    seen = []
    _, hist = PV._trainer("multiclass_hd/pre", model,
                          lambda gen: VJ.port_loss("multiclass_hd", model, next(keys)), steps, lr,
                          on_step=lambda i, m: seen.append(m["loss"].item()))
    assert [r["step"] for r in hist] == [0, steps - 1]
    assert len(ref_losses) == len(seen) == steps
    for t, j in zip(seen, ref_losses):
        assert abs(t - j) <= 1e-4 * abs(j), (seen, ref_losses)


def test_main_writes_exports_that_load_and_serve(tmp_path, monkeypatch):
    monkeypatch.setattr(PV, "FT_MIN_STEPS", 1)
    hd = {"hw": (40, 80), "batch": B, "pre_hw": (40, 80), "pre_batch": B}
    tiny = {"rvm": {"hw": (48, 80), "batch": B, "unroll": 2},
            "u2net": {"hw": (32, 32), "batch": B}, "multiclass": {"hw": (32, 64), "batch": B},
            "multiclass_hd": hd, "multiclass_hd_pico": hd}
    written = PV.main(tmp_path, steps=1, device="cpu", sizes=tiny)
    assert {k: p.name for k, p in written.items()} == {
        "rvm": "rvm.npz", "u2net": "u2net.npz", "multiclass": "mattenet_multiclass.npz",
        "multiclass_hd": "mattenet_hd10_mc.npz", "multiclass_hd_pico": "mattenet_hd10_mc_pico.npz"}
    trees = {k: bridge.load_export(p) for k, p in written.items()}
    RecurrentMatteNet(trees["rvm"], device="cpu").load_tree(trees["rvm"])
    SaliencyNet(trees["u2net"], device="cpu").load_tree(trees["u2net"])
    assert MatteNet(trees["multiclass"], device="cpu").num_classes == 4
    for name, decoder in (("multiclass_hd", "nano"), ("multiclass_hd_pico", "pico")):
        assert MatteNetHD(10, 4, decoder, params=trees[name], device="cpu").num_classes == 4
    eng = Engine(2, preset("multiclass_fast_pico", frame_hw=(80, 160), mask_hw=(8, 16)),
                 params=bridge.params_from_jax(trees["multiclass_hd_pico"], 10, "pico"),
                 device="cpu")
    eng.admit_all()
    out = eng.process(np.zeros((2, 80, 160, 3), np.uint8))
    ca = out["class_alpha"].float()
    assert ca.shape == (2, 8, 16, 4) and float((ca.sum(-1) - 1).abs().max()) <= 1e-3
