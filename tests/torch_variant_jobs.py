"""The variant trainers' jobs on both sides for the parity tests
(tests/test_torch_variant_train*.py): the port's train/variants.py against
the reference's tools/train_variants.py at a small geometry, batch 2 (the
RecurrentMatteNet at 48x80 unrolled over 2 frames, the SaliencyNet at
64x64, the K=4 MatteNet at 96x160, the K=4 MatteNetHD (pico) at 80x160).

The reference's own loss closures are taken from its trainers (its
``_trainer`` replaced by one that hands them over), with its init trees;
the port's loss gets the batch (and the RVM's roll) the reference's
closure draws from the same key.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from tests import torch_train_helpers as H
from video_stream_segmenetation_tpu import models as jm
from video_stream_segmenetation_tpu.train.face import synthetic_face_batch as j_face_batch
from video_stream_segmenetation_tpu.train.loop import synthetic_matting_batch as j_batch
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import MatteNetHD
from video_stream_segmenetation_tpu_torch.models.modnet import MatteNet
from video_stream_segmenetation_tpu_torch.models.rvm import RecurrentMatteNet
from video_stream_segmenetation_tpu_torch.models.u2net import SaliencyNet
from video_stream_segmenetation_tpu_torch.train import variants as PV

import train_variants as TV  # noqa: E402  (tools/, on the path torch_train_helpers sets)

B = 2
T = torch.as_tensor
GEOM = {"rvm": {"hw": (48, 80), "batch": B, "unroll": 2}, "u2": {"hw": (64, 64), "batch": B},
        "multiclass": {"hw": (96, 160), "batch": B},
        "multiclass_hd": {"hw": (80, 160), "batch": B, "pre_hw": (80, 160), "pre_batch": B,
                          "decoder": "pico"}}
REF_TRAIN = {"rvm": TV.train_rvm, "u2": TV.train_u2, "multiclass": TV.train_multiclass,
             "multiclass_hd": TV.train_multiclass_hd}
MODELS = {"rvm": "RecurrentMatteNet", "u2": "SaliencyNet", "multiclass": "MatteNet",
          "multiclass_hd": "MatteNetHD"}
REF_TRAINER = TV._trainer  # the reference's own loop (the jobs below replace it)


def reference_job(monkeypatch, name: str, jdt, tree=None) -> tuple:
    """(init tree, loss_fn(params, key)) of the reference's trainer ``name``
    at the test geometry, its model in ``jdt``; for the K-class MatteNetHD
    the pretraining phase's.  The init (jitted) is skipped where ``tree``
    is given: the model's dtype does not change it."""
    cls = getattr(jm, MODELS[name])
    monkeypatch.setattr(TV.models, MODELS[name], functools.partial(cls, dtype=jdt))
    taken = []
    monkeypatch.setattr(TV, "_trainer", lambda _n, init_fn, loss_fn, *a: taken.append(
        (init_fn, loss_fn)))
    REF_TRAIN[name](1, **GEOM[name])
    init_fn, loss_fn = taken[0]
    return (H.np_tree(jax.jit(init_fn)()) if tree is None else tree), loss_fn


def port_model(name: str, tree, tdt):
    if name == "rvm":
        return RecurrentMatteNet(tree, device="cpu", dtype=tdt)
    if name == "u2":
        return SaliencyNet(tree, device="cpu", dtype=tdt)
    if name == "multiclass":
        return MatteNet(tree, device="cpu", dtype=tdt)
    return MatteNetHD(10, 4, "pico", dtype=tdt, params=tree, device="cpu")


def port_loss(name: str, model, key):
    """The port's loss on the batch the reference's closure draws from
    ``key``."""
    g = GEOM[name]
    hw = g.get("pre_hw", g["hw"])
    if name in ("rvm", "u2"):
        frames, gt = (T(np.array(v)) for v in j_batch(key, B, hw))
        if name == "u2":
            return PV.u2_loss(model, frames, gt)
        shift = T(np.array(jax.random.randint(key, (), -12, 13)))
        return PV.rvm_loss(model, frames, gt, shift, g["unroll"])
    frames, _, _, parts = j_face_batch(key, B, hw, return_parts=True)
    parts = {k: T(np.array(v)) for k, v in parts.items()}
    return PV.class_loss(model(T(np.array(frames)))["alpha"], PV._class_simplex(parts))


def grads_of(names) -> dict:
    """Both sides' (loss, gradient leaves) for each trainer of ``names``
    and dtype, and ``(name, "stats")``: the tree's BatchNorm statistic
    leaves (mean and var of every ConvBN)."""
    key = jax.random.PRNGKey(9)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in names:
            tree = None
            for dtype, (jdt, tdt) in H.DTYPES.items():
                tree, loss_fn = reference_job(mp, name, jdt, tree)
                ref = H.ref_grads(lambda p: loss_fn(p, key), tree)
                model = port_model(name, tree, tdt)
                out[name, dtype] = ref, H.port_grads(model, lambda: port_loss(name, model, key))
            out[name, "stats"] = sum(k.startswith("['batch_stats']") for k in H.leaves(tree))
    return out


def check_grads(grads: dict, name: str, dtype: str) -> None:
    ref, got = grads[name, dtype]
    assert grads[name, "stats"] > 0
    H.assert_grads_close(ref, got, dtype, stats=grads[name, "stats"],
                         ref_f32=grads[name, "f32"][0])
