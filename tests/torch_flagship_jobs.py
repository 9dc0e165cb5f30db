"""The flagship jobs on both sides for the parity tests
(tests/test_torch_flagship_plans*.py): the port's train/flagship.py and
train/loop.py::fit against the reference's tools/train_flagship.py and
train/loop.py::fit, for plans A ('mattenet_hd', stem stride 5), B
('mattenet_hd10'), C ('mattenet_hd10_lite') at 80x160 and the MatteNet at
96x160, batch 2, from the reference's init trees.

- One step's matting loss and gradient, BatchNorm statistics included, at
  the bars of tests/torch_train_helpers.py.
- Three steps of each side's ``fit`` in f32 at the job's learning rate, fed
  the same numpy batches in the reference's order of ``data_fn`` calls:
  losses within 1e-4 relative (the updates feed back into the next loss),
  the same history steps.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests import torch_train_helpers as H
from video_stream_segmenetation_tpu import models as jm
from video_stream_segmenetation_tpu import train as jtrain
from video_stream_segmenetation_tpu.train import losses as JL
from video_stream_segmenetation_tpu.train.loop import synthetic_matting_batch as j_batch
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import MatteNetHD
from video_stream_segmenetation_tpu_torch.models.modnet import MatteNet
from video_stream_segmenetation_tpu_torch.train import flagship as FL
from video_stream_segmenetation_tpu_torch.train import losses as TL
from video_stream_segmenetation_tpu_torch.train.loop import fit

B = 2
T = torch.as_tensor
HW = {"plan_a": (80, 160), "full": (80, 160), "light": (80, 160), "mattenet": (96, 160)}


def ref_model(key: str, jdt=jnp.float32):
    """The reference's model of the job (as tools/train_flagship.py builds
    it), in ``jdt``."""
    job = FL.JOBS[key]
    if job.arch == "mattenet":
        return jm.MatteNet(dtype=jdt)
    return jm.MatteNetHD(stem_stride=job.stem_stride, head_upsample=job.head_upsample,
                         decoder=job.decoder, dtype=jdt)


def init_tree(key: str) -> dict:
    """The reference's init: ``model.init(PRNGKey(0), zeros)``, jitted."""
    model = ref_model(key)
    zeros = jnp.zeros((1, *HW[key], 3))
    return H.np_tree(jax.jit(lambda: model.init(jax.random.PRNGKey(0), zeros))())


def port_model(key: str, tree, tdt=torch.float32):
    job = FL.JOBS[key]
    if job.arch == "mattenet":
        return MatteNet(tree, device="cpu", dtype=tdt)
    return MatteNetHD(job.stem_stride, job.head_upsample, job.decoder, dtype=tdt, params=tree,
                      device="cpu")


def batch(key: str, seed: int) -> tuple:
    """A synthetic batch (numpy) from the reference's generator."""
    return tuple(np.array(v) for v in jax.jit(j_batch, static_argnums=(1, 2))(
        jax.random.PRNGKey(seed), B, HW[key]))


def grads_of(keys) -> dict:
    """Both sides' (loss, gradient leaves) of the matting loss for each job
    and dtype, and ``(key, "stats")``: the tree's BatchNorm statistic
    leaves."""
    out = {}
    for key in keys:
        tree = init_tree(key)
        frames, gt = batch(key, 13)
        for dtype, (jdt, tdt) in H.DTYPES.items():
            jmod = ref_model(key, jdt)
            ref = H.ref_grads(lambda p: JL.matting_loss(
                jmod.apply(p, jnp.asarray(frames)), jnp.asarray(gt), jnp.asarray(frames)), tree)
            model = port_model(key, tree, tdt)
            got = H.port_grads(model, lambda: TL.matting_loss(model(T(frames)), T(gt),
                                                              T(frames)))
            out[key, dtype] = ref, got
        out[key, "stats"] = sum(k.startswith("['batch_stats']") for k in H.leaves(tree))
    return out


def check_grads(grads: dict, key: str, dtype: str) -> None:
    ref, got = grads[key, dtype]
    assert grads[key, "stats"] > 0
    H.assert_grads_close(ref, got, dtype, stats=grads[key, "stats"],
                         ref_f32=grads[key, "f32"][0])


def check_fit(monkeypatch, key: str, steps: int = 3) -> None:
    """Both ``fit`` loops from the reference's init tree, one step a call,
    fed the same batches (the reference's ``data_fn`` finds its batch by
    the key ``fold_in(PRNGKey(0), i + 1)`` of step ``i``)."""
    job = FL.JOBS[key]
    tree = init_tree(key)
    batches = [batch(key, 50 + i) for i in range(steps)]
    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(0), i + 1) for i in range(steps)])
    pick = H.by_key(keys, batches)
    # the reference's fit inits the model before it takes init_params; that
    # init is discarded, so it is skipped here
    monkeypatch.setattr(jtrain, "init_train_state", lambda model, rng, sample, tx: (
        jtrain.TrainState(params=tree, opt_state=tx.init(tree), step=jnp.zeros((), jnp.int32)),
        tx))
    _, jhist = jtrain.fit(ref_model(key), hw=HW[key], batch=B, steps=steps, lr=job.lr,
                          log_every=1, data_fn=lambda k, b, hw: pick(k),
                          init_params=jax.tree_util.tree_map(jnp.asarray, tree))
    it = iter(batches)
    _, thist = fit(port_model(key, tree), hw=HW[key], batch=B, steps=steps, lr=job.lr,
                   log_every=1, init_params=tree,
                   data_fn=lambda gen, b, hw: tuple(map(T, next(it))))
    assert next(it, None) is None
    assert [r["step"] for r in thist] == [r["step"] for r in jhist] == list(range(steps))
    for t, j in zip(thist, jhist):
        assert abs(t["loss"] - j["loss"]) <= 1e-4 * abs(j["loss"]), (thist, jhist)
