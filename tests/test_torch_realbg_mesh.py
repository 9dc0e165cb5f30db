"""``fit(mesh=..., loss_fn=...)`` (train/loop.py, train/step.py::
make_dp_train_step, parallel/mesh.py::data_parallel_forward) on 4 virtual
CPU shards, with the losses the photo-background trainers pass through fit:
losses.make_pipeline_loss and the SaliencyNet's L1 + 0.5 BCE
(train/realbg.py::u2_loss_fn).

- One step over the mesh against the port's one-device step, the same tree
  and batch: the loss within 1e-6 relative and the summed gradients' least
  leaf cosine at least chip_smoke.py's MESH_GRAD_COS = 1 - 1e-7 (they
  differ only by the order of the per-shard sums).
- The pipeline loss over the mesh against the reference's
  ``fit(mesh=..., loss_fn=make_pipeline_loss(model))`` on its 8 CPU devices
  (tests/conftest.py), the half-width MatteNet in f32 at 32x64, batch 8,
  the same tree and the same two batches: the first step's loss and
  gradient at the f32 bars (loss within 1e-5 relative, every leaf's
  gradient cosine at least 0.9999); over the two steps of fit the matting
  part of the loss (what the reference's history records as ``loss``)
  within 1e-4 relative (the update feeds back, fit's bar) and IoU within
  1e-2.
- A loss that calls the model on part of the batch raises ValueError;
  ``loss_fn=None`` keeps the matting loss (tests/test_torch_parallel.py).
- fit warm-starts a SaliencyNet from ``init_params``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests import torch_train_helpers as H
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu import models as jmodels
from video_stream_segmenetation_tpu import parallel as jparallel
from video_stream_segmenetation_tpu.train import losses as JL
from video_stream_segmenetation_tpu.train.loop import fit as j_fit
from video_stream_segmenetation_tpu_torch import parallel
from video_stream_segmenetation_tpu_torch.models.modnet import MatteNet
from video_stream_segmenetation_tpu_torch.models.u2net import SaliencyNet, init_u2net_params
from video_stream_segmenetation_tpu_torch.train import losses as TL
from video_stream_segmenetation_tpu_torch.train import realbg as RB
from video_stream_segmenetation_tpu_torch.train import step as TS
from video_stream_segmenetation_tpu_torch.train.loop import fit, synthetic_matting_batch

CPU = torch.device("cpu")
HW, B, LR = (32, 64), 8, 1e-3


def _cpu_mesh(n=4):
    return parallel.make_mesh(n, devices=[CPU] * n)


@pytest.mark.parametrize("loss", ["pipeline", "u2"])
def test_mesh_step_matches_one_device(loss):
    gap = chip_smoke.dp_grad_gap(_cpu_mesh(), CPU, (40, 40), B, loss=loss)
    assert gap["loss_rel"] <= 1e-6, gap
    assert gap["min_cos"] >= chip_smoke.MESH_GRAD_COS, gap


@pytest.fixture(scope="module")
def tree():
    jm = jmodels.MatteNet(width=0.5, dtype=jnp.float32)
    flax = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)))
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), dict(flax))


def _batches(n=2):
    g = torch.Generator().manual_seed(5)
    return [tuple(x.numpy() for x in synthetic_matting_batch(g, B, HW)) for _ in range(n)]


def test_pipeline_loss_over_the_mesh_matches_the_reference(tree):
    jm = jmodels.MatteNet(width=0.5, dtype=jnp.float32)
    batches = _batches()
    # the first step's loss and gradients: the reference's loss at the tree
    fr, gt = batches[0]
    ref = H.ref_grads(lambda p: JL.make_pipeline_loss(jm)(p, jnp.asarray(fr), jnp.asarray(gt)),
                      tree)
    model = MatteNet(tree, device="cpu", dtype=torch.float32)
    model.requires_grad_(True)
    step = TS.make_dp_train_step(model, TS.make_optimizer(), _cpu_mesh(), B,
                                 loss_fn=TL.make_pipeline_loss(model))
    loss, _, summed = step.grads(torch.as_tensor(fr), torch.as_tensor(gt))
    g_model = MatteNet(tree, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for (k, p) in g_model.named_parameters():
            p.copy_(summed[k])
    got = H.leaves(g_model.tree())
    assert abs(loss.item() - ref[0]) <= 1e-5 * abs(ref[0]), (loss.item(), ref[0])
    assert got.keys() == ref[1].keys()
    for k, w in ref[1].items():
        assert H.cosine(got[k], w) >= 0.9999, (k, H.cosine(got[k], w))

    # two steps of fit on both sides from the same tree and batches
    seed = 2
    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(seed), i + 1) for i in range(2)])
    pick = H.by_key(keys, batches)
    jmesh = jparallel.make_mesh()
    _, jhist = j_fit(jm, hw=HW, batch=B, steps=2, lr=LR, seed=seed, log_every=1, mesh=jmesh,
                     init_params=jax.tree_util.tree_map(jnp.asarray, tree),
                     data_fn=lambda key, b, hw: pick(key), loss_fn=JL.make_pipeline_loss(jm))
    model = MatteNet(tree, device="cpu", dtype=torch.float32)
    it = iter(batches)
    seen = []
    _, hist = fit(model, hw=HW, batch=B, steps=2, lr=LR, seed=seed, log_every=1,
                  mesh=_cpu_mesh(), init_params=tree, loss_fn=TL.make_pipeline_loss(model),
                  data_fn=lambda gen, b, hw: tuple(torch.as_tensor(x) for x in next(it)),
                  on_step=lambda i, m: seen.append({k: float(v) for k, v in m.items()}))
    for m, j, h in zip(seen, jhist, hist):
        # the matting part of the loss, the reference's metrics["loss"]
        base = m["semantic"] + 10.0 * m["detail"] + m["alpha"] + m["composition"]
        assert abs(base - j["loss"]) <= 1e-4 * abs(j["loss"]), (base, j["loss"])
        assert abs(h["iou"] - j["iou"]) <= 1e-2, (h["iou"], j["iou"])
    assert len(seen) == len(jhist) == 2


def test_a_loss_on_part_of_the_batch_is_refused():
    model = SaliencyNet(init_u2net_params(0), device="cpu", dtype=torch.float32)
    fr, gt = (torch.as_tensor(x) for x in _batches(1)[0])

    def half(frames, alpha_gt):
        return RB.u2_loss_fn(model)(frames[: B // 2], alpha_gt[: B // 2])

    step = TS.make_dp_train_step(model, TS.make_optimizer(), _cpu_mesh(), B, loss_fn=half)
    with pytest.raises(ValueError, match="4 rows of a step made for a batch of 8"):
        step.grads(fr, gt)
    # the model's own forward is back after the failed step
    assert "forward" not in vars(model)
    assert model(fr[:2])["alpha"].shape == (2, *HW)


def test_fit_warm_starts_a_saliency_net():
    """fit loads ``init_params`` into a SaliencyNet (and, without them, its
    seeded tree), and trains it over the mesh with the U2 loss."""
    warm = init_u2net_params(3)
    model = SaliencyNet(init_u2net_params(0), device="cpu", dtype=torch.float32)
    seen = []
    fit(model, hw=HW, batch=B, steps=1, lr=0.0, init_params=warm, loss_fn=RB.u2_loss_fn(model),
        mesh=_cpu_mesh(2), on_step=lambda i, m: seen.append(m))
    for k, v in H.leaves(model.tree()).items():
        w = H.leaves(warm)[k]
        # lr 0: AdamW's update is -lr * (...), the tree is the warm start
        np.testing.assert_array_equal(v, w, err_msg=k)
    assert np.isfinite(float(seen[0]["loss"]))
    seeded = SaliencyNet(warm, device="cpu", dtype=torch.float32)
    tree, _ = fit(seeded, hw=HW, batch=2, steps=1, lr=0.0, seed=0,
                  loss_fn=RB.u2_loss_fn(seeded))
    for k, v in H.leaves(init_u2net_params(0)).items():
        np.testing.assert_array_equal(H.leaves(tree)[k], v, err_msg=k)
