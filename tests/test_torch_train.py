"""The port's training path (models/mattenet_hd.py::MatteNetHD, train/)
against the JAX package's, at a small geometry: frames 80x160, batch 2,
the pico widths, seeded trees, inputs made with numpy.

- Forward: f32 within 1e-5 (the same operations; only the order of the
  convolutions' sums differs), bf16 within 2e-3 on the [0, 1] outputs
  (the seeded MatteNet's bar in tests/test_torch_active.py, the detail
  logits through their sigmoid: the two frameworks round their bf16
  convolutions' sums at other places).
- Gradients of ``matting_loss`` and ``make_pipeline_loss``, every leaf and
  the BatchNorm statistics included: f32 within 1e-4 relative L2 (sums in
  another order, through a whole backward pass); bf16 by a cosine of at
  least 0.99 per leaf (bf16 roundings differ leaf by leaf, the direction
  holds).
- The optimizer within 1e-6 relative of optax over three updates (f32
  arithmetic in optax's order; only ``b ** count`` may round differently).
- ``fit`` in f32 from the same tree and batches, one step a call and
  chunked: losses within 1e-4 relative over three steps (the updates feed
  back into the next loss), IoU within 1e-2.
- The synthetic batch rendered from the reference's own draws within 1e-6
  (the same arithmetic; sqrt and division may round differently).
"""

import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu import models
from video_stream_segmenetation_tpu import train as jtrain
from video_stream_segmenetation_tpu.train import losses as JL
from video_stream_segmenetation_tpu.train.loop import synthetic_matting_batch as j_batch
from video_stream_segmenetation_tpu_torch.models.backbones import _Layer
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import (
    PLAN_D,
    MatteNetHD,
    init_params,
)
from video_stream_segmenetation_tpu_torch.runtime.presets import preset
from video_stream_segmenetation_tpu_torch.service.engine import Engine
from video_stream_segmenetation_tpu_torch.train import losses as TL
from video_stream_segmenetation_tpu_torch.train import step as TS
from video_stream_segmenetation_tpu_torch.train.loop import fit, render_matting_batch

HW = (80, 160)
B = 2
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _jax_model(decoder="pico", dtype=jnp.float32):
    return models.MatteNetHD(stem_stride=10, head_upsample=4, decoder=decoder, dtype=dtype)


def _tree(decoder="pico", seed=3):
    """A seeded tree with BatchNorm statistics and biases away from their
    initial values, so that every leaf's gradient path is exercised."""
    tree = init_params(decoder, seed)
    g = np.random.default_rng(seed + 100)

    def perturb(node):
        for k, v in node.items():
            if isinstance(v, dict):
                perturb(v)
            elif k == "var":
                node[k] = (v * g.uniform(0.5, 2.0, v.shape)).astype(np.float32)
            elif k in ("mean", "bias"):
                node[k] = (v + g.normal(0, 0.1, v.shape)).astype(np.float32)
            elif k == "scale":
                node[k] = (v * g.uniform(0.7, 1.3, v.shape)).astype(np.float32)

    perturb(tree)
    return tree


def _batch(seed=0):
    g = np.random.default_rng(seed)
    frames = g.random((B, *HW, 3), dtype=np.float32)
    yy, xx = np.mgrid[0:HW[0], 0:HW[1]]
    d = np.sqrt(((xx - 80) / 40.0) ** 2 + ((yy - 45) / 30.0) ** 2)
    alpha = np.clip((1.05 - d[None]) / np.asarray([0.1, 0.2])[:, None, None], 0, 1)
    frames = frames * 0.4 + alpha[..., None].astype(np.float32) * 0.5
    return frames.astype(np.float32), alpha.astype(np.float32)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _grad_tree(model: MatteNetHD, grads) -> dict:
    """Gradients in the module's parameter order -> a flax-named tree."""
    g_model = copy.deepcopy(model)
    with torch.no_grad():
        for p, g in zip(g_model.parameters(), grads):
            p.copy_(g)
    return g_model.tree()


# ---- forward --------------------------------------------------------------


@pytest.mark.parametrize("decoder", PLAN_D)
def test_forward_f32_matches_reference(decoder):
    tree = _tree(decoder)
    frames, _ = _batch()
    want = jax.jit(_jax_model(decoder).apply)(tree, jnp.asarray(frames))
    got = MatteNetHD(decoder=decoder, dtype=torch.float32, params=tree,
                     device="cpu")(torch.as_tensor(frames))
    assert set(got) == {"alpha", "semantic", "detail"}
    for k in got:
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == want[k].shape
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_forward_bf16_matches_reference():
    """The seeded MatteNet's bar is on its sigmoid alpha; the detail
    logits are held through the sigmoid the loss applies to them, so that
    all three outputs are on that [0, 1] scale (a bf16 logit differs by
    whole bf16 steps of its magnitude)."""
    tree = _tree()
    frames, _ = _batch()
    want = _jax_model(dtype=jnp.bfloat16).apply(tree, jnp.asarray(frames))
    got = MatteNetHD(decoder="pico", params=tree, device="cpu")(torch.as_tensor(frames))
    got["detail"] = torch.sigmoid(got["detail"])
    want = dict(want, detail=jax.nn.sigmoid(want["detail"]))
    for k in got:
        assert np.abs(got[k].detach().numpy() - np.asarray(want[k])).max() <= 2e-3, k


def test_uint8_input_and_tree_roundtrip():
    """u8 frames are scaled by 1/255 in the compute dtype as the
    reference's are; tree() gives back the loaded tree exactly."""
    tree = _tree("micro")
    frames = np.random.default_rng(1).integers(0, 256, (B, *HW, 3), dtype=np.uint8)
    want = jax.jit(_jax_model("micro").apply)(tree, jnp.asarray(frames))["alpha"]
    m = MatteNetHD(decoder="micro", dtype=torch.float32, params=tree, device="cpu")
    got = m(torch.as_tensor(frames))["alpha"]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    back = _leaves(m.tree())
    assert back.keys() == _leaves(tree).keys()
    for k, v in _leaves(tree).items():
        np.testing.assert_array_equal(back[k], v)


def test_training_leaves_the_callers_tree_alone():
    """A model built from a numpy tree on the CPU holds copies: a train step
    changes its parameters and not the tree."""
    tree = _tree()
    before = _leaves(tree)
    m = MatteNetHD(decoder="pico", dtype=torch.float32, params=tree, device="cpu")
    tx = TS.make_optimizer(5e-4)
    state, _ = TS.init_train_state(m, tx)
    TS.make_train_step(m, tx)(state, *map(torch.as_tensor, _batch()))
    after, trained = _leaves(tree), _leaves(m.tree())
    assert all(np.array_equal(before[k], after[k]) for k in before)
    assert sum(not np.array_equal(before[k], trained[k]) for k in before) == len(before)


def test_femto_tree_matches_flax_init():
    """femto (plan G, c2 = c3 = 128): the seeded tree has flax's names and
    shapes, and the float model runs it."""
    flax_tree = jax.eval_shape(_jax_model("femto").init, jax.random.PRNGKey(0),
                               jnp.zeros((1, *HW, 3)))
    shapes = lambda t: jax.tree_util.tree_map(np.shape, dict(t))  # noqa: E731
    assert shapes(flax_tree) == shapes(init_params("femto", 0))
    out = MatteNetHD(decoder="femto", device="cpu")(torch.zeros((1, *HW, 3)))
    assert out["alpha"].shape == (1, 32, 64)


# ---- gradients ------------------------------------------------------------


def _jax_loss(kind, jm):
    if kind == "matting":
        return lambda p, fr, gt: JL.matting_loss(jm.apply(p, fr), gt, fr)
    return JL.make_pipeline_loss(jm)


def _torch_loss(kind, m):
    if kind == "matting":
        return lambda fr, gt: TL.matting_loss(m(fr), gt, fr)
    return TL.make_pipeline_loss(m)


@pytest.fixture(scope="module")
def grads():
    """Both sides' (loss, metrics, gradient leaves) for each loss and dtype."""
    tree = _tree()
    frames, gt = _batch()
    out = {}
    for kind in ("matting", "pipeline"):
        for name, (jdt, tdt) in DTYPES.items():
            f = jax.jit(jax.value_and_grad(_jax_loss(kind, _jax_model(dtype=jdt)), has_aux=True))
            (jl, jmet), jg = f(tree, jnp.asarray(frames), jnp.asarray(gt))
            m = MatteNetHD(decoder="pico", dtype=tdt, params=tree, device="cpu")
            tl, tmet = _torch_loss(kind, m)(torch.as_tensor(frames), torch.as_tensor(gt))
            tg = torch.autograd.grad(tl, list(m.parameters()))
            out[kind, name] = (float(jl), {k: float(v) for k, v in jmet.items()}, _leaves(jg),
                               tl.item(), {k: v.item() for k, v in tmet.items()},
                               _leaves(_grad_tree(m, tg)))
    return out


def test_reference_differentiates_batch_stats(grads):
    """The reference trains its BatchNorm statistics: nonzero gradients for
    every mean and var leaf (so the port must train them too)."""
    jg = grads["matting", "f32"][2]
    stats = {k: v for k, v in jg.items() if k.startswith("['batch_stats']")}
    assert len(stats) == 2 * 8  # mean and var of the pico plan's eight ConvBNs
    for k, v in stats.items():
        assert np.abs(v).sum() > 0, k


@pytest.mark.parametrize("kind", ["matting", "pipeline"])
def test_gradients_f32_match_reference(grads, kind):
    jl, jmet, jg, tl, tmet, tg = grads[kind, "f32"]
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    for k in jmet:
        assert abs(tmet[k] - jmet[k]) <= 1e-5 * abs(jmet[k]) + 1e-7, k
    assert tg.keys() == jg.keys()
    for k, w in jg.items():
        rel = np.linalg.norm(tg[k] - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= 1e-4, (k, rel)


@pytest.mark.parametrize("kind", ["matting", "pipeline"])
def test_gradients_bf16_match_reference(grads, kind):
    jl, _, jg, tl, _, tg = grads[kind, "bf16"]
    assert abs(tl - jl) <= 1e-2 * abs(jl)
    for k, w in jg.items():
        g = tg[k]
        cos = float(np.dot(g.ravel(), w.ravel())
                    / max(np.linalg.norm(g) * np.linalg.norm(w), 1e-30))
        assert cos >= 0.99, (k, cos)


# ---- optimizer ------------------------------------------------------------


def test_optimizer_matches_optax():
    """Three updates on the same gradients, the clip both idle (norm < 1)
    and acting (norm > 1)."""
    g = np.random.default_rng(7)
    params = {"a": g.normal(0, 0.5, (64, 32)).astype(np.float32),
              "b": g.normal(0, 0.1, (32,)).astype(np.float32)}
    grad_steps = [{k: (g.normal(0, 1, v.shape) * s).astype(np.float32) for k, v in params.items()}
                  for s in (0.01, 0.5, 0.02)]
    tx_j = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(5e-4, weight_decay=1e-5))
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    sj = tx_j.init(pj)
    tx_t = TS.make_optimizer(5e-4)
    pt = {k: torch.as_tensor(v.copy()) for k, v in params.items()}
    st = tx_t.init(pt)
    for gs in grad_steps:
        assert (float(optax.global_norm(gs)) > 1.0) == (gs is grad_steps[1])
        uj, sj = tx_j.update(jax.tree_util.tree_map(jnp.asarray, gs), sj, pj)
        pj = optax.apply_updates(pj, uj)
        ut, st = tx_t.update({k: torch.as_tensor(v) for k, v in gs.items()}, st, pt)
        TS.apply_updates(pt, ut)
        for k in params:
            for got, want in ((ut[k], uj[k]), (pt[k], pj[k])):
                want = np.asarray(want)
                err = np.abs(got.numpy() - want).max() / np.abs(want).max()
                assert err <= 1e-6, (k, err)


# ---- fit and the synthetic batch ------------------------------------------


def _fit_folds(steps: int, steps_per_call: int) -> list[int]:
    """The numbers the reference's ``fit`` folds into its key, in the order
    of its ``data_fn`` calls: ``i + 1`` for step ``i``; chunked, after each
    chunk ending at ``i`` steps, ``steps + i + 1`` for the logging batch."""
    if steps_per_call == 1:
        return [i + 1 for i in range(steps)]
    folds, i = [], 0
    while i < steps:
        k = min(steps_per_call, steps - i)
        folds += [i + j + 1 for j in range(k)]
        i += k
        folds.append(steps + i + 1)
    return folds


@pytest.mark.parametrize("steps_per_call", [1, 2])
def test_fit_f32_losses_match_reference(steps_per_call):
    """Both loops from the same tree, fed the same numpy batches in the
    reference's order of ``data_fn`` calls (chunked: 2 steps, the logging
    batch, 1 step, the logging batch): the same history steps, losses
    within 1e-4 relative, IoU within 1e-2 (a 0.5 threshold on 2048 pixels
    a frame, where knife-edge pixels may fall either way)."""
    steps = 3
    tree = _tree()
    folds = _fit_folds(steps, steps_per_call)
    batches = [_batch(seed) for seed in range(len(folds))]
    # the reference's data_fn runs traced inside its chunk's loop: it finds
    # its batch by comparing its key with the keys it will be given
    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(0), f) for f in folds])
    stacked = [jnp.stack([b[i] for b in batches]) for i in range(2)]
    assert (jnp.all(keys[:, None] == keys[None], axis=-1) == jnp.eye(len(folds))).all()

    def jax_data(key, batch, hw):
        i = jnp.argmax(jnp.all(keys == key, axis=-1))
        return stacked[0][i], stacked[1][i]

    _, jhist = jtrain.fit(_jax_model(), hw=HW, batch=B, steps=steps, lr=5e-4, log_every=1,
                          data_fn=jax_data, steps_per_call=steps_per_call,
                          init_params=jax.tree_util.tree_map(jnp.asarray, tree))
    it = iter(batches)
    m = MatteNetHD(decoder="pico", dtype=torch.float32, device="cpu")
    seen = []
    params, thist = fit(m, hw=HW, batch=B, steps=steps, lr=5e-4, log_every=1,
                        data_fn=lambda gen, batch, hw: tuple(map(torch.as_tensor, next(it))),
                        init_params=tree, steps_per_call=steps_per_call,
                        on_step=lambda i, met: seen.append((i, float(met["grad_norm"]))))
    assert next(it, None) is None  # every batch taken, in the reference's order
    want_steps = [0, 1, 2] if steps_per_call == 1 else [1, 2]
    assert [r["step"] for r in thist] == [r["step"] for r in jhist] == want_steps
    for t, j in zip(thist, jhist):
        assert abs(t["loss"] - j["loss"]) <= 1e-4 * abs(j["loss"]), (t, j)
        assert abs(t["iou"] - j["iou"]) <= 1e-2, (t, j)
    assert [i for i, _ in seen] == [0, 1, 2] and all(np.isfinite(n) for _, n in seen)
    assert _leaves(params).keys() == _leaves(tree).keys()


def test_synthetic_batch_renders_reference_draws():
    key = jax.random.PRNGKey(4)
    h, w = HW
    ks = jax.random.split(key, 12)

    def u(k, shape, lo=0.0, hi=1.0):
        return jax.random.uniform(k, shape, minval=lo, maxval=hi)

    b1, b3, img = (B, 1, 1), (B, 1, 1, 3), (B, h, w, 3)
    draws = {"cx": u(ks[0], b1, 0.25 * w, 0.75 * w), "cy": u(ks[1], b1, 0.45 * h, 0.85 * h),
             "rx": u(ks[2], b1, 0.12 * w, 0.28 * w), "ry": u(ks[3], b1, 0.28 * h, 0.5 * h),
             "edge": u(ks[4], b1, 0.05, 0.2), "head_dy": u(ks[5], b1, 0.9, 1.2),
             "head_r": u(ks[6], b1, 0.35, 0.55), "fg_color": u(ks[7], b3, 0.25, 0.9),
             "fg_tex": u(ks[8], img, -0.15, 0.15), "bg_base": u(ks[9], b3, 0.0, 0.5),
             "bg_tex": u(ks[10], img), "bg_gain": u(ks[10], (B, 1, 1, 1), 0.1, 0.4),
             "noise": jax.random.normal(ks[11], img)}
    draws = {k: np.asarray(v) for k, v in draws.items()}
    want_f, want_a = jax.jit(j_batch, static_argnums=(1, 2))(key, B, HW)
    got_f, got_a = render_matting_batch({k: torch.tensor(v) for k, v in draws.items()}, HW)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=0, atol=1e-6)


def test_flagship_writes_exports(tmp_path, monkeypatch):
    """The flagship trainer's jobs at a small geometry: each decoder's tree lands as
    an export that loads back into the model, and the quality record is
    merged into the given path."""
    from video_stream_segmenetation_tpu_torch import bridge
    from video_stream_segmenetation_tpu_torch.train import flagship

    monkeypatch.setattr(flagship, "JOBS", {
        k: dataclasses.replace(j, pretrain_hw=HW, pretrain_batch=B, serve_hw=HW, serve_batch=B)
        for k, j in flagship.JOBS.items()})
    monkeypatch.setattr(flagship, "FT_MIN_STEPS", 1)
    qpath = tmp_path / "q.json"
    qpath.write_text('{"other": {}}')
    quality = flagship.main(tmp_path, steps=2, only={"pico", "femto"}, quality_path=qpath,
                            device="cpu")
    assert set(quality) == {"mattenet_hd10_pico", "mattenet_hd10_femto"}
    assert set(json.loads(qpath.read_text())) == set(quality) | {"other"}
    tree = bridge.load_export(tmp_path / "mattenet_hd10_femto.npz")
    MatteNetHD(decoder="femto", device="cpu").load_tree(tree)


def test_fit_refuses_a_mesh():
    """fit(mesh=...) trains data-parallel (tests/test_torch_parallel.py,
    with a loss_fn tests/test_torch_realbg_mesh.py); it refuses a mesh the
    batch does not divide over, and a loss_fn that calls the model on part
    of the batch."""
    from video_stream_segmenetation_tpu_torch.parallel import make_mesh

    mesh = make_mesh(2, devices=[torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="divide"):
        fit(MatteNetHD(device="cpu"), hw=HW, batch=3, steps=1, mesh=mesh)
    model = MatteNetHD(device="cpu")
    with pytest.raises(ValueError, match="rows of a step made for a batch of"):
        fit(model, hw=HW, batch=B, steps=1, mesh=mesh,
            loss_fn=lambda frames, alpha_gt: TL.matting_loss(model(frames[:1]), alpha_gt[:1],
                                                             frames[:1]))


# ---- serving untouched ----------------------------------------------------


@pytest.mark.parametrize("name", ["fast_int8_pico", "active"])
def test_engine_models_are_frozen(name):
    """No parameter of a model the Engine builds requires a gradient, so
    that no serving step records an autograd graph, and no step derives
    its layers' compute-dtype tensors again."""
    eng = Engine(2, preset(name, frame_hw=(80, 160), mask_hw=(32, 64), fd_size=64,
                           lmk_size=48), device="cpu")
    mods = [eng.model, eng.face_models.face, eng.face_models.lmk]
    params = [p for m in mods for p in m.parameters()]
    assert params and not any(p.requires_grad for p in params)
    # and each layer's compute-dtype tensors derived once, when frozen
    layers = [la for m in mods for la in m.modules() if isinstance(la, _Layer)]
    assert layers and all(la._frozen is not None for la in layers)
    eng.admit_all()
    out = eng.process(np.zeros((2, 80, 160, 3), np.uint8))
    assert not out["alpha"].requires_grad
