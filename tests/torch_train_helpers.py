"""Shared pieces of the trainers' parity tests (the port's train/ against the
reference's train/ and tools/ trainers): trees as flat leaves, a port
model's gradients as a flax-named tree, the gradient bars, and the
reference's jitted trainers fed the port's numpy batches.

Bars (the ones tests/test_torch_train.py sets for the MatteNetHD): f32 loss
within 1e-5 relative and each leaf's gradient within 1e-4 relative L2 (sums
in another order through a whole backward pass); bf16 loss within 1e-2
relative and each leaf's gradient cosine at least 0.99 (bf16 roundings
differ leaf by leaf, the direction holds), or, for a leaf whose bf16
gradient in the reference itself lies farther from its f32 gradient, the
bar that gap implies (:func:`assert_grads_close`).
"""

from __future__ import annotations

import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def leaves(tree) -> dict:
    """A nested tree -> ``{path: f32 numpy leaf}``."""
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def np_tree(tree):
    return jax.tree_util.tree_map(lambda v: np.asarray(v, np.float32), tree)


def port_grads(model: torch.nn.Module, loss_fn) -> tuple[float, dict]:
    """``(loss, gradient leaves by flax path)`` of ``loss_fn()`` with respect
    to every parameter of the port's ``model`` (made trainable)."""
    model.requires_grad_(True)
    params = list(model.parameters())
    loss, _ = loss_fn()
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    g_model = copy.deepcopy(model)
    with torch.no_grad():
        for p, g in zip(g_model.parameters(), grads):
            p.copy_(torch.zeros_like(p) if g is None else g)  # unread: zero, as jax.grad
    return loss.item(), leaves(g_model.tree())


def ref_grads(loss_fn, tree) -> tuple[float, dict]:
    """``(loss, gradient leaves)`` of the reference's ``loss_fn(params) ->
    (loss, aux)`` at ``tree``."""
    (loss, _), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    return float(loss), leaves(g)


def cosine(a: np.ndarray, b: np.ndarray) -> float:
    """The cosine of two leaves; 1 where both are zero."""
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 and nb == 0:
        return 1.0
    return float(np.dot(a.ravel(), b.ravel()) / max(na * nb, 1e-30))


def assert_grads_close(ref: tuple, got: tuple, dtype: str, stats: int | None = None,
                       ref_f32: tuple | None = None) -> None:
    """The bars above; ``stats``: the number of BatchNorm statistic leaves
    that must be among the compared gradients (mean and var: they train).
    bf16 with ``ref_f32`` (the reference's f32 gradients): where the
    reference's own bf16 gradient of a leaf lies farther from its f32
    gradient than a cosine of 0.995, two bf16 evaluations differ by about
    twice that gap (independent roundings), so the leaf's bar is ``1 - 2 (1
    - cos(reference bf16, reference f32))`` when that is below 0.99."""
    jl, jg = ref
    tl, tg = got
    assert tg.keys() == jg.keys()
    if stats is not None:
        assert sum(k.startswith("['batch_stats']") for k in jg) == stats
    if dtype == "f32":
        assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
        for k, w in jg.items():
            rel = np.linalg.norm(tg[k] - w) / max(np.linalg.norm(w), 1e-30)
            assert rel <= 1e-4, (k, rel)
        return
    assert abs(tl - jl) <= 1e-2 * abs(jl), (tl, jl)
    for k, w in jg.items():
        bar = 0.99
        if ref_f32 is not None:
            bar = min(bar, 1.0 - 2.0 * (1.0 - cosine(w, ref_f32[1][k])))
        cos = cosine(tg[k], w)
        assert cos >= bar, (k, cos, bar)


def split_keys(seed: int, steps: int) -> jnp.ndarray:
    """The keys the reference's trainers hand their loss at each step:
    ``rng, k = split(rng)`` from ``PRNGKey(seed)``."""
    rng, out = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        rng, k = jax.random.split(rng)
        out.append(k)
    return jnp.stack(out)


def by_key(keys: jnp.ndarray, batches: list):
    """``pick(key) -> the batch of that key``, traceable (the reference's
    loss runs inside its jitted step or chunk loop): each batch is a tuple
    of numpy arrays, stacked along a new leading axis."""
    stacked = [jnp.stack([b[i] for b in batches]) for i in range(len(batches[0]))]
    assert (jnp.all(keys[:, None] == keys[None], axis=-1) == jnp.eye(len(keys))).all()

    def pick(key):
        i = jnp.argmax(jnp.all(keys == key, axis=-1))
        return tuple(s[i] for s in stacked)

    return pick


def recorder():
    """``(record(loss), losses)``: an ordered host callback that collects
    the reference's per-step losses from inside its jitted loop."""
    seen = []

    def record(loss):
        jax.debug.callback(lambda v: seen.append(float(v)), loss, ordered=True)

    return record, seen


def ref_occluder_draws(key, batch: int, hw) -> dict:
    """The draws the reference's sample_occluder(key, batch, hw) makes, by
    the port's names."""
    h, w = hw
    ks = jax.random.split(key, 9)

    def u(k, lo, hi, shape=(batch, 1, 1)):
        return jax.random.uniform(k, shape, minval=lo, maxval=hi)

    return {"present_u": u(ks[0], 0.0, 1.0), "kind_u": u(ks[1], 0.0, 1.0),
            "y0": u(ks[2], 0.80 * h, 0.97 * h), "slope": u(ks[3], -0.06, 0.06),
            "bx": u(ks[4], 0.2 * w, 0.8 * w), "by": u(ks[5], 0.62 * h, 0.95 * h),
            "brx": u(ks[6], 0.04 * w, 0.13 * w), "bry": u(ks[7], 0.05 * h, 0.16 * h),
            "base": u(ks[8], 0.05, 0.9, (batch, 1, 1, 3)),
            "tex_phase": u(jax.random.fold_in(ks[8], 1), 0.0, 6.283, (batch, 1, 1, 1))}
