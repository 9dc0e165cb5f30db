"""The training step for the matting nets (port of ``train/step.py``).

The optimizer is optax's ``chain(clip_by_global_norm(1.0), adamw(lr,
weight_decay))`` written out step for step, so that it gives optax's numbers:
the gradients scaled by ``1 / norm`` where their global norm is at least 1
(no epsilon on the norm, unlike ``torch.nn.utils.clip_grad_norm_``), Adam's
bias-corrected moments, then ``-lr * (m_hat / (sqrt(v_hat) + eps) + wd *
p)``, weight decay on every leaf.  The leaves are every parameter of the
module, the BatchNorm's ``mean`` and ``var`` included: the reference's
``TrainState.params`` is flax's whole ``variables`` dict, ``batch_stats``
and all, so ``jax.grad`` differentiates the running statistics and AdamW
updates them.  Parameters and moments are updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from video_stream_segmenetation_tpu_torch.parallel.mesh import (
    data_parallel_forward,
    installed_forward,
    reduce_sum,
    shard_replicas,
    stream_sharding,
)
from video_stream_segmenetation_tpu_torch.runtime.precision import pinned
from video_stream_segmenetation_tpu_torch.train.losses import matting_loss


@dataclasses.dataclass
class AdamWState:
    count: torch.Tensor  # int32 scalar: updates taken
    mu: dict  # first moments, by parameter name
    nu: dict  # second moments


# optax's defaults, as the reference's make_optimizer takes them
MAX_NORM, B1, B2, EPS = 1.0, 0.9, 0.999, 1e-8


@dataclasses.dataclass
class ClipAdamW:
    """optax ``chain(clip_by_global_norm(MAX_NORM), adamw(lr, B1, B2, EPS,
    weight_decay))`` over a dict of tensors: :meth:`init` and
    :meth:`update` as optax's ``GradientTransformation``."""

    lr: float
    weight_decay: float = 1e-5

    def init(self, params: dict) -> AdamWState:
        first = next(iter(params.values()))
        return AdamWState(
            count=torch.zeros((), dtype=torch.int32, device=first.device),
            mu={k: torch.zeros_like(p, memory_format=torch.contiguous_format)
                for k, p in params.items()},
            nu={k: torch.zeros_like(p, memory_format=torch.contiguous_format)
                for k, p in params.items()})

    @torch.no_grad()
    def update(self, grads: dict, state: AdamWState, params: dict):
        """-> (updates, state); the moments are updated in place."""
        g_norm = global_norm(grads)
        # clip_by_global_norm: select(norm < max, g, g / norm * max)
        keep = g_norm < MAX_NORM
        grads = {k: torch.where(keep, g, (g / g_norm) * MAX_NORM) for k, g in grads.items()}
        state.count = state.count + 1
        count = state.count.to(torch.float32)
        bc1 = 1 - torch.pow(torch.full_like(count, B1), count)
        bc2 = 1 - torch.pow(torch.full_like(count, B2), count)
        updates = {}
        for k, g in grads.items():
            mu, nu = state.mu[k], state.nu[k]
            mu.copy_((1 - B1) * g + B1 * mu)
            nu.copy_((1 - B2) * (g ** 2) + B2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
            updates[k] = -self.lr * (u + self.weight_decay * params[k])
        return updates, state


def make_optimizer(lr: float = 1e-3, weight_decay: float = 1e-5) -> ClipAdamW:
    return ClipAdamW(lr, weight_decay)


def global_norm(tree: dict) -> torch.Tensor:
    """optax ``global_norm``: sqrt of the sum of every leaf's sum of
    squares, the leaf sums added in order."""
    total = None
    for g in tree.values():
        s = torch.sum(g * g)
        total = s if total is None else total + s
    return torch.sqrt(total)


def apply_updates(params: dict, updates: dict) -> None:
    """``p += u`` for every parameter, in place."""
    with torch.no_grad():
        for k, p in params.items():
            p.add_(updates[k])


@dataclasses.dataclass
class TrainState:
    params: dict  # name -> the module's nn.Parameter (live)
    opt_state: AdamWState
    step: int


def init_train_state(model: torch.nn.Module, tx: ClipAdamW | None = None):
    """``(TrainState over model's parameters, tx)``; the module holds the
    parameters (built from a seed or a tree, models/mattenet_hd.py)."""
    tx = tx or make_optimizer()
    params = dict(model.named_parameters())
    return TrainState(params=params, opt_state=tx.init(params), step=0), tx


def make_train_step(model: torch.nn.Module, tx: ClipAdamW,
                    loss_fn: Callable | None = None):
    """``train_step(state, frames [B, H, W, 3], alpha_gt [B, H, W]) ->
    (state, metrics)``.  ``loss_fn(frames, alpha_gt) -> (loss, metrics)``
    overrides the default matting loss of ``model``'s outputs (e.g.
    losses.make_pipeline_loss: backprop through the serving refine chain);
    ``train_step(state, *args)`` passes its arguments after the state to
    ``loss_fn`` as they are (the other trainers: a generator).  The
    metrics carry ``grad_norm``, the gradients' global norm before
    clipping."""
    if loss_fn is None:
        def loss_fn(frames, alpha_gt):
            return matting_loss(model(frames), alpha_gt, frames)

    def train_step(state: TrainState, *args):
        names = list(state.params)
        with torch.enable_grad():
            loss, metrics = loss_fn(*args)
            grads = torch.autograd.grad(loss, [state.params[k] for k in names],
                                        allow_unused=True)
        # a leaf the loss does not read (a head it ignores) has a zero
        # gradient, as jax.grad gives it, and still decays
        grads = {k: torch.zeros_like(state.params[k]) if g is None else g
                 for k, g in zip(names, grads)}
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        apply_updates(state.params, updates)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = global_norm(grads)
        return TrainState(state.params, opt_state, state.step + 1), metrics

    return train_step


def make_dp_train_step(model: torch.nn.Module, tx: ClipAdamW, mesh, batch: int,
                       loss_fn: Callable | None = None):
    """The data-parallel :func:`make_train_step` over ``mesh`` (the
    reference's train step jitted over replicated parameters and a batch
    sharded on ``DATA_AXIS``), for batches of ``batch`` (it must divide over
    the data axis, or ValueError).  ``model`` lives on the mesh's first
    device; each other shard gets a replica of it on its device.  A step:
    the loss of the whole batch on the first device, with ``model``'s
    forward replaced for its length by the mesh's
    (parallel/mesh.py::data_parallel_forward: each shard's rows through its
    replica, the outputs gathered on the first device), so that the loss's
    sums normalise over the whole batch (a mean of per-shard losses would
    be another loss); one backward, the replicas' gradients summed in
    shard order on the first device (parallel/mesh.py::reduce_sum), one
    ClipAdamW update with the global norm of that sum, and the parameters
    copied back to the replicas.  The loss is the matting loss of
    ``model``'s outputs, or ``loss_fn(frames, alpha_gt) -> (loss,
    metrics)``, a closure over ``model`` as :func:`make_train_step` takes
    it (losses.make_pipeline_loss); it must call the model on the whole
    batch (a call on other rows raises ValueError).
    ``train_step(state, frames, alpha_gt) -> (state, metrics)`` as
    :func:`make_train_step`'s; ``train_step.grads(frames, alpha_gt) ->
    (loss, metrics, summed gradients)`` is its first half,
    ``train_step.replicas`` the models a shard."""
    stream_sharding(mesh, batch)  # the batch must divide over the data axis
    first = mesh.first
    replicas = shard_replicas(mesh, model)
    for r in replicas:
        r.requires_grad_(True)
    names = [k for k, _ in model.named_parameters()]
    params = [dict(r.named_parameters()) for r in replicas]
    forward = data_parallel_forward(mesh, replicas, batch)
    if loss_fn is None:
        def loss_fn(frames, alpha_gt):
            return matting_loss(model(frames), alpha_gt, frames)

    def grads(frames, alpha_gt):
        """``(loss, metrics, the gradients summed over the replicas)``."""
        if frames.shape[0] != batch:
            raise ValueError(f"a batch of {frames.shape[0]} for a step made for {batch}")
        with torch.enable_grad(), installed_forward(model, forward):
            loss, metrics = loss_fn(frames, alpha_gt)
            leaves = [p[k] for p in params for k in names]
            per_leaf = torch.autograd.grad(loss, leaves, allow_unused=True)
        n = len(names)
        summed = {}
        for i, k in enumerate(names):
            per = [per_leaf[r * n + i] for r in range(len(replicas))]
            summed[k] = reduce_sum([torch.zeros_like(params[r][k]) if g is None else g
                                    for r, g in enumerate(per)], first)
        return loss, metrics, summed

    def train_step(state: TrainState, frames, alpha_gt):
        loss, metrics, summed = grads(frames, alpha_gt)
        updates, opt_state = tx.update(summed, state.opt_state, state.params)
        apply_updates(state.params, updates)
        with torch.no_grad():
            for p in params[1:]:
                for k in names:
                    p[k].copy_(state.params[k], non_blocking=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = global_norm(summed)
        return TrainState(state.params, opt_state, state.step + 1), metrics

    train_step.grads = grads
    train_step.replicas = replicas
    return train_step


def train_steps(model: torch.nn.Module, loss_fn: Callable, steps: int, lr: float,
                seed: int = 1):
    """Train every parameter of ``model`` in place (made trainable, its
    BatchNorm statistics included) with :class:`ClipAdamW` at ``lr`` for
    ``steps`` steps; ``loss_fn(generator) -> (loss, metrics)`` draws each
    step's batch on a ``torch.Generator`` on the model's device seeded
    with ``seed`` (the loop of the reference's face and variant trainers,
    ``tools/train_face.py:111-151``, ``tools/train_variants.py:43-63``).
    Yields ``(i, metrics)`` after each step (device tensors: the loss
    metrics, ``loss`` and ``grad_norm``); the steps run under
    runtime/precision.py::pinned."""
    model.requires_grad_(True)
    tx = make_optimizer(lr)
    state, _ = init_train_state(model, tx)
    step = make_train_step(model, tx, loss_fn)
    gen = torch.Generator(device=next(model.parameters()).device).manual_seed(seed)
    with pinned():
        for i in range(steps):
            state, metrics = step(state, gen)
            yield i, metrics


def reset_peak(device) -> None:
    """Reset the card's peak-memory counter (no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_mib(device) -> float | None:
    """The card's peak allocated memory since :func:`reset_peak`, MiB (None
    on the CPU)."""
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**20
