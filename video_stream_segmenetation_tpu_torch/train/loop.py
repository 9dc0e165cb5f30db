"""The training loop and on-device synthetic matting data (port of
``train/loop.py``).

The synthetic generator composites soft-edged person-like ellipses over
textured backgrounds on the device, from a ``torch.Generator`` on it.  It is
split into the draws (:func:`synthetic_draws`) and a render of them
(:func:`render_matting_batch`), so that a test can render the reference's
own draws.  Real-data training plugs into :func:`fit` through ``data_fn``.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from video_stream_segmenetation_tpu_torch.models.mattenet_hd import MatteNetHD
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import init_params as init_hd
from video_stream_segmenetation_tpu_torch.models.modnet import MatteNet, init_mattenet_params
from video_stream_segmenetation_tpu_torch.models.u2net import SaliencyNet, init_u2net_params
from video_stream_segmenetation_tpu_torch.ops.resize import resize_bilinear
from video_stream_segmenetation_tpu_torch.runtime.precision import pinned
from video_stream_segmenetation_tpu_torch.train.losses import iou_metric
from video_stream_segmenetation_tpu_torch.train.step import (
    init_train_state,
    make_dp_train_step,
    make_optimizer,
    make_train_step,
)


def uniform(gen: torch.Generator, shape, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    """Uniform draws in [lo, hi) on ``gen``'s device."""
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


def person_draws(gen: torch.Generator, batch: int, hw: tuple[int, int]) -> dict:
    """The person's draws of a synthetic batch, on ``gen``'s device, with
    the reference's ranges (``train/loop.py:34-63``): ellipse centres,
    radii and edge softness, the head's offset and radius factors, each
    ``[B, 1, 1]``."""
    h, w = hw
    b1 = (batch, 1, 1)
    return {"cx": uniform(gen, b1, 0.25 * w, 0.75 * w),
            "cy": uniform(gen, b1, 0.45 * h, 0.85 * h),
            "rx": uniform(gen, b1, 0.12 * w, 0.28 * w),
            "ry": uniform(gen, b1, 0.28 * h, 0.5 * h),
            "edge": uniform(gen, b1, 0.05, 0.2), "head_dy": uniform(gen, b1, 0.9, 1.2),
            "head_r": uniform(gen, b1, 0.35, 0.55)}


def synthetic_draws(gen: torch.Generator, batch: int, hw: tuple[int, int]) -> dict:
    """The random draws of one synthetic batch: :func:`person_draws`, then
    colours ``[B, 1, 1, 3]``, textures and a standard normal ``[B, H, W,
    3]``, the background texture's gain ``[B, 1, 1, 1]``."""
    b3, img = (batch, 1, 1, 3), (batch, *hw, 3)
    return {**person_draws(gen, batch, hw),
            "fg_color": uniform(gen, b3, 0.25, 0.9), "fg_tex": uniform(gen, img, -0.15, 0.15),
            "bg_base": uniform(gen, b3, 0.0, 0.5), "bg_tex": uniform(gen, img),
            "bg_gain": uniform(gen, (batch, 1, 1, 1), 0.1, 0.4),
            "noise": torch.randn(img, generator=gen, device=gen.device)}


def grid(hw: tuple[int, int], device):
    """``(yy [1, H, 1], xx [1, 1, W])`` f32 pixel indices."""
    h, w = hw
    return (torch.arange(h, dtype=torch.float32, device=device)[None, :, None],
            torch.arange(w, dtype=torch.float32, device=device)[None, None, :])


def person_parts(d: dict, hw: tuple[int, int]) -> dict:
    """The person of a synthetic batch from its draws: the body and head
    ellipses' soft alphas ``a_body``, ``a_head`` ``[B, H, W]``, the head's
    centre ``hy`` and radius ``hr`` ``[B, 1, 1]``, the grid ``yy``/``xx``
    (the reference's arithmetic, in its order)."""
    yy, xx = grid(hw, d["cx"].device)
    cx, cy, rx, ry, edge = d["cx"], d["cy"], d["rx"], d["ry"], d["edge"]
    d_body = torch.sqrt(((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2)
    a_body = torch.clamp((1.05 - d_body) / edge, 0.0, 1.0)
    hy = cy - ry * d["head_dy"]
    hr = rx * d["head_r"]
    d_head = torch.sqrt(((xx - cx) / hr) ** 2 + ((yy - hy) / (hr * 1.25)) ** 2)
    a_head = torch.clamp((1.05 - d_head) / edge, 0.0, 1.0)
    return {"a_body": a_body, "a_head": a_head, "hy": hy, "hr": hr, "yy": yy, "xx": xx}


def render_matting_batch(d: dict, hw: tuple[int, int]):
    """Frames ``[B, H, W, 3]`` in [0, 1] and ground-truth alpha ``[B, H, W]``
    from :func:`synthetic_draws`: a soft-edged body ellipse and a head
    ellipse above it, textured foreground over a textured background, plus
    sensor noise (the reference's arithmetic, in its order)."""
    parts = person_parts(d, hw)
    alpha = torch.maximum(parts["a_body"], parts["a_head"])
    fg = d["fg_color"] + d["fg_tex"]
    bg = d["bg_base"] + d["bg_tex"] * d["bg_gain"]
    noise = d["noise"] * 0.02
    frame = torch.clamp(fg * alpha[..., None] + bg * (1 - alpha[..., None]) + noise, 0, 1)
    return frame, alpha


def synthetic_matting_batch(gen: torch.Generator, batch: int, hw: tuple[int, int]):
    """``[B, H, W, 3]`` frames in [0, 1] and ``[B, H, W]`` alpha, made on
    ``gen``'s device."""
    return render_matting_batch(synthetic_draws(gen, batch, hw), hw)


def seeded_tree(model: torch.nn.Module, seed: int) -> dict:
    """The float tree of ``model``'s form drawn from ``seed``
    (models/registry.py's ``init_tree``): a MatteNetHD's plan or a
    MatteNet, with the model's number of classes."""
    if isinstance(model, MatteNetHD):
        return init_hd(model.decoder, seed, model.stem_stride, model.num_classes)
    if isinstance(model, MatteNet):
        return init_mattenet_params(seed, model.num_classes)
    if isinstance(model, SaliencyNet):
        return init_u2net_params(seed)
    raise TypeError(f"fit trains a MatteNetHD, a MatteNet or a SaliencyNet, not "
                    f"{type(model).__name__}")


def _eval_iou(model, frames, gt) -> float:
    with torch.no_grad():
        alpha = model(frames)["alpha"]
    if alpha.shape[-2:] != gt.shape[-2:]:
        gt = resize_bilinear(gt, tuple(alpha.shape[-2:]), method="half_pixel",
                             channel_last=False)
    return float(iou_metric(alpha, gt).mean())


def fit(model: torch.nn.Module, hw: tuple[int, int] = (96, 160), batch: int = 16,
        steps: int = 200, lr: float = 1e-3, seed: int = 0,
        data_fn: Callable | None = None, log_every: int = 50, mesh=None,
        init_params: dict | None = None, steps_per_call: int = 1, loss_fn=None,
        on_step: Callable | None = None):
    """Train a matting model (a MatteNetHD at any plan, or a MatteNet) in
    place on its device; returns (the trained flax-named numpy tree,
    history).

    The model starts from the seeded tree of ``seed`` (``model.load_tree``
    of :func:`seeded_tree`, with the model's classes), or from
    ``init_params`` (a warm start: the serving-resolution fine-tune, whose
    texture and noise frequencies relative to the stem patch do not
    transfer from the pretraining geometry).  ``data_fn(generator, batch, hw) -> (frames [B,
    H, W, 3] in [0, 1], alpha_gt [B, H, W])`` on the model's device
    defaults to the synthetic generator; its generator is seeded with
    ``seed``.  History records ``{"step", "loss", "iou", "elapsed_s"}`` at
    every ``log_every``-th step and the last (IoU of the model's alpha on
    that step's batch after the update).  ``steps_per_call`` > 1 logs once
    a chunk of that many steps, on a fresh batch, as the reference's
    chunked loop does.  Runs under runtime/precision.py::pinned (TF32
    off: the f32 products of the alpha upsample and the losses in f32).
    ``on_step(i, metrics)``, where given, sees every step's metrics (device
    tensors: the losses and ``grad_norm``) right after the step.

    ``mesh`` (parallel/mesh.py): data-parallel training, the reference's
    ``mesh=``: the model (on the mesh's first device) is replicated to the
    other shards, each batch (made on the first device, as without a mesh)
    is split on its leading axis over the data axis (``batch`` must divide
    over it, or ValueError), and each step computes the one-device loss of
    the whole batch (train/step.py::make_dp_train_step).
    ``loss_fn`` runs there as on one device, ``model``'s forward being the
    mesh's for the length of each step's loss (it must call the model on
    the whole batch, or ValueError).  ``steps_per_call`` is ignored under a
    mesh, as the reference ignores it."""
    data_fn = data_fn or synthetic_matting_batch
    dev = next(model.parameters()).device
    if init_params is None:
        init_params = seeded_tree(model, seed)
    model.load_tree(init_params)
    model.requires_grad_(True)
    tx = make_optimizer(lr)
    state, _ = init_train_state(model, tx)
    step_fn = (make_train_step(model, tx, loss_fn=loss_fn) if mesh is None
               else make_dp_train_step(model, tx, mesh, batch, loss_fn=loss_fn))
    gen = torch.Generator(device=dev).manual_seed(seed)

    history = []
    t0 = time.perf_counter()

    def step(frames, alpha_gt):
        nonlocal state
        state, metrics = step_fn(state, frames, alpha_gt)
        if on_step is not None:
            on_step(state.step - 1, metrics)
        return metrics

    def record(i: int, loss, frames, gt) -> None:
        history.append({"step": i, "loss": float(loss),
                        "iou": _eval_iou(model, frames, gt),
                        "elapsed_s": round(time.perf_counter() - t0, 1)})

    with pinned():
        if steps_per_call > 1 and mesh is None:
            i = 0
            while i < steps:
                k = min(steps_per_call, steps - i)
                for _ in range(k):
                    metrics = step(*data_fn(gen, batch, hw))
                i += k
                # chunk-boundary logging: a fresh batch, the same metric
                record(i - 1, metrics["loss"], *data_fn(gen, batch, hw))
        else:
            for i in range(steps):
                frames, alpha_gt = data_fn(gen, batch, hw)
                metrics = step(frames, alpha_gt)
                if i % log_every == 0 or i == steps - 1:
                    record(i, metrics["loss"], frames, alpha_gt)
    return model.tree(), history

