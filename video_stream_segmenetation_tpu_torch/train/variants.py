"""Train the variant-model zoo on synthetic data and save the trees as numpy
exports (port of ``tools/train_variants.py``).

    python -m video_stream_segmenetation_tpu_torch.train.variants --out DIR \\
        [--steps 1200] [--only rvm,u2net,multiclass,multiclass_hd,multiclass_hd_pico] \\
        [--device cuda]

* RecurrentMatteNet (the ``rvm`` preset's): unrolled over clips of a
  batch rolled sideways a step at a time, so that the recurrent state
  carries temporal context; alpha L1 and an L1 + BCE on the small alpha;
* SaliencyNet (``u2``): alpha L1 + 0.5 BCE at its 320x320 geometry;
* MatteNet with 4 class heads (``multiclass``) and the K=4 MatteNetHD at
  the nano and pico trunks (``multiclass_fast``, ``multiclass_fast_pico``):
  a class-weighted cross-entropy against the 4-way class simplex (bg,
  body, head, facial features) of the face scenes' parts (train/face.py).

Each job's export carries the reference's checkpoint name: ``rvm.npz``,
``u2net.npz``, ``mattenet_multiclass.npz``, ``mattenet_hd10_mc.npz``,
``mattenet_hd10_mc_pico.npz`` (bridge.py reads them; the K=4 MatteNetHD
trees go through bridge.params_from_jax before the int8 presets serve
them).  Every trainer draws its batches on one ``torch.Generator`` on the
card (train/step.py::train_steps); runs on the card unless ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import MatteNetHD
from video_stream_segmenetation_tpu_torch.models.modnet import MatteNet, init_mattenet_params
from video_stream_segmenetation_tpu_torch.models.rvm import (
    RecurrentMatteNet,
    init_rvm_params,
    init_state,
)
from video_stream_segmenetation_tpu_torch.models.u2net import SaliencyNet, init_u2net_params
from video_stream_segmenetation_tpu_torch.ops.resize import resize_bilinear
from video_stream_segmenetation_tpu_torch.train.face import synthetic_face_batch
from video_stream_segmenetation_tpu_torch.train.loop import synthetic_matting_batch
from video_stream_segmenetation_tpu_torch.train.losses import clip
from video_stream_segmenetation_tpu_torch.train.step import train_steps

LOG_EVERY = 200
LR = 1e-3
FT_MIN_STEPS = 200  # the K-class MatteNetHD's fine-tune: max(steps // 2, FT_MIN_STEPS)
CLASS_WEIGHTS = (1.0, 1.0, 3.0, 6.0)  # bg, body, head, features
EPS = 1e-6


def say(msg: str) -> None:
    print(msg, flush=True)


def _trainer(name: str, model: torch.nn.Module, loss_fn, steps: int, lr: float,
             seed: int = 1, on_step=None) -> tuple[dict, list]:
    """Train ``model`` in place from the tree it holds (train/step.py::
    train_steps) -> (its flax-named numpy tree, history): ``{"step",
    "loss", **metrics}`` at every :data:`LOG_EVERY`-th step and the last,
    printed as the reference does.  ``on_step(i, metrics)`` sees every
    step's metrics."""
    history = []
    for i, metrics in train_steps(model, loss_fn, steps, lr, seed):
        if on_step is not None:
            on_step(i, metrics)
        if i % LOG_EVERY == 0 or i == steps - 1:
            rec = {"step": i, **{k: float(v) for k, v in metrics.items() if k != "grad_norm"}}
            history.append(rec)
            say(f"[{name}] {json.dumps({k: round(v, 4) for k, v in rec.items()})}")
    return model.tree(), history


def _bce(p: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    p = clip(p, EPS, 1 - EPS)
    return -(target * torch.log(p) + (1 - target) * torch.log(1 - p)).mean()


def _roll_w(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``jnp.roll(x, k, axis=2)`` for a device scalar ``k`` (a gather: no
    host read of the shift)."""
    w = x.shape[2]
    idx = torch.remainder(torch.arange(w, device=x.device) - k, w)
    return x.index_select(2, idx)


def rvm_loss(model: RecurrentMatteNet, frames: torch.Tensor, gt: torch.Tensor,
             shift: torch.Tensor, unroll: int):
    """The recurrent net unrolled over ``unroll`` frames, frame t the batch
    rolled ``shift * t`` pixels sideways from the cold state: the alpha's
    L1, and on the small alpha an L1 and a BCE (which keeps the gradient
    alive where the sigmoid saturates), each averaged over the frames."""
    state = init_state(frames.shape[0], tuple(frames.shape[1:3]), device=frames.device)
    total = aux = 0.0
    for t in range(unroll):
        f_t, g_t = _roll_w(frames, shift * t), _roll_w(gt, shift * t)
        out = model(f_t, state)
        state = out["state"]
        total = total + torch.abs(out["alpha"] - g_t).mean()
        a_s = out["alpha_small"]
        g_s = resize_bilinear(g_t, tuple(a_s.shape[-2:]), method="half_pixel",
                              channel_last=False)
        aux = aux + torch.abs(a_s - g_s).mean() + _bce(a_s, g_s)
    l1 = total / unroll
    return l1 + aux / unroll, {"alpha_l1": l1, "aux": aux / unroll}


def train_rvm(steps: int, hw=(288, 512), batch: int = 8, unroll: int = 3, device="cuda",
              on_step=None) -> tuple[dict, list]:
    model = RecurrentMatteNet(init_rvm_params(0), device=device)

    def loss_fn(gen):
        frames, gt = synthetic_matting_batch(gen, batch, hw)
        shift = torch.randint(-12, 13, (), generator=gen, device=gen.device)
        return rvm_loss(model, frames, gt, shift, unroll)

    return _trainer("rvm", model, loss_fn, steps, LR, on_step=on_step)


def u2_loss(model: SaliencyNet, frames: torch.Tensor, gt: torch.Tensor):
    """Alpha L1 + 0.5 BCE."""
    alpha = model(frames)["alpha"]
    l1 = torch.abs(alpha - gt).mean()
    bce = _bce(alpha, gt)
    return l1 + 0.5 * bce, {"alpha_l1": l1, "bce": bce}


def train_u2(steps: int, hw=(320, 320), batch: int = 16, device="cuda",
             on_step=None) -> tuple[dict, list]:
    model = SaliencyNet(init_u2net_params(0), device=device)
    return _trainer("u2", model,
                    lambda gen: u2_loss(model, *synthetic_matting_batch(gen, batch, hw)),
                    steps, LR, on_step=on_step)


def _class_simplex(parts: dict) -> torch.Tensor:
    """Scene parts -> 4-way class maps ``[B, H, W, 4]``: background, body,
    head, facial features, normalized to sum to 1."""
    feat = parts["feat"] * parts["a_head"]
    head = torch.clamp(parts["a_head"] - feat, 0.0, 1.0)
    body = torch.clamp(parts["a_body"] - parts["a_head"], 0.0, 1.0)
    fg = torch.maximum(parts["a_body"], parts["a_head"])
    cls = torch.stack([1.0 - fg, body, head, feat], dim=-1)
    return cls / torch.clamp(cls.sum(-1, keepdim=True), min=EPS)


def class_loss(alpha: torch.Tensor, gt: torch.Tensor):
    """Class-weighted cross-entropy of the K softmax maps ``[B, h, w, K]``
    against the class simplex (resized half-pixel to the maps and
    renormalized where they differ): head and feature regions are tiny
    next to background and body, and unweighted CE lets the net ignore
    them."""
    if alpha.shape[-3:-1] != gt.shape[-3:-1]:
        gt = resize_bilinear(gt, tuple(alpha.shape[-3:-1]), method="half_pixel")
        gt = gt / torch.clamp(gt.sum(-1, keepdim=True), min=EPS)
    w = torch.tensor(CLASS_WEIGHTS[: alpha.shape[-1]], device=alpha.device)
    ce = -((gt * torch.log(clip(alpha, EPS, 1.0))) * w).sum(-1).mean()
    acc = (torch.argmax(alpha, -1) == torch.argmax(gt, -1)).to(torch.float32).mean()
    return ce, {"ce": ce, "pixel_acc": acc}


def class_loss_fn(model: torch.nn.Module, batch: int, hw):
    """``loss_fn(generator)``: a fresh face batch with its parts, the
    model's K maps against their class simplex."""

    def loss_fn(gen):
        frames, _, _, parts = synthetic_face_batch(gen, batch, hw, return_parts=True)
        return class_loss(model(frames)["alpha"], _class_simplex(parts))

    return loss_fn


def train_multiclass(steps: int, hw=(288, 512), batch: int = 12, k: int = 4, device="cuda",
                     on_step=None) -> tuple[dict, list]:
    model = MatteNet(init_mattenet_params(0, k), device=device)
    return _trainer("multiclass", model, class_loss_fn(model, batch, hw), steps, LR,
                    on_step=on_step)


def train_multiclass_hd(steps: int, hw=(720, 1280), batch: int = 6, k: int = 4,
                        pre_hw=(240, 320), pre_batch: int = 24, decoder: str = "nano",
                        device="cuda", on_step=None) -> tuple[dict, list]:
    """The K-class MatteNetHD of the multiclass_fast presets: pretrain at
    ``pre_hw`` (5e-4), then fine-tune at the serving 720p (2e-4) for
    ``max(steps // 2, FT_MIN_STEPS)`` steps (the serving-resolution phase
    train/loop.py::fit explains).  Returns the fine-tune's history."""
    model = MatteNetHD(10, 4, decoder, device=device, num_classes=k)
    _trainer("multiclass_hd/pre", model, class_loss_fn(model, pre_batch, pre_hw), steps, 5e-4,
             on_step=on_step)
    return _trainer("multiclass_hd/ft", model, class_loss_fn(model, batch, hw),
                    max(steps // 2, FT_MIN_STEPS), 2e-4, on_step=on_step)


# job -> (export name, trainer); the reference's job names and checkpoints
JOBS = {
    "rvm": ("rvm", train_rvm),
    "u2net": ("u2net", train_u2),
    "multiclass": ("mattenet_multiclass", train_multiclass),
    "multiclass_hd": ("mattenet_hd10_mc", train_multiclass_hd),
    "multiclass_hd_pico": ("mattenet_hd10_mc_pico",
                           lambda steps, **kw: train_multiclass_hd(steps, decoder="pico", **kw)),
}


def main(out_dir, steps: int = 1200, only=None, device="cuda", sizes=None) -> dict:
    """Run the jobs (``only``: a set of job names), each tree to
    ``out_dir/<export>.npz`` -> ``{job: path}``.  ``sizes`` maps a job to
    keyword overrides of its trainer's geometry (``hw``, ``batch``, ...)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    written = {}
    for name, (export, train) in JOBS.items():
        if only and name not in only:
            continue
        tree, _ = train(steps, device=device, **(sizes or {}).get(name, {}))
        written[name] = out_dir / f"{export}.npz"
        bridge.save_export(written[name], tree)
        say(f"[{name}] saved to {written[name]}")
    return written


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="directory for the .npz exports")
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--only", default=None, help=f"comma-separated jobs of {list(JOBS)}")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.out, a.steps, set(a.only.split(",")) if a.only else None, a.device)
