"""The photo-background trainers (port of ``tools/train_realbg.py``,
``tools/train_flagship_realbg.py``, ``tools/finetune_active_realbg.py``,
``tools/finetune_u2_realbg.py`` and ``tools/finetune_variants_realbg.py``).

    python -m video_stream_segmenetation_tpu_torch.train.realbg JOB [steps] \\
        --photos DIR --out DIR [--report FILE] [--ckpt NAME] [--real-frac F] \\
        [--lr F] [--batch N] [--no-pipe-loss] [--promote] [--device cuda]

Each job trains on procedural people composited over augmented crops of the
photographs under ``--photos`` (train/realdata.py), mixed with the fully
procedural scenes:

* ``realbg``: the same MatteNet at width 0.75 trained twice at 144x256,
  batch 16, lr 1e-3, on procedural scenes and on the two-ellipse person
  over the photos; the 2x2 matrix of model-only IoU of both models on both
  held-out distributions;
* ``flagship``: the pico MatteNetHD (stem stride 10, head x4) warm-started
  from ``--ckpt`` and fine-tuned at 720x1280, batch 8, lr 1.5e-4 on batches
  of ``--real-frac`` articulated people over the photos, through the
  serving-chain loss (losses.make_pipeline_loss; ``--no-pipe-loss``: the
  matting loss); model-only IoU before and after on the synthetic,
  articulated and two-ellipse distributions; saved as ``<ckpt>_mix``
  (``--promote``: as ``<ckpt>``);
* ``active``: the natural layout's MatteNet at 288x512, batch 16, lr 3e-4
  on the three-way batch (:data:`THREE_WAY`) through the pipeline loss,
  then three phases at (96x128, 1.5e-4, 1500), (288x512, 1e-4, 1500) and
  (96x128, 7e-5, 800) steps; saved as ``mattenet_mix720``;
* ``u2``: the SaliencyNet at 320x320, batch 16, lr 2e-4 on the three-way
  batch, L1 + 0.5 BCE; saved as ``u2net_mix720``;
* ``rvm``: the RecurrentMatteNet at 288x512, batch 8, unrolled over 3
  rolled frames, lr 3e-4 on the two-way batch (:data:`TWO_WAY`); saved as
  ``rvm_mix``;
* ``multiclass_pico``: the K=4 pico MatteNetHD on the class-weighted cross
  entropy over the articulated parts, face scenes and two-ellipse people
  (:data:`CLASS_MIX`) in three phases: pre (240x320, batch 16, 3e-4,
  ``max(steps // 2, 400)``), ft720 (720x1280, batch 4, 1e-4, ``steps``)
  and polish (240x320, batch 16, 7e-5, ``max(steps // 4, 200)``); saved as
  ``mattenet_hd10_mc_pico_mix``.

The warm starts are the committed exports under ``weights/``
(``--ckpt`` names one, or the path of an ``.npz`` or of a
utils/checkpoint.py directory); the float MatteNetHD trees are the
``_f32`` exports (bridge.FLOAT_HD_EXPORTS).  Trees are written with
utils/checkpoint.py::save_params under ``--out``, the JSON report to
``--report`` (default ``OUT/<job>.json``).  A candidate is promoted only
after both quality gates pass (video_stream_segmenetation_tpu_torch/
evaluate.py: ``variants`` and ``realistic``).  Every draw comes from a
``torch.Generator`` on the model's device; each batch is split into its
draws (:func:`mix_draws`) and their render (:func:`render_mix`), so that a
test can render the reference's own draws.  Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch

from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import MatteNetHD
from video_stream_segmenetation_tpu_torch.models.modnet import MatteNet, init_mattenet_params
from video_stream_segmenetation_tpu_torch.models.rvm import RecurrentMatteNet
from video_stream_segmenetation_tpu_torch.models.u2net import SaliencyNet
from video_stream_segmenetation_tpu_torch.ops.resize import resize_bilinear
from video_stream_segmenetation_tpu_torch.runtime.precision import pinned
from video_stream_segmenetation_tpu_torch.train import realdata as R
from video_stream_segmenetation_tpu_torch.train import variants as PV
from video_stream_segmenetation_tpu_torch.train.face import face_draws, render_face_batch
from video_stream_segmenetation_tpu_torch.train.loop import (
    fit,
    render_matting_batch,
    synthetic_draws,
    synthetic_matting_batch,
)
from video_stream_segmenetation_tpu_torch.train.losses import iou_metric, make_pipeline_loss
from video_stream_segmenetation_tpu_torch.utils.checkpoint import restore_params, save_params

RENDER_HW = (720, 1280)  # the serving frames: scenes rendered there, then served down
EVAL_BATCHES, EVAL_SEED = 4, 999
LOG_EVERY, STEPS_PER_CALL = 50, 50
# the multiclass_pico phases' least steps: max(steps // 2, ...), max(steps // 4, ...)
MC_MIN_STEPS = (400, 200)


@dataclasses.dataclass(frozen=True)
class Job:
    """One trainer: its geometry ``hw``, ``batch``, learning rate, default
    steps, the warm start's export (``ckpt``, None: seeded) and the name
    its tree is saved under; ``small_hw``/``small_batch`` the
    multi-resolution phases' geometry, ``phases`` their (lr, steps)."""

    hw: tuple[int, int]
    batch: int
    lr: float
    steps: int
    ckpt: str | None
    saves: str
    small_hw: tuple[int, int] | None = None
    small_batch: int | None = None
    phases: tuple = ()
    unroll: int = 0


JOBS = {
    "realbg": Job((144, 256), 16, 1e-3, 400, None, "mattenet_w075"),
    "flagship": Job(RENDER_HW, 8, 1.5e-4, 400, "mattenet_hd10_pico", "mattenet_hd10_pico_mix"),
    "active": Job((288, 512), 16, 3e-4, 8000, "mattenet", "mattenet_mix720", small_hw=(96, 128),
                  phases=((1.5e-4, 1500), (1e-4, 1500), (7e-5, 800))),
    "u2": Job((320, 320), 16, 2e-4, 5000, "u2net", "u2net_mix720"),
    "rvm": Job((288, 512), 8, 3e-4, 4000, "rvm", "rvm_mix", unroll=3),
    "multiclass_pico": Job(RENDER_HW, 4, 1e-4, 4000, "mattenet_hd10_mc_pico",
                           "mattenet_hd10_mc_pico_mix", small_hw=(240, 320), small_batch=16),
}
# the knobs only some jobs read
FLAGSHIP_ONLY = ("real_frac", "no_pipe_loss", "promote")


def say(msg: str) -> None:
    print(msg, flush=True)


# ---- the batches ---------------------------------------------------------


def THREE_WAY(batch: int) -> tuple:
    """The active and u2 fine-tunes' batch: half articulated people over
    photos and a quarter (at least 1) procedural scenes, both rendered at
    720p and served down, the rest procedural at the training geometry."""
    b_r, b_s = batch // 2, max(1, batch // 4)
    return (("real", b_r, True), ("synthetic", b_s, True),
            ("synthetic", batch - b_r - b_s, False))


def TWO_WAY(batch: int) -> tuple:
    """The RVM fine-tune's batch: half articulated people over photos, half
    procedural scenes, both rendered at 720p and served down."""
    return (("real", batch // 2, True), ("synthetic", batch - batch // 2, True))


def CLASS_MIX(batch: int) -> tuple:
    """The K-class fine-tune's batch at the training geometry: half
    articulated people over photos (their parts), a quarter (at least 1)
    face scenes (theirs), the rest two-ellipse people (body only)."""
    b_r, b_f = batch // 2, max(1, batch // 4)
    return (("real", b_r, False), ("face", b_f, False), ("synthetic", batch - b_r - b_f, False))


def serve_down(frames: torch.Tensor, alpha: torch.Tensor, hw):
    """A render resized to the training geometry as the serving pipeline
    resizes frames (``asymmetric`` taps), the alpha with it."""
    return (resize_bilinear(frames, hw, method="asymmetric"),
            resize_bilinear(alpha, hw, method="asymmetric", channel_last=False))


def mix_draws(gen: torch.Generator, plan: tuple, n: int, bank_hw, hw, render_hw) -> list:
    """The draws of a mixed batch of ``plan`` (``(kind, rows, rendered)``
    parts, :func:`THREE_WAY`...) in its order, a part at ``render_hw``
    (:data:`RENDER_HW` in the jobs) where it is rendered there, else at
    ``hw``; ``n`` photos of ``bank_hw``."""
    out = []
    for kind, rows, rendered in plan:
        at = render_hw if rendered else hw
        if kind == "real":
            d = R.articulated_draws(gen, rows, n, bank_hw, at)
        elif kind == "face":
            d = face_draws(gen, rows, at)
        else:
            d = synthetic_draws(gen, rows, at)
        out.append((kind, rendered, d))
    return out


def render_mix(bank: torch.Tensor, draws: list, hw, render_hw, classes: bool = False):
    """``(frames [B, H, W, 3], ground truth)`` of :func:`mix_draws`, the
    parts in order; a part rendered at ``render_hw`` goes through
    :func:`serve_down`.  ``classes``: the ground truth is the 4-way class
    simplex ``[B, H, W, 4]`` of each part's parts (a two-ellipse person is
    all body), else the alpha ``[B, H, W]``."""
    frames, gts = [], []
    for kind, rendered, d in draws:
        at = render_hw if rendered else hw
        if kind == "real":
            out = R.render_articulated(bank, d, at, return_parts=classes)
            fr, gt = out[0], (PV._class_simplex(out[2]) if classes else out[1])
        elif kind == "face":
            fr, _, _, parts = render_face_batch(d, at, return_parts=True)
            gt = PV._class_simplex(parts)
        else:
            fr, a = render_matting_batch(d, at)
            gt = (PV._class_simplex({"a_body": a, "a_head": torch.zeros_like(a),
                                     "feat": torch.zeros_like(a)}) if classes else a)
        if rendered:
            fr, gt = serve_down(fr, gt, hw)
        frames.append(fr)
        gts.append(gt)
    return torch.cat(frames), torch.cat(gts)


def mixed_data_fn(bank: torch.Tensor, plan, render_hw, classes: bool = False):
    """``data_fn(generator, batch, hw)`` of the mixed batches of ``plan``
    over the device bank ``bank``."""
    n, bh, bw, _ = bank.shape

    def data_fn(gen, batch: int, hw):
        return render_mix(bank, mix_draws(gen, plan(batch), n, (bh, bw), hw, render_hw), hw,
                          render_hw, classes)

    return data_fn


def device_bank(photos, hw, device, as_uint8: bool = True) -> torch.Tensor:
    """The photos under ``photos`` at twice ``hw`` (load_background_bank),
    on ``device`` once."""
    return torch.as_tensor(R.load_background_bank(hw, photos, oversample=2.0,
                                                  as_uint8=as_uint8)).to(device)


# ---- the losses ----------------------------------------------------------


def u2_loss_fn(model: SaliencyNet):
    """``loss_fn(frames, gt)``: the SaliencyNet's L1 + 0.5 BCE
    (train/variants.py::u2_loss), as fit takes it."""
    return lambda frames, gt: PV.u2_loss(model, frames, gt)


def rvm_loss_fn(model: RecurrentMatteNet, data_fn, batch: int, hw, unroll: int):
    """``loss_fn(generator)``: a fresh mixed batch, its sideways shift in
    [-12, 12], train/variants.py::rvm_loss."""

    def loss_fn(gen):
        frames, gt = data_fn(gen, batch, hw)
        shift = torch.randint(-12, 13, (), generator=gen, device=gen.device)
        return PV.rvm_loss(model, frames, gt, shift, unroll)

    return loss_fn


def class_mix_loss_fn(model: MatteNetHD, data_fn, batch: int, hw):
    """``loss_fn(generator)``: a fresh :data:`CLASS_MIX` batch, the class-
    weighted cross entropy of the model's K maps (train/variants.py::
    class_loss)."""

    def loss_fn(gen):
        frames, gt = data_fn(gen, batch, hw)
        return PV.class_loss(model(frames)["alpha"], gt)

    return loss_fn


# ---- evaluation ----------------------------------------------------------


def evaluate(model: torch.nn.Module, data_fn, hw, batch: int, n_batches: int = EVAL_BATCHES,
             seed: int = EVAL_SEED) -> float:
    """Model-only IoU (the alpha against the ground truth resized half-pixel
    to the alpha's grid) of ``n_batches`` held-out batches of ``data_fn``
    drawn from a generator seeded ``seed``, averaged."""
    gen = torch.Generator(device=next(model.parameters()).device).manual_seed(seed)
    ious = []
    with torch.no_grad(), pinned():
        for _ in range(n_batches):
            frames, gt = data_fn(gen, batch, hw)
            a = model(frames)["alpha"]
            if a.shape[-2:] != gt.shape[-2:]:
                gt = resize_bilinear(gt, tuple(a.shape[-2:]), method="half_pixel",
                                     channel_last=False)
            ious.append(float(iou_metric(a, gt).mean()))
    return sum(ious) / len(ious)


# ---- the jobs -------------------------------------------------------------


def warm_tree(name: str, float_hd: bool = False) -> dict:
    """The warm start ``name``: a path to an ``.npz`` export or a
    utils/checkpoint.py directory, or an export under ``weights/`` (a float
    MatteNetHD's with ``_f32``)."""
    path = Path(name)
    if path.is_dir():
        return restore_params(str(path))
    if path.suffix == ".npz":
        return bridge.load_export(path)
    path = bridge.WEIGHTS_DIR / (f"{name}_f32.npz" if float_hd else f"{name}.npz")
    if not path.exists():
        raise FileNotFoundError(f"no committed export {path.name} to warm-start from")
    return bridge.load_export(path)


@dataclasses.dataclass
class Options:
    """The command line's knobs (the reference's environment variables):
    None takes the job's own."""

    steps: int | None = None
    ckpt: str | None = None
    lr: float | None = None
    batch: int | None = None
    real_frac: float = 0.5
    no_pipe_loss: bool = False
    promote: bool = False


def _history(name: str, history: list) -> list:
    for rec in history:
        say(f"[{name}] {json.dumps(rec)}")
    return history


def run_realbg(job: Job, o: Options, photos, device, on_step=None) -> tuple[dict, dict]:
    bank = device_bank(photos, job.hw, device, as_uint8=False)
    real_fn = R.make_real_bg_data_fn(None, device_bank=bank)
    seeded = init_mattenet_params(0, width=0.75)  # fit's seed 0 at the job's width
    model = MatteNet(seeded, device=device)
    kw = dict(hw=job.hw, batch=o.batch, steps=o.steps, lr=o.lr, seed=0, on_step=on_step)
    say(f"bank: {bank.shape[0]} photos")
    p_syn, h_syn = fit(model, init_params=seeded, **kw)
    _history("realbg/synthetic", h_syn[-1:])
    p_real, h_real = fit(model, init_params=seeded, data_fn=real_fn, **kw)
    _history("realbg/realbg", h_real[-1:])
    iou = {}
    for trained, tree in (("synthetic", p_syn), ("realbg", p_real)):
        model.load_tree(tree)
        for dist, fn in (("synthetic", synthetic_matting_batch), ("realbg", real_fn)):
            iou[f"{trained}_trained_on_{dist}_eval"] = evaluate(model, fn, job.hw, o.batch)
    report = {"hw": list(job.hw), "steps": o.steps, "real_backgrounds": int(bank.shape[0]),
              "iou": iou}
    return report, {f"{job.saves}_synthetic": p_syn, f"{job.saves}_realbg": p_real}


def run_flagship(job: Job, o: Options, photos, device, on_step=None) -> tuple[dict, dict]:
    bank = device_bank(photos, job.hw, device)
    say(f"bank: {tuple(bank.shape)} uint8")
    real_fn = R.make_real_bg_data_fn(None, device_bank=bank, person="articulated")
    ellipse_fn = R.make_real_bg_data_fn(None, device_bank=bank)
    mixed_fn = R.make_mixed_data_fn(real_fn, real_frac=o.real_frac)
    params = warm_tree(o.ckpt, float_hd=True)
    model = MatteNetHD(10, 4, "pico", params=params, device=device)
    dists = (("synthetic", synthetic_matting_batch), ("realbg_articulated", real_fn),
             ("realbg_ellipse", ellipse_fn))
    before = {k: evaluate(model, fn, job.hw, o.batch) for k, fn in dists}
    say(f"model-only IoU before: {json.dumps(before)}")
    loss_fn = None if o.no_pipe_loss else make_pipeline_loss(model)
    params, history = fit(model, hw=job.hw, batch=o.batch, steps=o.steps, lr=o.lr,
                          log_every=LOG_EVERY, init_params=params, seed=3, data_fn=mixed_fn,
                          steps_per_call=STEPS_PER_CALL, loss_fn=loss_fn, on_step=on_step)
    _history(f"{o.ckpt}/mix", history)
    after = {k: evaluate(model, fn, job.hw, o.batch) for k, fn in dists}
    say(f"model-only IoU after: {json.dumps(after)}")
    name = Path(o.ckpt).name.removesuffix(".npz")
    saved = name if o.promote else f"{name}_mix"
    report = {"checkpoint": o.ckpt, "saved_as": saved, "steps": o.steps,
              "serve_hw": list(job.hw), "real_frac": o.real_frac, "lr": o.lr,
              "pipe_loss": not o.no_pipe_loss, "model_only_iou_before": before,
              "model_only_iou_after": after, "history": history}
    return report, {saved: params}


def run_active(job: Job, o: Options, photos, device, on_step=None) -> tuple[dict, dict]:
    bank720 = device_bank(photos, RENDER_HW, device)
    mixed_fn = mixed_data_fn(bank720, THREE_WAY, RENDER_HW)
    model = MatteNet(warm_tree(o.ckpt), device=device)
    loss_fn = make_pipeline_loss(model)
    params, history = fit(model, hw=job.hw, batch=o.batch, steps=o.steps, lr=o.lr,
                          init_params=model.tree(), seed=5, data_fn=mixed_fn,
                          steps_per_call=STEPS_PER_CALL, loss_fn=loss_fn, on_step=on_step)
    hist = {"mix": _history("active/mix", history[-3:])}
    # multi-resolution polish: the small geometry, back, and small again
    bank_s = device_bank(photos, job.small_hw, device)
    mixed_s = R.make_mixed_data_fn(R.make_real_bg_data_fn(None, device_bank=bank_s,
                                                          person="articulated"), 0.5)
    for (plr, psteps), (phw, pfn) in zip(job.phases, ((job.small_hw, mixed_s),
                                                      (job.hw, mixed_fn),
                                                      (job.small_hw, mixed_s))):
        params, history = fit(model, hw=phw, batch=o.batch, steps=psteps, lr=plr,
                              init_params=params, seed=6, data_fn=pfn,
                              steps_per_call=STEPS_PER_CALL, loss_fn=loss_fn, on_step=on_step)
        hist[f"{phw[0]}x{phw[1]}"] = _history(f"active/mix {phw}", history[-1:])
    return {"saved_as": job.saves, "steps": o.steps, "history": hist}, {job.saves: params}


def run_u2(job: Job, o: Options, photos, device, on_step=None) -> tuple[dict, dict]:
    bank = device_bank(photos, RENDER_HW, device)
    model = SaliencyNet(warm_tree(o.ckpt), device=device)
    params, history = fit(model, hw=job.hw, batch=o.batch, steps=o.steps, lr=o.lr,
                          init_params=model.tree(), seed=7,
                          data_fn=mixed_data_fn(bank, THREE_WAY, RENDER_HW),
                          steps_per_call=STEPS_PER_CALL, loss_fn=u2_loss_fn(model),
                          on_step=on_step)
    return ({"saved_as": job.saves, "steps": o.steps, "history": _history("u2/mix", history[-1:])},
            {job.saves: params})


def run_rvm(job: Job, o: Options, photos, device, on_step=None) -> tuple[dict, dict]:
    bank = device_bank(photos, RENDER_HW, device)
    model = RecurrentMatteNet(warm_tree(o.ckpt), device=device)
    loss_fn = rvm_loss_fn(model, mixed_data_fn(bank, TWO_WAY, RENDER_HW), o.batch, job.hw,
                          job.unroll)
    params, history = PV._trainer("rvm/mix", model, loss_fn, o.steps, o.lr, seed=3,
                                  on_step=on_step)
    return {"saved_as": job.saves, "steps": o.steps, "history": history}, {job.saves: params}


def run_multiclass_pico(job: Job, o: Options, photos, device,
                        on_step=None) -> tuple[dict, dict]:
    model = MatteNetHD(10, 4, "pico", params=warm_tree(o.ckpt, float_hd=True), device=device)
    fns = {hw: mixed_data_fn(device_bank(photos, hw, device), CLASS_MIX, hw, classes=True)
           for hw in (job.hw, job.small_hw)}
    hist = {}
    for phw, pbatch, plr, psteps, tag in (
            (job.small_hw, job.small_batch, 3e-4, max(o.steps // 2, MC_MIN_STEPS[0]), "pre"),
            (job.hw, o.batch, o.lr, o.steps, "ft720"),
            (job.small_hw, job.small_batch, 7e-5, max(o.steps // 4, MC_MIN_STEPS[1]), "polish")):
        loss_fn = class_mix_loss_fn(model, fns[phw], pbatch, phw)
        params, hist[tag] = PV._trainer(f"mc_pico/{tag}", model, loss_fn, psteps, plr, seed=3,
                                        on_step=on_step)
    return {"saved_as": job.saves, "steps": o.steps, "history": hist}, {job.saves: params}


RUNS = {"realbg": run_realbg, "flagship": run_flagship, "active": run_active, "u2": run_u2,
        "rvm": run_rvm, "multiclass_pico": run_multiclass_pico}


def run(name: str, photos, out_dir, report_path=None, options: Options | None = None,
        device="cuda", on_step=None) -> tuple[dict, dict]:
    """Run the job ``name`` on the photos under ``photos`` (FileNotFoundError
    where there is none): its trees to ``out_dir/<name>/``
    (utils/checkpoint.py::save_params), its report to ``report_path``
    (default ``out_dir/<job>.json``) -> ``(report, {name: tree})``.
    ``on_step(i, metrics)`` sees every training step's metrics."""
    job = JOBS[name]
    o = dataclasses.replace(options or Options())
    o.steps = job.steps if o.steps is None else o.steps
    o.lr = job.lr if o.lr is None else o.lr
    o.batch = job.batch if o.batch is None else o.batch
    o.ckpt = job.ckpt if o.ckpt is None else o.ckpt
    R.load_background_bank((2, 2), photos, max_images=1)  # refuse a directory of no photo
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    report, trees = RUNS[name](job, o, photos, device, on_step)
    for saved, tree in trees.items():
        save_params(str(out_dir / saved), tree)
        say(f"saved -> {out_dir / saved}")
    report = {"job": name, "photos": str(photos), "trees": sorted(trees), **report}
    path = Path(report_path) if report_path else out_dir / f"{name}.json"
    path.write_text(json.dumps(report, indent=2))
    say(f"wrote {path}")
    return report, trees


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("job", choices=list(JOBS))
    ap.add_argument("steps", type=int, nargs="?", default=None,
                    help="training steps (default: the job's)")
    ap.add_argument("--photos", required=True, help="directory of background photographs")
    ap.add_argument("--out", required=True, help="directory for the trained trees")
    ap.add_argument("--report", default=None, help="JSON report (default OUT/<job>.json)")
    ap.add_argument("--ckpt", default=None, help="the warm start: an export under weights/ "
                    "or a path (default: the job's)")
    ap.add_argument("--real-frac", type=float, default=None, help="flagship: photo share")
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--no-pipe-loss", action="store_true", help="flagship: the matting loss")
    ap.add_argument("--promote", action="store_true", help="flagship: save under --ckpt")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    if a.job != "flagship":
        given = [k for k in FLAGSHIP_ONLY if getattr(a, k) not in (None, False)]
        if given:
            ap.error(f"{', '.join('--' + k.replace('_', '-') for k in given)}: flagship only")
    if a.job == "realbg" and a.ckpt is not None:
        ap.error("--ckpt: realbg trains from the seed")
    return a


def main(argv=None) -> dict:
    a = parse_args(argv)
    opts = Options(steps=a.steps, ckpt=a.ckpt, lr=a.lr, batch=a.batch,
                   real_frac=0.5 if a.real_frac is None else a.real_frac,
                   no_pipe_loss=a.no_pipe_loss, promote=a.promote)
    return run(a.job, a.photos, a.out, a.report, opts, a.device)[0]


if __name__ == "__main__":
    try:
        main()
    except FileNotFoundError as e:
        sys.exit(f"realbg: {e}")
