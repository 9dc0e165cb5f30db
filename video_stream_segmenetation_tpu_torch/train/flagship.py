"""Train the flagship matting nets on synthetic data and save them as numpy
exports (port of ``tools/train_flagship.py``).

    python -m video_stream_segmenetation_tpu_torch.train.flagship --out DIR \\
        [--steps 600] [--only pico,mattenet_hd10_lite] [--quality PATH] \\
        [--device cuda]

The jobs are the reference's list (``tools/train_flagship.py:32-62``), one
:class:`Job` a row with its geometry and learning rate: the float
MatteNetHD at plan A (``mattenet_hd``, stem stride 5), plan B
(``mattenet_hd10``), plan C (``mattenet_hd10_lite``) and the plan-D
decoders (micro, nano, pico, femto), and the MatteNet (``mattenet``).
Each job pretrains at its pretraining geometry, batch 32, then fine-tunes
at its serving geometry at a third of the learning rate with ``seed=1``
for ``max(steps // 2, 200)`` steps (the reference's schedule: texture and
noise frequencies relative to the stem patch do not transfer across
geometry).  The trained tree goes to ``DIR/<name>.npz``
(bridge.py::save_export; bridge.params_from_jax quantizes a stem-stride-10
tree for the int8 presets), the model-only IoU record to ``--quality``
(default ``DIR/QUALITY.json``, merged into what is there).  ``--only``
takes the jobs' keys or names.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import torch

from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import MatteNetHD
from video_stream_segmenetation_tpu_torch.models.modnet import MatteNet, init_mattenet_params
from video_stream_segmenetation_tpu_torch.train.loop import fit
from video_stream_segmenetation_tpu_torch.train.step import peak_mib, reset_peak

# the plan-D jobs' geometry (the rows below, and the card's train phase)
STEM_STRIDE, HEAD_UPSAMPLE = 10, 4
PRETRAIN_HW, PRETRAIN_BATCH = (240, 320), 32
SERVE_HW, SERVE_BATCH = (720, 1280), 8
LR = 5e-4
FT_MIN_STEPS = 200  # fine-tune steps: max(steps // 2, FT_MIN_STEPS)


@dataclasses.dataclass(frozen=True)
class Job:
    """One row of the reference's job list: the export's name, the model
    (``arch`` 'hd', a MatteNetHD of ``stem_stride``, ``head_upsample`` and
    ``decoder``, or 'mattenet'), the pretraining geometry, batch and
    learning rate, and the serving geometry and batch of the fine-tune."""

    name: str
    arch: str
    stem_stride: int
    head_upsample: int
    decoder: str
    pretrain_hw: tuple[int, int]
    lr: float
    serve_hw: tuple[int, int]
    serve_batch: int
    pretrain_batch: int = PRETRAIN_BATCH

    def model(self, device="cuda", dtype: torch.dtype = torch.bfloat16,
              tree: dict | None = None) -> torch.nn.Module:
        """The job's model holding ``tree`` (None: the seed-0 tree; fit
        loads its own)."""
        if self.arch == "mattenet":
            return MatteNet(init_mattenet_params(0) if tree is None else tree, device=device,
                            dtype=dtype)
        return MatteNetHD(self.stem_stride, self.head_upsample, self.decoder, dtype=dtype,
                          params=tree, device=device)


def _hd(name: str, decoder: str, lr: float = LR, stem_stride: int = STEM_STRIDE,
        head_upsample: int = HEAD_UPSAMPLE) -> Job:
    return Job(name, "hd", stem_stride, head_upsample, decoder, PRETRAIN_HW, lr, SERVE_HW,
               SERVE_BATCH)


# the reference's jobs, in its order: plan A at the MatteNetHD() defaults
# (stem stride 5, x2 head) and its higher rate; the plan-B wide trunk at the
# lower rate (1.5e-3 collapses it to all-background, the reference's note);
# plan C; the plan-D decoders; the MatteNet at its smaller geometry
JOBS = {
    "plan_a": _hd("mattenet_hd", "full", lr=1.5e-3, stem_stride=5, head_upsample=2),
    "full": _hd("mattenet_hd10", "full"),
    "light": _hd("mattenet_hd10_lite", "light"),
    "micro": _hd("mattenet_hd10_micro", "micro"),
    "nano": _hd("mattenet_hd10_nano", "nano"),
    "pico": _hd("mattenet_hd10_pico", "pico"),
    "femto": _hd("mattenet_hd10_femto", "femto"),
    "mattenet": Job("mattenet", "mattenet", 0, 0, "", (96, 160), 1.5e-3, (288, 512), 16),
}


def say(msg: str) -> None:
    print(msg, flush=True)


def train_job(key: str, steps: int, device="cuda") -> tuple[dict, list]:
    """Pretrain and fine-tune one job -> (trained tree, fine-tune history)."""
    job = JOBS[key]
    model = job.model(device)
    ft_steps = max(steps // 2, FT_MIN_STEPS)
    say(f"=== training {job.name} at {job.pretrain_hw} ===")
    reset_peak(device)
    params, pre = fit(model, hw=job.pretrain_hw, batch=job.pretrain_batch, steps=steps,
                      lr=job.lr, log_every=100)
    for rec in pre:
        say(f"[{job.name}] {json.dumps(rec)}")
    _say_cost(job.name, steps, pre, device)
    say(f"=== fine-tuning {job.name} at {job.serve_hw} ===")
    reset_peak(device)
    params, ft = fit(model, hw=job.serve_hw, batch=job.serve_batch, steps=ft_steps,
                     lr=job.lr / 3, log_every=100, init_params=params, seed=1)
    for rec in ft:
        say(f"[{job.name}/ft] {json.dumps(rec)}")
    _say_cost(f"{job.name}/ft", ft_steps, ft, device)
    return params, ft


def _say_cost(name: str, steps: int, history: list, device) -> None:
    """The run's ms a step (host clock to the last record, which reads the
    loss and so waits for the step; the logged evaluations included) and
    the card's peak memory."""
    say(f"[{name}] " + json.dumps({"steps": steps,
                                   "ms_per_step": 1e3 * history[-1]["elapsed_s"] / steps,
                                   "peak_mib": peak_mib(device)}))


def main(out_dir, steps: int = 600, only=None, quality_path=None, device="cuda") -> dict:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    quality = {}
    for key, job in JOBS.items():
        if only and key not in only and job.name not in only:
            continue
        params, ft = train_job(key, steps, device=device)
        path = out_dir / f"{job.name}.npz"
        bridge.save_export(path, params)
        say(f"[{job.name}] saved to {path}")
        # model-only IoU at the serving resolution (raw trunk alpha vs the
        # ground truth at the end of training), not the served pipeline's
        quality[job.name] = {"pretrain_hw": list(job.pretrain_hw),
                             "serve_hw": list(job.serve_hw),
                             "model_only_iou_serving_res": ft[-1]["iou"], "steps": steps}
    qpath = Path(quality_path) if quality_path else out_dir / "QUALITY.json"
    existing = json.loads(qpath.read_text()) if qpath.exists() else {}
    existing.update(quality)
    qpath.write_text(json.dumps(existing, indent=2))
    say(f"quality -> {qpath} {json.dumps(quality)}")
    return quality


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="directory for the .npz exports")
    ap.add_argument("--steps", type=int, default=600, help="pretraining steps")
    ap.add_argument("--only", default=None,
                    help=f"comma-separated jobs, keys of {list(JOBS)} or their names")
    ap.add_argument("--quality", default=None, help="quality record (default OUT/QUALITY.json)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.out, a.steps, set(a.only.split(",")) if a.only else None, a.quality, a.device)
