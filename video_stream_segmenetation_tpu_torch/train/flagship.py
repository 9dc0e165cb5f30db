"""Train the plan-D MatteNetHD decoders on synthetic data and save them as
numpy exports (port of ``tools/train_flagship.py``'s plan-D jobs).

    python -m video_stream_segmenetation_tpu_torch.train.flagship --out DIR \\
        [--steps 600] [--only pico,nano] [--quality PATH] [--device cuda]

Each job pretrains at (240, 320), batch 32, then fine-tunes at the serving
resolution (720, 1280), batch 8, at a third of the learning rate with
``seed=1`` for ``max(steps // 2, 200)`` steps (the reference's schedule:
texture and noise frequencies relative to the stem patch do not transfer
across geometry).  The trained tree goes to ``DIR/<name>.npz``
(bridge.py::save_export; bridge.params_from_jax quantizes it for serving),
the model-only IoU record to ``--quality`` (default ``DIR/QUALITY.json``,
merged into what is there).  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import MatteNetHD
from video_stream_segmenetation_tpu_torch.train.loop import fit

STEM_STRIDE, HEAD_UPSAMPLE = 10, 4
PRETRAIN_HW, PRETRAIN_BATCH = (240, 320), 32
SERVE_HW, SERVE_BATCH = (720, 1280), 8
LR = 5e-4
FT_MIN_STEPS = 200  # fine-tune steps: max(steps // 2, FT_MIN_STEPS)
# the reference's plan-D job names (tools/train_flagship.py)
JOBS = {"micro": "mattenet_hd10_micro", "nano": "mattenet_hd10_nano",
        "pico": "mattenet_hd10_pico", "femto": "mattenet_hd10_femto"}


def say(msg: str) -> None:
    print(msg, flush=True)


def train_job(decoder: str, steps: int, device="cuda") -> tuple[dict, list]:
    """Pretrain and fine-tune one decoder -> (trained tree, fine-tune
    history)."""
    model = MatteNetHD(STEM_STRIDE, HEAD_UPSAMPLE, decoder, device=device)
    name = JOBS[decoder]
    say(f"=== training {name} at {PRETRAIN_HW} ===")
    params, pre = fit(model, hw=PRETRAIN_HW, batch=PRETRAIN_BATCH, steps=steps, lr=LR,
                      log_every=100)
    for rec in pre:
        say(f"[{name}] {json.dumps(rec)}")
    say(f"=== fine-tuning {name} at {SERVE_HW} ===")
    params, ft = fit(model, hw=SERVE_HW, batch=SERVE_BATCH,
                     steps=max(steps // 2, FT_MIN_STEPS), lr=LR / 3, log_every=100,
                     init_params=params, seed=1)
    for rec in ft:
        say(f"[{name}/ft] {json.dumps(rec)}")
    return params, ft


def main(out_dir, steps: int = 600, only=None, quality_path=None, device="cuda") -> dict:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    quality = {}
    for decoder, name in JOBS.items():
        if only and decoder not in only:
            continue
        params, ft = train_job(decoder, steps, device=device)
        path = out_dir / f"{name}.npz"
        bridge.save_export(path, params)
        say(f"[{name}] saved to {path}")
        # model-only IoU at the serving resolution (raw trunk alpha vs the
        # ground truth at the end of training), not the served pipeline's
        quality[name] = {"pretrain_hw": list(PRETRAIN_HW), "serve_hw": list(SERVE_HW),
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
    ap.add_argument("--only", default=None, help=f"comma-separated decoders of {list(JOBS)}")
    ap.add_argument("--quality", default=None, help="quality record (default OUT/QUALITY.json)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.out, a.steps, set(a.only.split(",")) if a.only else None, a.quality, a.device)
