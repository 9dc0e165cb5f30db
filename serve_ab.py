#!/usr/bin/env python3
"""Serving step times, or kernel times, of several checkouts on one card,
to compare two commits in one call.

For each checkout, in the order given and each in processes of its own:
``chip_smoke.py``'s serve phases (``Engine(64, ...)`` at 720p, 8 steps,
the median step on the host clock, synchronized), then ``python3 -m
video_stream_segmenetation_tpu_torch.profile_step --config pico active``
(the step's stages by CUDA events, the wall time by torch.profiler).
With ``--kernels``, instead: ``chip_smoke.py``'s kernel checks of the
trunk (its one-class head, the K=4 heads, the u1-out form), of every form
of the refine body and of plan B's routed 3x3 convs, each held against its
plain version and timed by CUDA events at S=64, then the micro, light and
full (plan B) trunks with their trained weights on the committed frames'
stem output.  Give a parent and a change as ``parent change change
parent`` so that each side's spread shows.

    python3 serve_ab.py [--kernels] --out DIR CHECKOUT [CHECKOUT ...]

Prints the card's name and power limit, one line a phase (or kernel) and
checkout, the profiles' face-subpath, MatteNet and wall lines, and a table
of the medians (or times); each process's whole output goes under
``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

PHASES = """
import json, statistics, sys
sys.path.insert(0, '.')
import torch
import chip_smoke as C
from video_stream_segmenetation_tpu_torch.kernels import _build
_build.build()
for label, name, overrides, trained, _, min_iou, _ in C.PHASES:
    res = C.serve('cuda', C.S, C.SERVE_STEPS, name, overrides, trained, min_iou)
    print('SERVE ' + json.dumps({'phase': label,
                                 'median_ms': statistics.median(res['times_ms']),
                                 'times_ms': res['times_ms']}), flush=True)
    torch.cuda.empty_cache()
"""
KERNELS = """
import json, sys
sys.path.insert(0, '.')
import numpy as np
import torch
import chip_smoke as C
from video_stream_segmenetation_tpu_torch import bridge
from video_stream_segmenetation_tpu_torch.kernels import _build
from video_stream_segmenetation_tpu_torch.models import quantized as Q
from video_stream_segmenetation_tpu_torch.ops.layout import space_to_depth
from video_stream_segmenetation_tpu_torch.runtime.precision import pinned
_build.build()
dev = torch.device('cuda', 0)
times = {}
for check in (C.check_trunk, C.check_u1_trunk, C.check_refine, C.check_refine_plane,
              C.check_fused_refine, C.check_refine_fast, C.check_decoder, C.check_conv):
    got = check(dev)
    for e in got if isinstance(got, list) else [got]:
        times[e['name']] = e['ms']
        for form, ms in e.get('forms_ms', {}).items():
            times[e['name'] + ' ' + form] = ms
    torch.cuda.empty_cache()
clip, _ = bridge.load_frames()
fp = space_to_depth(torch.as_tensor(clip[np.arange(C.S) % 2], device=dev), 10).contiguous()
for plan, export in (('micro', 'mattenet_hd10_micro'), ('light', 'mattenet_hd10_lite'),
                     ('full', 'mattenet_hd10')):
    model = Q.QuantizedMatteNetHD(bridge.load_export(bridge.WEIGHTS_DIR / (export + '.npz')),
                                  10, 1, device=dev)
    with pinned():
        x0 = model.stem(fp)
    times[plan + ' trunk'] = C.cuda_time_ms(lambda: model.trunk_logits(x0), 10)
    del model
print('KERNELS ' + json.dumps(times), flush=True)
"""
PROFILE_KEYS = ("face subpath", "MatteNet", "profiled")


def run(cmd: list[str], cwd: str, log: str, timeout: int) -> str:
    with open(log, "w") as f:
        rc = subprocess.run(cmd, cwd=cwd, stdout=f, stderr=subprocess.STDOUT,
                            timeout=timeout).returncode
    text = open(log).read()
    if rc:
        sys.stdout.write(text[-3000:])
        raise SystemExit(f"serve_ab: {' '.join(cmd[:3])} in {cwd} exited {rc}")
    return text


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkouts", nargs="+")
    ap.add_argument("--kernels", action="store_true",
                    help="kernel times instead of the serve phases and profiles")
    ap.add_argument("--out", required=True, help="directory for each process's output")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    labels = [f"{i}:{os.path.basename(os.path.abspath(c))}" for i, c in
              enumerate(args.checkouts)]
    medians: dict[str, dict[str, float]] = {}
    for label, co in zip(labels, args.checkouts):
        stem = os.path.join(args.out, label.replace(":", "_"))
        if args.kernels:
            text = run([sys.executable, "-c", KERNELS], co, stem + ".kernels.log", 900)
            for line in text.splitlines():
                if line.startswith("KERNELS "):
                    for name, ms in json.loads(line[8:]).items():
                        medians.setdefault(name, {})[label] = ms
                        print(f"{label} {name}: {ms:.4f} ms", flush=True)
            continue
        text = run([sys.executable, "-c", PHASES], co, stem + ".serve.log", 900)
        for line in text.splitlines():
            if line.startswith("SERVE "):
                d = json.loads(line[6:])
                medians.setdefault(d["phase"], {})[label] = d["median_ms"]
                print(f"{label} {d['phase']}: median {d['median_ms']:.2f} ms, steps "
                      f"{[round(t, 1) for t in d['times_ms']]}", flush=True)
        text = run([sys.executable, "-m", "video_stream_segmenetation_tpu_torch.profile_step",
                    "--config", "pico", "active"], co, stem + ".profile.log", 600)
        for line in text.splitlines():
            if any(k in line for k in PROFILE_KEYS):
                print(f"{label} {line.strip()}", flush=True)
    what = "kernel, ms (CUDA events)" if args.kernels else "serve phase, median ms"
    print(f"| {what} | " + " | ".join(labels) + " |")
    print("|---" * (len(labels) + 1) + "|")
    for phase, row in medians.items():
        print(f"| {phase} | " + " | ".join(f"{row[lb]:.4f}" if lb in row else "-"
                                           for lb in labels) + " |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
