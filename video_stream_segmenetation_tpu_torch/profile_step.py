"""Where the serving step's time goes on the card.

    python3 -m video_stream_segmenetation_tpu_torch.profile_step [--streams 64]

Builds Engine(S, fast_int8_pico with the face path off) with seeded weights,
warms it up, then
  * times each stage of the step with CUDA events, calling the step's own
    functions on the engine's tensors (frames host->device, s2d pack, model,
    guide, refine kernel, packed composite, unpack), and
  * profiles whole ``Engine.process`` calls with torch.profiler: device time
    by kernel, copies apart from kernels, and the share of the wall time in
    which no kernel runs.
Needs a card; prints the card's name and power limit beside the numbers.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch


def _event_ms(fn, iters=5):
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        out = fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters, out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a card")
    from video_stream_segmenetation_tpu_torch.kernels.refine_fused import fused_temporal_refine
    from video_stream_segmenetation_tpu_torch.ops.layout import (
        alpha_composite_s2d,
        depth_to_space,
        guide_from_s2d,
        space_to_depth,
    )
    from video_stream_segmenetation_tpu_torch.runtime.presets import preset
    from video_stream_segmenetation_tpu_torch.service.engine import Engine

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    s = args.streams
    st = preset("fast_int8_pico", face_path=False)
    eng = Engine(s, st, seed=0)
    eng.admit_all()
    fh, fw = st.frame_hw
    mh, mw = st.mask_hw
    blk = st.s2d_block
    frames = np.random.default_rng(0).integers(0, 256, (s, fh, fw, 3), dtype=np.uint8)
    for _ in range(2):
        eng.process(frames)

    dev = eng.device
    stages = {}
    stages["frames host->device"], ft = _event_ms(lambda: torch.as_tensor(frames, device=dev))
    stages["s2d pack"], fp = _event_ms(lambda: space_to_depth(ft, blk).contiguous())
    stages["model (stem, trunk kernel, upsample)"], mo = _event_ms(lambda: eng.model(fp))
    alpha = mo["alpha"].contiguous()
    stages["planar guide"], guide = _event_ms(
        lambda: guide_from_s2d(fp, (fh, fw), (mh, mw), blk).contiguous())
    zeros4 = torch.zeros((s, 4), device=dev)
    no = torch.zeros((s,), dtype=torch.bool, device=dev)
    stages["refine kernel (+index prep)"], (_, a) = _event_ms(lambda: fused_temporal_refine(
        alpha, eng.state.prev_alpha, eng.state.affine, eng.state.has_affine,
        eng.state.initialized, st.warp_blend_weight, guide, zeros4, no, eng.knobs))
    stages["packed composite"], out = _event_ms(
        lambda: alpha_composite_s2d(fp, a, eng.backgrounds, (fh, fw), blk))
    stages["unpack (depth_to_space)"], _ = _event_ms(lambda: depth_to_space(out, blk))
    total = sum(stages.values())
    print(f"stage times, S={s}, CUDA events, mean of 5 ({smi}):", flush=True)
    for k, v in stages.items():
        print(f"  {k:40s} {v:8.3f} ms  {100 * v / total:5.1f} %")
    print(f"  {'sum':40s} {total:8.3f} ms")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            eng.process(frames)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ka = prof.key_averages()
    busy = {"kernels": 0.0, "memcpy/memset": 0.0}
    for e in ka:
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", 0)
        busy["memcpy/memset" if e.key.startswith(("Memcpy", "Memset")) else "kernels"] += us
    per_step = wall_ms / args.steps
    print(f"profiled {args.steps} Engine.process calls: wall {per_step:.2f} ms a step; "
          + ", ".join(f"{k} {v / 1e3 / args.steps:.2f} ms a step" for k, v in busy.items())
          + f"; SMs idle (no kernel running) {100 - 100 * busy['kernels'] / 1e3 / wall_ms:.1f} %"
          " of the wall time")
    print(ka.table(sort_by="self_device_time_total", row_limit=18, max_name_column_width=60))


if __name__ == "__main__":
    main()
