"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA H100.

Run from the repository root, on a machine with one card:

    python3 chip_smoke.py

Phases, each announced by one line on stdout:
  1. device: the card's name, the device count, nvidia-smi's name and power
     limit;
  2. build: compiles every CUDA source of the port with nvcc (seconds,
     registers, shared memory and spills of each kernel);
  3. kernels: each kernel against its plain PyTorch version at the serving
     shapes (S = 64 streams, 720p frames), with its tolerance, then CUDA-event
     times of both and the kernel's bound on this card;
  4. serve: Engine(64, fast_int8_pico with the face path off) with seeded
     weights answers 8 steps of synthetic 720p frames (a bright ellipse moving
     over noise); checks shapes, dtypes, value ranges, that alpha is not a
     constant, and that each kernel ran once a step.
The last two lines are a JSON object with one entry per kernel and the
result line {"ok": true, "device": {...}}.  Any failure raises and exits
non-zero; without a card it exits non-zero before printing a result.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

S = 64
FRAME_HW = (720, 1280)
SERVE_STEPS = 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak, published
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores, published
TRUNK_TOL = 1e-5  # exact s32 sums, same f32 epilogues, SE in float64 on both sides
PREV_TOL = 2e-5  # new_prev, f32, same operations
REFINED_TOL = 4e-3  # bf16 refined alpha: one bf16 step near 1 plus exp/pow ulps


def say(*parts) -> None:
    print(*parts, flush=True)


def cuda_time_ms(fn, iters: int) -> float:
    """Mean CUDA-event time of ``fn`` over ``iters`` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def trunk_macs(x0_shape, tp) -> int:
    """Multiply-adds of one trunk call, from the shapes (the SE's dense
    layers included)."""
    s, h, w, _ = x0_shape
    total = 0

    def conv(ho, wo, layer):
        cout, kh, kw, cin = layer["w"].shape
        return ho * wo * kh * kw * cin * cout

    h2, w2, h3, w3 = h // 2, w // 2, h // 4, w // 4
    total += conv(h2, w2, tp["d2dn"]) + conv(h2, w2, tp["d2b"])
    total += conv(h3, w3, tp["d3dn"]) + conv(h3, w3, tp["d3b"]) + conv(h3, w3, tp["ctx"])
    total += tp["se"]["k0"].numel() + tp["se"]["k1"].numel()
    total += conv(h3, w3, tp["u2red_up"]) + conv(h2, w2, tp["u2red_skip"])
    total += conv(h2, w2, tp["u1red_up"]) + conv(h, w, tp["u1red_skip"])
    total += conv(h, w, tp["alpha"])
    return s * total


def refine_ops(table, hw) -> int:
    """Float operations the refine does on these inputs, counted per pixel
    and stage from the kernel's code: warp blend (4, where use_warp), EMA
    (10), opening (2 x 9 min/max), closing in the prior (2 x 9 + 2 prior
    evaluations of ~20, where has_prior), bilateral (9 taps x ~20, where on),
    threshold/gamma (~12) and the prior clamps (~24, where has_prior)."""
    from video_stream_segmenetation_tpu_torch.kernels.refine_fused import KNOB_COLUMNS

    col = dict(zip(KNOB_COLUMNS, table.cpu().unbind(1)))
    per_px = (
        4 * (col["use_warp"] > 0).float()
        + 10 + 18 + 12
        + (18 + 40 + 24) * (col["has_prior"] > 0).float()
        + 180 * (col["use_bilateral"] > 0).float()
    )
    return int(per_px.sum().item()) * hw[0] * hw[1]


def bound(bytes_moved: float, ops: float, ops_rate: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_trunk(dev) -> dict:
    from video_stream_segmenetation_tpu_torch.kernels import trunk_int8 as TK
    from video_stream_segmenetation_tpu_torch.models.mattenet_hd import init_pico_params
    from video_stream_segmenetation_tpu_torch.models.quantized import (
        quantize_mattenet_hd,
        trunk_params,
    )

    blk = 10
    hp, wp = FRAME_HW[0] // blk, FRAME_HW[1] // blk
    tp = trunk_params(quantize_mattenet_hd(init_pico_params(0, blk), blk), dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    x0 = torch.randint(0, 128, (S, hp, wp, 128), generator=gen, device=dev,
                       dtype=torch.int32).to(torch.int8)
    got = TK.fused_nano_trunk_alpha(x0, tp)
    want = TK.fused_nano_trunk_alpha_plain(x0, tp)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    say(f"  trunk_int8: logits {tuple(got.shape)} max_abs_err {err:.3e} "
        f"(tolerance {TRUNK_TOL:g}); logits std {want.std().item():.4f}")
    if not math.isfinite(err) or err > TRUNK_TOL:
        raise AssertionError(f"trunk kernel disagrees with its plain version: {err}")
    ms = cuda_time_ms(lambda: TK.fused_nano_trunk_alpha(x0, tp), 10)
    plain_ms = cuda_time_ms(lambda: TK.fused_nano_trunk_alpha_plain(x0, tp), 2)
    macs = trunk_macs(tuple(x0.shape), tp)
    weights = sum(t.numel() * t.element_size() for k, layer in tp.items()
                  for t in layer.values())
    bytes_moved = x0.numel() + weights + got.numel() * 4
    bound_ms, bound_by = bound(bytes_moved, 2 * macs, INT8_OPS_PER_S)
    say(f"  trunk_int8: {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}; {macs / S / 1e9:.3f} G MAC a stream)")
    return {"name": "trunk_int8", "route": "cuda",
            "source": "video_stream_segmenetation_tpu_torch/csrc/trunk_int8.cu",
            "replaces": "video_stream_segmenetation_tpu/kernels/trunk_int8.py:297",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def check_refine(dev) -> dict:
    from video_stream_segmenetation_tpu_torch.kernels import refine_fused as TR
    from video_stream_segmenetation_tpu_torch.ops.warp import separable_warp_indices
    from video_stream_segmenetation_tpu_torch.runtime.config import default_knobs

    h, w = 288, 512
    gen = torch.Generator(device=dev).manual_seed(2)
    alpha = torch.rand((S, h, w), generator=gen, device=dev)
    prev = torch.rand((S, h, w), generator=gen, device=dev)
    guide = torch.randint(0, 256, (S, 3, h, w), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    i = torch.arange(S, device=dev, dtype=torch.float32)
    # non-identity scale + translate, some rows/columns out of range
    affine = torch.stack([1.0 + 0.002 * i, torch.zeros_like(i), 3.0 - 0.5 * i,
                          torch.zeros_like(i), 0.99 + 0.001 * i, -2.0 + 0.25 * i], 1)
    initialized = (torch.arange(S, device=dev) % 4) != 0
    use_warp = ((torch.arange(S, device=dev) % 3) != 0) & initialized
    has_prior = (torch.arange(S, device=dev) % 2) == 0
    prior_params = torch.stack([200.0 + i, 120.0 + 0.5 * i, 60.0 + 0 * i, 80.0 + 0 * i], 1)
    knobs = default_knobs(S, ema_adapt=1.0, device=dev)
    knobs.use_bilateral = (torch.arange(S, device=dev) % 2) == 1
    yi, xi = separable_warp_indices(affine, (h, w))
    table = TR.scalar_table(knobs, use_warp, initialized, 0.3, prior_params, has_prior)
    got_prev, got = TR.fused_temporal_refine(alpha, prev, affine, use_warp, initialized,
                                             0.3, guide, prior_params, has_prior, knobs)
    want_prev, want = TR.fused_temporal_refine_plain(alpha, prev, yi, xi, guide, table)
    torch.cuda.synchronize()
    err_prev = (got_prev - want_prev).abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    say(f"  refine_fused: new_prev max_abs_err {err_prev:.3e} (tolerance {PREV_TOL:g}), "
        f"refined max_abs_err {err:.3e} (tolerance {REFINED_TOL:g}); "
        f"refined mean {want.float().mean().item():.4f}")
    if not (err_prev <= PREV_TOL and err <= REFINED_TOL):
        raise AssertionError(f"refine kernel disagrees with its plain version: "
                             f"{err_prev}, {err}")
    ms = cuda_time_ms(lambda: TR._launch(alpha, prev, yi, xi, guide, table), 20)
    plain_ms = cuda_time_ms(
        lambda: TR.fused_temporal_refine_plain(alpha, prev, yi, xi, guide, table), 3)
    px = S * h * w
    bytes_moved = (px * (4 + 4 + 3 + 4 + 2) + yi.numel() * 4 + xi.numel() * 4
                   + table.numel() * 4)
    bound_ms, bound_by = bound(bytes_moved, refine_ops(table, (h, w)), F32_OPS_PER_S)
    say(f"  refine_fused: {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by})")
    return {"name": "refine_fused", "route": "cuda",
            "source": "video_stream_segmenetation_tpu_torch/csrc/refine_fused.cu",
            "replaces": "video_stream_segmenetation_tpu/kernels/refine_fused.py:752",
            "max_abs_err": max(err, err_prev), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def synthetic_frames(rng, base, t):
    """Noise background with a bright ellipse whose centre moves with t;
    returns (frames, ellipse mask at frame resolution)."""
    fh, fw = FRAME_HW
    yy, xx = np.ogrid[0:fh, 0:fw]
    cx, cy = 520 + 24 * t, 330 + 6 * t
    inside = ((xx - cx) / 190.0) ** 2 + ((yy - cy) / 250.0) ** 2 <= 1.0
    frames = base.copy()
    frames[:, inside] = np.asarray([235, 205, 180], np.uint8)
    return frames, inside


def serve(device, num_streams: int, steps: int) -> dict:
    """Drive the port's Engine; returns per-step times and the last output."""
    from video_stream_segmenetation_tpu_torch.kernels import refine_fused, trunk_int8
    from video_stream_segmenetation_tpu_torch.runtime.presets import preset
    from video_stream_segmenetation_tpu_torch.service.engine import Engine

    statics = preset("fast_int8_pico", face_path=False)
    eng = Engine(num_streams, statics, seed=0, device=device)
    eng.admit_all()
    rng = np.random.default_rng(0)
    fh, fw = FRAME_HW
    grad = np.linspace(0, 255, fw, dtype=np.float32)[None, :, None]
    for s in range(num_streams):
        bg = np.broadcast_to(grad * ((s % 3) + 1) / 3.0, (fh, fw, 3))
        eng.set_background(s, bg.astype(np.uint8))
    base = (rng.random((num_streams, fh, fw, 3)) * 90).astype(np.uint8)
    trunk_int8.fused_nano_trunk_alpha.launches = 0
    refine_fused.fused_temporal_refine.launches = 0
    times, out, inside = [], None, None
    for t in range(steps):
        frames, inside = synthetic_frames(rng, base, t)
        t0 = time.perf_counter()
        out = eng.process(frames)
        if device != "cpu":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {"trunk_int8": trunk_int8.fused_nano_trunk_alpha.launches,
                "refine_fused": refine_fused.fused_temporal_refine.launches}
    mh, mw = statics.mask_hw
    alpha = out["alpha"].float()
    frame = out["frame"]
    if tuple(frame.shape) != (num_streams, fh, fw, 3) or frame.dtype != torch.uint8:
        raise AssertionError(f"frame {tuple(frame.shape)} {frame.dtype}")
    if tuple(alpha.shape) != (num_streams, mh, mw) or out["alpha"].dtype != torch.bfloat16:
        raise AssertionError(f"alpha {tuple(alpha.shape)} {out['alpha'].dtype}")
    if not bool(torch.isfinite(alpha).all()) or alpha.min() < 0 or alpha.max() > 1:
        raise AssertionError("alpha is not finite in [0, 1]")
    iy = (np.arange(mh) * fh) // mh
    ix = (np.arange(mw) * fw) // mw
    mask = torch.as_tensor(inside[np.ix_(iy, ix)], device=alpha.device)
    a_in = alpha[:, mask].mean().item()
    a_out = alpha[:, ~mask].mean().item()
    if abs(a_in - a_out) < 1e-2:
        raise AssertionError(f"alpha inside the ellipse {a_in} ~ outside {a_out}")
    return {"times_ms": times, "launches": launches, "alpha_in": a_in,
            "alpha_out": a_out, "health": eng.stats()["health"]["state"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a card",
              file=sys.stderr, flush=True)
        return 2
    from video_stream_segmenetation_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    say(f"[1/4 device] {name}, device_count={count}, nvidia-smi: {smi}, "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    info = _build.build()
    say(f"[2/4 build] {'built' if info['built'] else 'found'} {info['path']} in "
        f"{info['seconds']:.1f} s (nvcc {info['nvcc']}); kernels: "
        + "; ".join(f"{k}: {v['registers']} regs, {v['smem']} B smem, "
                    f"{v['spill_stores']}/{v['spill_loads']} B spill st/ld"
                    for k, v in info["kernels"].items()))

    say(f"[3/4 kernels] vs plain versions at S={S}, 720p")
    kernels = [check_trunk(dev), check_refine(dev)]
    torch.cuda.empty_cache()

    say(f"[4/4 serve] Engine({S}, fast_int8_pico, face_path=False), {SERVE_STEPS} steps")
    res = serve("cuda", S, SERVE_STEPS)
    for k in kernels:
        k["launches"] = res["launches"][k["name"]]
        if k["launches"] != SERVE_STEPS:
            raise AssertionError(f"{k['name']} launched {k['launches']} times in "
                                 f"{SERVE_STEPS} steps")
    med = statistics.median(res["times_ms"])
    say(f"  serve: median step {med:.2f} ms over {SERVE_STEPS} steps (host clock, "
        f"synchronized; first {res['times_ms'][0]:.1f} ms), launches {res['launches']}, "
        f"alpha inside/outside the ellipse {res['alpha_in']:.4f}/{res['alpha_out']:.4f}, "
        f"health {res['health']}")
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms")
    say(json.dumps({"kernels": [{key: k[key] for key in order} for k in kernels]}))
    say(smi)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # skip interpreter teardown: nothing may print or crash after the last line
    os._exit(rc)
