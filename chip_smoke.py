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
     times of both and the kernel's bound on this card: the pico trunk with
     its one-class head, the trunk with its K=4 head at the pico and the nano
     widths (trained multi-class weights, exact), the fused temporal refine
     (bf16 and f32 refined alpha), the int8 decoder level at micro's u2 and
     u1 levels, the fused 3x3 conv in its four forms (act or not, residual
     or not) at plan B's layer shapes, the u1-out trunk at pico widths, the
     natural layout's fused composite (720p, 288x512 alpha), the
     plane-prior temporal refine and fused_refine (f32 out);
  4-12. serve: Engine(64, ...) answers 8 steps of 720p frames in nine
     phases, each with every launch count set to 0 just before it and read
     just after:
       4. fast_int8_pico with the face path off, seeded weights, synthetic
          frames (a bright ellipse moving over noise);
       5. fast_int8_pico as its preset stands (face path on, fd/lmk 128,
          bf16 refined alpha), the committed trained weights and frames
          (video_stream_segmenetation_tpu_torch/weights/);
       6. fast_int8_micro as its preset stands (fd 256 / lmk 192, f32
          refined alpha), trained weights and the same frames;
       7. multiclass_fast_pico (K=4 classes at the 72x128 head grid, the
          pico trunk) and
       8. multiclass_fast (K=4 upsampled to 288x512, the nano trunk), as
          their presets stand, trained weights, the same frames;
       9. fast_int8 (plan B) and
      10. fast_int8_lite (plan C) as their presets stand (fd 256 / lmk 192,
          f32 refined alpha), trained weights, the same frames;
      11. fast_int8 with int8_conv_impl='pallas' (4 conv kernel launches a
          step);
      12. fast_int8_pico with int8_head_impl='bf16' (the u1-out trunk and
          the bf16 head, no int8-head trunk launch);
     each checks shapes, dtypes, value ranges, the alpha against the frames'
     ground truth (phases 5-12) or the ellipse (phase 4), that each counted
     wrapper ran its expected number of times (every other one none), with
     the face path on that it was applied to at least one stream, in phases
     7-8 that class_alpha sums to 1 within 1e-3, in phases 7-12 that the
     IoU is at most 0.02 below the reference engine's, and in phases 5-12
     that the served trunk equals its plain version on two streams; each
     prints its median step time and the peak device memory.
The last three lines are a JSON object with one entry per kernel, the
card's name and power limit, and the result line {"ok": true, "device":
{...}}.  Any failure raises and exits non-zero; without a card it exits
non-zero before printing a result.
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
TRUNK_K4_TOL = 0  # the K=4 head: the same, held exact
PREV_TOL = 2e-5  # new_prev, f32, same operations
REFINED_TOL = 4e-3  # bf16 refined alpha: one bf16 step near 1 plus exp/pow ulps
REFINED_F32_TOL = 2e-5  # f32 refined alpha: same operations, exp/pow ulps
DECODER_TOL = 0  # s8 out, exact s32 sums, the same f32 epilogue order
CONV_TOL = 0  # s8 out, exact s32 sums, the same f32 epilogue
U1_TOL = 0  # u1 s8: exact s32 sums, the same epilogues, SE in float64 on both sides
COMPOSITE_TOL = 0  # u8 out: f64 row sums, bf16 rows, exact bf16 products, same blend


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


def trunk_macs(x0_shape, tp, head: bool = True) -> int:
    """Multiply-adds of one pico/nano trunk call, from the shapes (the SE's
    dense layers included; the alpha head's with ``head``)."""
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
    if head:
        total += conv(h, w, tp["alpha"])
    return s * total


def weight_bytes(tp) -> int:
    """Bytes of the int8 trunk's weights (the bf16 head's float kernel
    apart)."""
    return sum(t.numel() * t.element_size() for k, layer in tp.items() if k != "alpha_f"
               for t in layer.values())


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


def _trunk_entry(name: str, x0, tp, tol: float) -> dict:
    """The trunk kernel against its plain version on ``x0``, then CUDA-event
    times of both and the bound."""
    from video_stream_segmenetation_tpu_torch.kernels import trunk_int8 as TK
    from video_stream_segmenetation_tpu_torch.models import quantized as Q

    got = TK.fused_nano_trunk_alpha(x0, tp)
    want = Q.xla_trunk_alpha(x0, tp)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item() if got.shape == want.shape else math.inf
    say(f"  {name}: {Q.plan_of(tp)} widths, logits {tuple(got.shape)} max_abs_err "
        f"{err:.3e} (tolerance {tol:g}); logits std {want.std().item():.4f}")
    if not math.isfinite(err) or err > tol:
        raise AssertionError(f"{name}: trunk kernel disagrees with its plain version: {err}")
    ms = cuda_time_ms(lambda: TK.fused_nano_trunk_alpha(x0, tp), 10)
    plain_ms = cuda_time_ms(lambda: Q.xla_trunk_alpha(x0, tp), 2)
    macs = trunk_macs(tuple(x0.shape), tp)
    bytes_moved = x0.numel() + weight_bytes(tp) + got.numel() * 4
    bound_ms, bound_by = bound(bytes_moved, 2 * macs, INT8_OPS_PER_S)
    say(f"  {name}: {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}; {macs / S / 1e9:.3f} G MAC a stream)")
    return {"name": name, "route": "cuda",
            "source": "video_stream_segmenetation_tpu_torch/csrc/trunk_int8.cu",
            "replaces": "video_stream_segmenetation_tpu/kernels/trunk_int8.py:297",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def check_trunk(dev) -> list[dict]:
    """The trunk kernel at S=64, 720p: the one-class head at the pico
    widths (seeded weights, random s8 stem output), then the K=4 head at
    the pico and the nano widths with the trained multi-class weights on
    the stem output of the committed frames."""
    from video_stream_segmenetation_tpu_torch import bridge
    from video_stream_segmenetation_tpu_torch.models import quantized as Q
    from video_stream_segmenetation_tpu_torch.models.mattenet_hd import init_pico_params
    from video_stream_segmenetation_tpu_torch.ops.layout import space_to_depth
    from video_stream_segmenetation_tpu_torch.runtime.precision import pinned

    blk = 10
    hp, wp = FRAME_HW[0] // blk, FRAME_HW[1] // blk
    tp = Q.trunk_params(Q.quantize_mattenet_hd(init_pico_params(0, blk), blk), dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    x0 = torch.randint(0, 128, (S, hp, wp, 128), generator=gen, device=dev,
                       dtype=torch.int32).to(torch.int8)
    entries = [_trunk_entry("trunk_int8", x0, tp, TRUNK_TOL)]
    clip, _ = bridge.load_frames()
    frames_p = space_to_depth(torch.as_tensor(clip[np.arange(S) % 2], device=dev),
                              blk).contiguous()
    for name, export in (("trunk_int8_k4_pico", "mattenet_hd10_mc_pico"),
                         ("trunk_int8_k4_nano", "mattenet_hd10_mc")):
        model = Q.QuantizedMatteNetHD(bridge.load_export(bridge.WEIGHTS_DIR / f"{export}.npz"),
                                      blk, 1, device=dev)
        with pinned():
            x0 = model.stem(frames_p)
        entries.append(_trunk_entry(name, x0, model.trunk, TRUNK_K4_TOL))
        del model
    return entries


def _refine_inputs(dev, seed):
    """Seeded refine inputs at S=64, 288x512: alpha, prev, the planar u8
    guide, a scale-and-translate affine per stream (some rows and columns
    out of range), flags mixed over the streams, the knobs."""
    from video_stream_segmenetation_tpu_torch.runtime.config import default_knobs

    h, w = 288, 512
    gen = torch.Generator(device=dev).manual_seed(seed)
    alpha = torch.rand((S, h, w), generator=gen, device=dev)
    prev = torch.rand((S, h, w), generator=gen, device=dev)
    guide = torch.randint(0, 256, (S, 3, h, w), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    i = torch.arange(S, device=dev, dtype=torch.float32)
    affine = torch.stack([1.0 + 0.002 * i, torch.zeros_like(i), 3.0 - 0.5 * i,
                          torch.zeros_like(i), 0.99 + 0.001 * i, -2.0 + 0.25 * i], 1)
    initialized = (torch.arange(S, device=dev) % 4) != 0
    use_warp = ((torch.arange(S, device=dev) % 3) != 0) & initialized
    has_prior = (torch.arange(S, device=dev) % 2) == 0
    prior_params = torch.stack([200.0 + i, 120.0 + 0.5 * i, 60.0 + 0 * i, 80.0 + 0 * i], 1)
    knobs = default_knobs(S, ema_adapt=1.0, device=dev)
    knobs.use_bilateral = (torch.arange(S, device=dev) % 2) == 1
    return alpha, prev, guide, affine, initialized, use_warp, has_prior, prior_params, knobs


def check_refine(dev) -> dict:
    from video_stream_segmenetation_tpu_torch.kernels import refine_fused as TR
    from video_stream_segmenetation_tpu_torch.ops.warp import separable_warp_indices

    (alpha, prev, guide, affine, initialized, use_warp, has_prior, prior_params,
     knobs) = _refine_inputs(dev, 2)
    h, w = alpha.shape[-2:]
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

    # the f32 refined alpha (refined_dtype='f32', the micro preset)
    f32 = torch.float32
    got_prev, got = TR.fused_temporal_refine(alpha, prev, affine, use_warp, initialized,
                                             0.3, guide, prior_params, has_prior, knobs,
                                             out_dtype=f32)
    want_prev, want = TR.fused_temporal_refine_plain(alpha, prev, yi, xi, guide, table, f32)
    torch.cuda.synchronize()
    err32_prev = (got_prev - want_prev).abs().max().item()
    err32 = (got - want).abs().max().item()
    say(f"  refine_fused f32: new_prev max_abs_err {err32_prev:.3e} (tolerance "
        f"{PREV_TOL:g}), refined {got.dtype} max_abs_err {err32:.3e} (tolerance "
        f"{REFINED_F32_TOL:g})")
    if got.dtype != f32 or not (err32_prev <= PREV_TOL and err32 <= REFINED_F32_TOL):
        raise AssertionError(f"f32 refine kernel disagrees with its plain version: "
                             f"{err32_prev}, {err32}")
    ms32 = cuda_time_ms(lambda: TR._launch(alpha, prev, yi, xi, guide, table, f32), 20)
    plain32 = cuda_time_ms(
        lambda: TR.fused_temporal_refine_plain(alpha, prev, yi, xi, guide, table, f32), 3)
    bound32, by32 = bound(bytes_moved + 2 * px, refine_ops(table, (h, w)), F32_OPS_PER_S)
    say(f"  refine_fused f32: {ms32:.3f} ms, plain {plain32:.3f} ms, bound "
        f"{bound32:.4f} ms ({by32})")
    return {"name": "refine_fused", "route": "cuda",
            "source": "video_stream_segmenetation_tpu_torch/csrc/refine_fused.cu",
            "replaces": "video_stream_segmenetation_tpu/kernels/refine_fused.py:752",
            "max_abs_err": max(err, err_prev, err32, err32_prev), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def check_decoder(dev) -> dict:
    """The int8 decoder level at micro's two levels (720p, S=64), trained
    micro weights, s8 activations on the relu6 lattice."""
    from video_stream_segmenetation_tpu_torch import bridge
    from video_stream_segmenetation_tpu_torch.kernels import decoder_int8 as DK
    from video_stream_segmenetation_tpu_torch.models import quantized as Q

    tp = Q.trunk_params(bridge.load_export(bridge.WEIGHTS_DIR / "mattenet_hd10_micro.npz"),
                      dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    hp, wp = FRAME_HW[0] // 10, FRAME_HW[1] // 10
    total = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "macs": 0, "err": 0.0}
    for level, (sh, sw), (ca, cb) in (("u2", (hp // 4, wp // 4), (256, 192)),
                                      ("u1", (hp // 2, wp // 2), (192, 128))):
        up, skip_l = tp[f"{level}red_up"], tp[f"{level}red_skip"]
        small = torch.randint(0, 128, (S, sh, sw, ca), generator=gen, device=dev,
                              dtype=torch.int32).to(torch.int8)
        skip = torch.randint(0, 128, (S, 2 * sh, 2 * sw, cb), generator=gen, device=dev,
                             dtype=torch.int32).to(torch.int8)
        got = DK.fused_decoder_level(small, skip, up, skip_l)
        want = Q.split_conv_up(small, skip, up, skip_l)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        hist = torch.bincount(want.flatten().to(torch.int64), minlength=128)
        say(f"  decoder_int8 {level}: small {tuple(small.shape)} skip {tuple(skip.shape)} "
            f"-> {tuple(got.shape)} max_abs_err {err:g} (tolerance {DECODER_TOL}); "
            f"out at 0: {hist[0].item() / want.numel():.3f}, at 127: "
            f"{hist[127].item() / want.numel():.3f}")
        if got.dtype != torch.int8 or err > DECODER_TOL:
            raise AssertionError(f"decoder kernel disagrees with its plain version at "
                                 f"{level}: {err}")
        ms = cuda_time_ms(lambda: DK.fused_decoder_level(small, skip, up, skip_l), 20)
        plain_ms = cuda_time_ms(
            lambda: Q.split_conv_up(small, skip, up, skip_l), 3)
        cout = up["w"].shape[0]
        bytes_moved = (small.numel() + skip.numel() + got.numel() + up["w"].numel()
                       + skip_l["w"].numel() + 8 * cout)
        macs = (small.numel() + skip.numel()) * cout
        b_ms, b_by = bound(bytes_moved, 2 * macs, INT8_OPS_PER_S)
        say(f"  decoder_int8 {level}: {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}; {bytes_moved / 1e6:.1f} MB, {macs / 1e9:.2f} G MAC)")
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bytes", bytes_moved),
                     ("macs", macs)):
            total[k] += v
        total["err"] = max(total["err"], err)
    bound_ms, bound_by = bound(total["bytes"], 2 * total["macs"], INT8_OPS_PER_S)
    say(f"  decoder_int8 both levels: {total['ms']:.4f} ms, plain {total['plain_ms']:.3f} ms,"
        f" bound {bound_ms:.4f} ms ({bound_by})")
    return {"name": "decoder_int8", "route": "cuda",
            "source": "video_stream_segmenetation_tpu_torch/csrc/decoder_int8.cu",
            "replaces": "video_stream_segmenetation_tpu/kernels/decoder_int8.py:100",
            "max_abs_err": total["err"], "ms": total["ms"], "plain_ms": total["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


# plan B's 3x3 stride-1 layers at S=64, 720p: (name, the stem-grid shift
# of its grid, dilation, routed by int8_conv_impl='pallas'); ctx4 (no act
# in the trunk, dilation 4) is checked in the kernel's four forms only
CONV_LAYERS = (("b1/c0", 0, 1, True), ("d2b/c0", 1, 1, True), ("d3b/c0", 2, 1, True),
               ("ctx2", 2, 2, True), ("ctx4", 2, 4, False))


def check_conv(dev) -> dict:
    """conv3x3_i8_fused against its plain version in its four forms (act
    or not, residual or not) at plan B's layers with the trained weights:
    72x128x128 (b1), 36x64x192 (d2b), 18x32x256 (d3b; ctx2 at dilation 2,
    ctx4 at 4), s8 activations on the relu6 lattice.  Times and bound are
    those of the four layers the 'pallas' route serves, in their served
    form (act, no residual)."""
    from video_stream_segmenetation_tpu_torch import bridge
    from video_stream_segmenetation_tpu_torch.kernels import conv_int8 as TC
    from video_stream_segmenetation_tpu_torch.models import quantized as Q

    tp = Q.trunk_params(bridge.load_export(bridge.WEIGHTS_DIR / "mattenet_hd10.npz"), dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    hp, wp = FRAME_HW[0] // 10, FRAME_HW[1] // 10
    total = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "macs": 0, "err": 0.0}
    for name, shift, dil, routed in CONV_LAYERS:
        pfx, _, sub = name.partition("/")
        layer = tp[pfx][sub] if sub else tp[pfx]
        wq = layer["w"].permute(1, 2, 3, 0).contiguous()
        cout, cin = wq.shape[-1], wq.shape[2]
        grid = (hp >> shift, wp >> shift)
        x = torch.randint(0, 128, (S, *grid, cin), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.int8)
        res = torch.randint(0, 128, (S, *grid, cout), generator=gen, device=dev,
                            dtype=torch.int32).to(torch.int8)
        errs = []
        for r in (None, res):
            for act in (True, False):
                args = (x, wq, layer["mult"], layer["bias"], r, act, dil)
                got = TC.conv3x3_i8_fused(*args)
                want = TC.conv3x3_i8_plain(*args)
                torch.cuda.synchronize()
                errs.append((got.int() - want.int()).abs().max().item()
                            if got.dtype == want.dtype == torch.int8 else math.inf)
        err = max(errs)
        say(f"  conv3x3_i8_fused {name}: x {tuple(x.shape)} -> {cout} channels, dilation "
            f"{dil}; max_abs_err over the four forms {err:g} (tolerance {CONV_TOL})")
        if err > CONV_TOL:
            raise AssertionError(f"conv kernel disagrees with its plain version at {name}: "
                                 f"{errs}")
        total["err"] = max(total["err"], err)
        if not routed:
            continue
        ms = cuda_time_ms(lambda: TC.conv3x3_i8_fused(x, wq, layer["mult"], layer["bias"],
                                                      dilation=dil), 10)
        plain_ms = cuda_time_ms(lambda: TC.conv3x3_i8_plain(x, wq, layer["mult"],
                                                            layer["bias"], dilation=dil), 2)
        macs = x.numel() * 9 * cout
        bytes_moved = x.numel() + x.numel() // cin * cout + wq.numel() + 8 * cout
        b_ms, b_by = bound(bytes_moved, 2 * macs, INT8_OPS_PER_S)
        say(f"  conv3x3_i8_fused {name}: {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}; {macs / 1e9:.2f} G MAC, {bytes_moved / 1e6:.1f} MB)")
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bytes", bytes_moved),
                     ("macs", macs)):
            total[k] += v
    bound_ms, bound_by = bound(total["bytes"], 2 * total["macs"], INT8_OPS_PER_S)
    say(f"  conv3x3_i8_fused, plan B's four routed layers: {total['ms']:.4f} ms, plain "
        f"{total['plain_ms']:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return {"name": "conv3x3_i8_fused", "route": "cuda",
            "source": "video_stream_segmenetation_tpu_torch/csrc/conv_int8.cu",
            "replaces": "video_stream_segmenetation_tpu/kernels/conv_int8.py:116",
            "max_abs_err": total["err"], "ms": total["ms"], "plain_ms": total["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def check_u1_trunk(dev) -> dict:
    """The trunk kernel's u1-out form (fused_nano_trunk) at the pico widths,
    S=64, 720p (seeded weights, random s8 stem output): u1 s8 against the
    plain trunk's, then times and the bound."""
    from video_stream_segmenetation_tpu_torch.kernels import trunk_int8 as TK
    from video_stream_segmenetation_tpu_torch.models import quantized as Q
    from video_stream_segmenetation_tpu_torch.models.mattenet_hd import init_pico_params

    blk = 10
    tp = Q.trunk_params(Q.quantize_mattenet_hd(init_pico_params(0, blk), blk), dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    x0 = torch.randint(0, 128, (S, FRAME_HW[0] // blk, FRAME_HW[1] // blk, 128),
                       generator=gen, device=dev, dtype=torch.int32).to(torch.int8)
    got = TK.fused_nano_trunk(x0, tp)
    want = Q.xla_trunk(x0, tp)
    torch.cuda.synchronize()
    err = ((got.int() - want.int()).abs().max().item()
           if got.shape == want.shape and got.dtype == torch.int8 else math.inf)
    hist = torch.bincount(want.flatten().to(torch.int64), minlength=128)
    say(f"  trunk_int8_u1: u1 {tuple(got.shape)} {got.dtype} max_abs_err {err:g} "
        f"(tolerance {U1_TOL}); u1 at 0: {hist[0].item() / want.numel():.3f}, at 127: "
        f"{hist[127].item() / want.numel():.3f}")
    if err > U1_TOL:
        raise AssertionError(f"u1-out trunk disagrees with its plain version: {err}")
    ms = cuda_time_ms(lambda: TK.fused_nano_trunk(x0, tp), 10)
    plain_ms = cuda_time_ms(lambda: Q.xla_trunk(x0, tp), 2)
    macs = trunk_macs(tuple(x0.shape), tp, head=False)
    bytes_moved = x0.numel() + weight_bytes(tp) + got.numel()
    bound_ms, bound_by = bound(bytes_moved, 2 * macs, INT8_OPS_PER_S)
    say(f"  trunk_int8_u1: {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}; {macs / S / 1e9:.3f} G MAC a stream)")
    return {"name": "trunk_int8_u1", "route": "cuda",
            "source": "video_stream_segmenetation_tpu_torch/csrc/trunk_int8.cu",
            "replaces": "video_stream_segmenetation_tpu/kernels/trunk_int8.py:297",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def check_refine_plane(dev) -> dict:
    """The plane-prior form of the temporal refine (prior_impl='plane'), f32
    refined alpha as active serves it: the prior plane rendered from the
    same scalars, zero where a stream has none."""
    from video_stream_segmenetation_tpu_torch.kernels import refine_fused as TR
    from video_stream_segmenetation_tpu_torch.ops.prior import prior_plane_from_params
    from video_stream_segmenetation_tpu_torch.ops.warp import separable_warp_indices

    (alpha, prev, guide, affine, initialized, use_warp, has_prior, prior_params,
     knobs) = _refine_inputs(dev, 6)
    h, w = alpha.shape[-2:]
    plane = torch.where(has_prior[:, None, None], prior_plane_from_params(prior_params, (h, w)),
                        torch.zeros((), device=dev)).contiguous()
    f32 = torch.float32
    yi, xi = separable_warp_indices(affine, (h, w))
    table = TR.scalar_table(knobs, use_warp, initialized, 0.3, torch.zeros_like(prior_params),
                            has_prior)
    got_prev, got = TR.fused_temporal_refine_plane(alpha, prev, affine, use_warp, initialized,
                                                   0.3, guide, plane, has_prior, knobs,
                                                   out_dtype=f32)
    want_prev, want = TR.fused_temporal_refine_plain(alpha, prev, yi, xi, guide, table, f32,
                                                     plane)
    torch.cuda.synchronize()
    err_prev = (got_prev - want_prev).abs().max().item()
    err = (got - want).abs().max().item()
    say(f"  refine_fused_plane: new_prev max_abs_err {err_prev:.3e} (tolerance {PREV_TOL:g}), "
        f"refined {got.dtype} max_abs_err {err:.3e} (tolerance {REFINED_F32_TOL:g}); refined "
        f"mean {want.mean().item():.4f}")
    if got.dtype != f32 or not (err_prev <= PREV_TOL and err <= REFINED_F32_TOL):
        raise AssertionError(f"plane-prior refine kernel disagrees with its plain version: "
                             f"{err_prev}, {err}")
    ms = cuda_time_ms(lambda: TR._launch(alpha, prev, yi, xi, guide, table, f32, plane), 20)
    plain_ms = cuda_time_ms(lambda: TR.fused_temporal_refine_plain(
        alpha, prev, yi, xi, guide, table, f32, plane), 3)
    px = S * h * w
    bytes_moved = (px * (4 + 4 + 3 + 4 + 4 + 4) + yi.numel() * 4 + xi.numel() * 4
                   + table.numel() * 4)
    bound_ms, bound_by = bound(bytes_moved, refine_ops(table, (h, w)), F32_OPS_PER_S)
    say(f"  refine_fused_plane: {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}; {bytes_moved / px:.1f} B a pixel)")
    return {"name": "refine_fused_plane", "route": "cuda",
            "source": "video_stream_segmenetation_tpu_torch/csrc/refine_fused.cu",
            "replaces": "video_stream_segmenetation_tpu/kernels/refine_fused.py:207",
            "max_abs_err": max(err, err_prev), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def check_fused_refine(dev) -> dict:
    """fused_refine (stages 5/7/8/9 on an alpha already warped and smoothed,
    the prior plane, f32 out), as warp_impl='exact' serves it."""
    from video_stream_segmenetation_tpu_torch.kernels import refine_fused as TR
    from video_stream_segmenetation_tpu_torch.ops.prior import prior_plane_from_params

    alpha, _, guide, _, _, _, has_prior, prior_params, knobs = _refine_inputs(dev, 7)
    h, w = alpha.shape[-2:]
    plane = torch.where(has_prior[:, None, None], prior_plane_from_params(prior_params, (h, w)),
                        torch.zeros((), device=dev)).contiguous()
    table = TR.refine_table(knobs, has_prior)
    got = TR.fused_refine(alpha, guide, plane, has_prior, knobs)
    want = TR.fused_refine_plain(alpha, guide, plane, table)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    say(f"  fused_refine: refined {got.dtype} max_abs_err {err:.3e} (tolerance "
        f"{REFINED_F32_TOL:g}); refined mean {want.mean().item():.4f}")
    if got.dtype != torch.float32 or not err <= REFINED_F32_TOL:
        raise AssertionError(f"fused_refine kernel disagrees with its plain version: {err}")
    ms = cuda_time_ms(lambda: TR.fused_refine(alpha, guide, plane, has_prior, knobs), 20)
    plain_ms = cuda_time_ms(lambda: TR.fused_refine_plain(alpha, guide, plane, table), 3)
    px = S * h * w
    bytes_moved = px * (4 + 3 + 4 + 4) + table.numel() * 4
    # without the EMA's 10 operations a pixel (the warp's are off in this
    # table)
    ops = refine_ops(table, (h, w)) - 10 * px
    bound_ms, bound_by = bound(bytes_moved, ops, F32_OPS_PER_S)
    say(f"  fused_refine: {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}; {bytes_moved / px:.1f} B a pixel)")
    return {"name": "fused_refine", "route": "cuda",
            "source": "video_stream_segmenetation_tpu_torch/csrc/refine_fused.cu",
            "replaces": "video_stream_segmenetation_tpu/kernels/refine_fused.py:522",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def check_composite(dev) -> dict:
    """The natural layout's fused composite at S=64, 720p, a 288x512 alpha
    (random, with rows of 0 and 1), random frames and backgrounds, against
    its plain version (the matrix form, TF32 off)."""
    from video_stream_segmenetation_tpu_torch.kernels import composite_fused as KC
    from video_stream_segmenetation_tpu_torch.runtime.precision import pinned

    fh, fw = FRAME_HW
    mh, mw = 288, 512
    gen = torch.Generator(device=dev).manual_seed(8)
    frames = torch.randint(0, 256, (S, fh, fw, 3), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.uint8)
    bg = torch.randint(0, 256, (S, fh, fw, 3), generator=gen, device=dev,
                       dtype=torch.int32).to(torch.uint8)
    alpha = torch.rand((S, mh, mw), generator=gen, device=dev)
    alpha[::3, :40] = 0.0
    alpha[1::3, -40:] = 1.0
    got = KC.fused_composite(frames, alpha, bg)
    with pinned():
        want = KC.fused_composite_plain(frames, alpha, bg)
    torch.cuda.synchronize()
    diff = (got.int() - want.int()).abs()
    err = diff.max().item()
    say(f"  composite_fused: frames {tuple(frames.shape)} alpha {tuple(alpha.shape)} "
        f"max_abs_err {err} u8 steps (tolerance {COMPOSITE_TOL}), values apart "
        f"{(diff > 0).sum().item()}")
    if got.dtype != torch.uint8 or err > COMPOSITE_TOL:
        raise AssertionError(f"composite kernel disagrees with its plain version: {err}")
    ms = cuda_time_ms(lambda: KC.fused_composite(frames, alpha, bg), 20)
    with pinned():
        plain_ms = cuda_time_ms(lambda: KC.fused_composite_plain(frames, alpha, bg), 3)
    bytes_moved = 3 * frames.numel() + 4 * alpha.numel()
    # a pixel: two vertical taps (f64) of its row value, two horizontal
    # taps, the clip, and per channel the blend and the rounding (~6)
    ops = S * fh * (mw * 3 + fw * (5 + 3 * 6))
    bound_ms, bound_by = bound(bytes_moved, ops, F32_OPS_PER_S)
    say(f"  composite_fused: {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}; {bytes_moved / 1e6:.1f} MB)")
    return {"name": "composite_fused", "route": "cuda",
            "source": "video_stream_segmenetation_tpu_torch/csrc/composite_fused.cu",
            "replaces": "video_stream_segmenetation_tpu/kernels/composite_fused.py:84",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


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


# The reference engine's IoU on the committed frames at 720p, the least
# over its steps, from its JAX Engine on the CPU: the foreground (1 -
# class_alpha[..., 0] > 0.5) of the multi-class presets
# (tests/test_torch_multiclass.py::test_trained_engine_free_running_iou),
# the alpha > 0.5 of plans B and C and of pico with the bf16 head
# (tests/test_torch_plans_720p.py::test_trained_engine_iou_720p); a phase fails
# more than IOU_SLACK below it.  int8_conv_impl='pallas' computes what
# 'xla' does (tests/test_torch_plans.py), so it has fast_int8's bar.
REFERENCE_IOU = {"multiclass_fast_pico": 0.6403, "multiclass_fast": 0.4980,
                 "fast_int8": 0.6216, "fast_int8_lite": 0.5755,
                 "fast_int8_pico_bf16_head": 0.8524,
                 # tests/test_torch_active_720p.py, 8 steps: the separable-warp
                 # routes (the plane prior and the composites give its alpha)
                 # and the exact warp
                 "active": 0.5460, "active_exact_warp": 0.5429}
IOU_SLACK = 0.02

# serve phases: (label, preset, overrides, trained weights and frames,
# launches a step of each counted wrapper that runs (every other one must
# not), the least IoU of the served alpha > 0.5 (multi-class: the
# foreground) against the frames' ground truth, the kernel entry the
# trunk_int8 counter's launches go to).  The trained micro checkpoint
# finds little of this person (served IoU about 0.23 on the card, 0.25
# from the reference's own engine on the CPU, tests/test_torch_micro.py),
# so micro's IoU is printed, not held to a floor; its served trunk is held
# to its plain version instead, as every trained phase's is.
PHASES = (
    ("fast_int8_pico, face_path=False", "fast_int8_pico", {"face_path": False}, False,
     {"trunk_int8": 1, "refine_fused": 1}, None, "trunk_int8"),
    ("fast_int8_pico", "fast_int8_pico", {}, True,
     {"trunk_int8": 1, "refine_fused": 1}, 0.5, "trunk_int8"),
    ("fast_int8_micro", "fast_int8_micro", {}, True,
     {"micro_trunk": 1, "refine_fused": 1, "decoder_int8": 2}, None, None),
    ("multiclass_fast_pico", "multiclass_fast_pico", {}, True, {"trunk_int8": 1},
     REFERENCE_IOU["multiclass_fast_pico"] - IOU_SLACK, "trunk_int8_k4_pico"),
    ("multiclass_fast", "multiclass_fast", {}, True, {"trunk_int8": 1},
     REFERENCE_IOU["multiclass_fast"] - IOU_SLACK, "trunk_int8_k4_nano"),
    ("fast_int8", "fast_int8", {}, True, {"full_trunk": 1, "refine_fused": 1},
     REFERENCE_IOU["fast_int8"] - IOU_SLACK, None),
    ("fast_int8_lite", "fast_int8_lite", {}, True,
     {"light_trunk": 1, "refine_fused": 1, "decoder_int8": 2},
     REFERENCE_IOU["fast_int8_lite"] - IOU_SLACK, None),
    ("fast_int8, int8_conv_impl='pallas'", "fast_int8", {"int8_conv_impl": "pallas"}, True,
     {"full_trunk": 1, "refine_fused": 1, "conv3x3_i8_fused": 4},
     REFERENCE_IOU["fast_int8"] - IOU_SLACK, None),
    ("fast_int8_pico, int8_head_impl='bf16'", "fast_int8_pico", {"int8_head_impl": "bf16"},
     True, {"trunk_int8_u1": 1, "refine_fused": 1},
     REFERENCE_IOU["fast_int8_pico_bf16_head"] - IOU_SLACK, None),
    ("active", "active", {}, True, {"refine_fused": 1},
     REFERENCE_IOU["active"] - IOU_SLACK, None),
    ("active, use_fused_composite=True", "active", {"use_fused_composite": True}, True,
     {"refine_fused": 1, "composite_fused": 1}, REFERENCE_IOU["active"] - IOU_SLACK, None),
    ("active, prior_impl='plane'", "active", {"prior_impl": "plane"}, True,
     {"refine_fused_plane": 1}, REFERENCE_IOU["active"] - IOU_SLACK, None),
    ("active, warp_impl='exact'", "active", {"warp_impl": "exact"}, True,
     {"fused_refine": 1}, REFERENCE_IOU["active_exact_warp"] - IOU_SLACK, None),
)


def _counters():
    from video_stream_segmenetation_tpu_torch.kernels import (
        composite_fused,
        conv_int8,
        decoder_int8,
        refine_fused,
        trunk_int8,
    )

    return {"trunk_int8": trunk_int8.fused_nano_trunk_alpha,
            "trunk_int8_u1": trunk_int8.fused_nano_trunk,
            "micro_trunk": trunk_int8.micro_trunk_alpha,
            "full_trunk": trunk_int8.full_trunk_alpha,
            "light_trunk": trunk_int8.light_trunk_alpha,
            "refine_fused": refine_fused.fused_temporal_refine,
            "refine_fused_plane": refine_fused.fused_temporal_refine_plane,
            "fused_refine": refine_fused.fused_refine,
            "composite_fused": composite_fused.fused_composite,
            "decoder_int8": decoder_int8.fused_decoder_level,
            "conv3x3_i8_fused": conv_int8.conv3x3_i8_fused}


def serve(device, num_streams: int, steps: int, name: str = "fast_int8_pico",
          overrides=None, trained: bool = False, min_iou=None) -> dict:
    """Drive the port's Engine for ``steps`` steps; returns per-step times,
    the launch counts of the run, face and quality figures.  With trained
    weights it then holds the served trunk against its plain version on
    the last frames of two streams (trained weights, the card's inputs)."""
    from video_stream_segmenetation_tpu_torch import bridge
    from video_stream_segmenetation_tpu_torch.runtime.presets import preset
    from video_stream_segmenetation_tpu_torch.service.engine import Engine

    statics = preset(name, **(overrides or {}))
    multiclass = statics.num_classes > 1
    fh, fw = FRAME_HW
    mh, mw = statics.mask_hw
    rng = np.random.default_rng(0)
    if trained:
        eng = Engine(num_streams, statics, **bridge.trained_weights(statics), device=device)
        clip, gt = bridge.load_frames()
        order = [np.arange(num_streams) % 2, (np.arange(num_streams) + 1) % 2]
        batches = [(clip[o], gt[o] > 127) for o in order]
    else:
        eng = Engine(num_streams, statics, seed=0, device=device)
        base = (rng.random((num_streams, fh, fw, 3)) * 90).astype(np.uint8)
    eng.admit_all()
    grad = np.linspace(0, 255, fw, dtype=np.float32)[None, :, None]
    for s in range(num_streams):
        bg = np.broadcast_to(grad * ((s % 3) + 1) / 3.0, (fh, fw, 3))
        eng.set_background(s, bg.astype(np.uint8))
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    times, out, truth = [], None, None
    applied = np.zeros((num_streams,), bool)
    scores = []
    for t in range(steps):
        if trained:
            frames, truth = batches[t % 2]
        else:
            frames, inside = synthetic_frames(rng, base, t)
        t0 = time.perf_counter()
        out = eng.process(frames)
        if device != "cpu":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        applied |= out["face_applied"].cpu().numpy()
        ds = out["det_score"].cpu().numpy()
        scores.extend(ds[ds > 0].tolist())
    launches = {k: c.launches for k, c in counters.items()}
    alpha = out["alpha"].float()
    want_dtype = (torch.bfloat16 if statics.refined_dtype == "bf16" and not multiclass
                  else torch.float32)
    frame = out["frame"]
    if tuple(frame.shape) != (num_streams, fh, fw, 3) or frame.dtype != torch.uint8:
        raise AssertionError(f"frame {tuple(frame.shape)} {frame.dtype}")
    if tuple(alpha.shape) != (num_streams, mh, mw) or out["alpha"].dtype != want_dtype:
        raise AssertionError(f"alpha {tuple(alpha.shape)} {out['alpha'].dtype}")
    if not bool(torch.isfinite(alpha).all()) or alpha.min() < 0 or alpha.max() > 1:
        raise AssertionError("alpha is not finite in [0, 1]")
    res = {"times_ms": times, "launches": launches, "health":
           eng.stats()["health"]["state"], "applied": int(applied.sum()),
           "det_score": float(np.mean(scores)) if scores else 0.0,
           "peak_mib": (torch.cuda.max_memory_allocated() / 2**20 if device != "cpu"
                        else None)}
    if multiclass:
        ca = out["class_alpha"]
        if tuple(ca.shape) != (num_streams, mh, mw, statics.num_classes) \
                or not bool(torch.isfinite(ca).all()):
            raise AssertionError(f"class_alpha {tuple(ca.shape)} not finite or misshaped")
        res["simplex_err"] = (ca.sum(-1) - 1.0).abs().max().item()
        if not res["simplex_err"] <= 1e-3:
            raise AssertionError(f"class_alpha sums to 1 only within {res['simplex_err']}")
    if trained:
        if multiclass:
            pred = (1.0 - out["class_alpha"][..., 0]).cpu().numpy() > 0.5
            step = truth.shape[1] // mh
            truth = truth[:, ::step, ::step]
        else:
            pred = alpha.cpu().numpy() > 0.5
        inter = (pred & truth).sum(axis=(1, 2))
        union = np.maximum((pred | truth).sum(axis=(1, 2)), 1)
        res["iou"] = float(np.mean(inter / union))
        if min_iou is not None and res["iou"] < min_iou:
            raise AssertionError(f"alpha IoU against the ground truth {res['iou']:.3f} "
                                 f"< {min_iou}")
        if statics.face_path and res["applied"] == 0:
            raise AssertionError("the face path was applied to no stream")
        if statics.frame_layout == "s2d":
            res["trunk_err"] = trunk_vs_plain(eng.model, frames[:2], statics.s2d_block)
            if not res["trunk_err"] <= TRUNK_TOL:
                raise AssertionError(f"served trunk disagrees with its plain version: "
                                     f"{res['trunk_err']}")
    else:
        iy = (np.arange(mh) * fh) // mh
        ix = (np.arange(mw) * fw) // mw
        mask = torch.as_tensor(inside[np.ix_(iy, ix)], device=alpha.device)
        res["alpha_in"] = alpha[:, mask].mean().item()
        res["alpha_out"] = alpha[:, ~mask].mean().item()
        if abs(res["alpha_in"] - res["alpha_out"]) < 1e-2:
            raise AssertionError(f"alpha inside the ellipse {res['alpha_in']} ~ "
                                 f"outside {res['alpha_out']}")
    return res


def trunk_vs_plain(model, frames_u8: np.ndarray, block: int) -> float:
    """Max difference between the model's trunk (the kernels on a card) and
    its plain version, on the stem output of ``frames_u8``: the logits
    with the int8 head; u1 with the bf16 head, which is no kernel of the
    port's (PyTorch's bf16 convolution, as the reference leaves it to
    XLA)."""
    from video_stream_segmenetation_tpu_torch.kernels import trunk_int8 as TK
    from video_stream_segmenetation_tpu_torch.models import quantized as Q
    from video_stream_segmenetation_tpu_torch.ops.layout import space_to_depth

    dev = model.stem_w.device
    fp = space_to_depth(torch.as_tensor(frames_u8, device=dev), block).contiguous()
    x0 = model.stem(fp)
    tp = model.trunk
    plain_u1 = Q.PLAIN_TRUNKS[model.decoder](x0, tp)
    if model.head_impl == "bf16":
        if model.decoder in ("pico", "nano"):
            got = TK.fused_nano_trunk(x0, tp)
        else:
            got = TK.PLAN_TRUNKS[model.decoder](x0, tp, conv_impl=model.conv_impl,
                                                head=False)
        want = plain_u1
    else:
        got = model.trunk_logits(x0)
        want = Q.alpha_head(plain_u1, tp["alpha"])
    if got.shape != want.shape:
        return math.inf
    return (got.float() - want.float()).abs().max().item()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a card",
              file=sys.stderr, flush=True)
        return 2
    from video_stream_segmenetation_tpu_torch.kernels import _build

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    steps = 3 + len(PHASES)
    say(f"[1/{steps} device] {name}, device_count={count}, nvidia-smi: {smi}, "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    info = _build.build()
    say(f"[2/{steps} build] {'built' if info['built'] else 'found'} {info['path']} in "
        f"{info['seconds']:.1f} s (nvcc {info['nvcc']}); kernels: "
        + "; ".join(f"{k}: {v['registers']} regs, {v['smem']} B smem, "
                    f"{v['spill_stores']}/{v['spill_loads']} B spill st/ld"
                    for k, v in info["kernels"].items()))

    say(f"[3/{steps} kernels] vs plain versions at S={S}, 720p")
    kernels = [*check_trunk(dev), check_refine(dev), check_decoder(dev), check_conv(dev),
               check_u1_trunk(dev), check_composite(dev), check_refine_plane(dev),
               check_fused_refine(dev)]
    torch.cuda.empty_cache()

    for k in kernels:
        k["launches"] = 0
    by_name = {k["name"]: k for k in kernels}
    for i, (label, preset_name, overrides, trained, per_step, min_iou,
            trunk_entry) in enumerate(PHASES):
        say(f"[{4 + i}/{steps} serve] Engine({S}, {label}), {SERVE_STEPS} steps, "
            + ("trained weights, committed frames" if trained else "seeded weights"))
        res = serve("cuda", S, SERVE_STEPS, preset_name, overrides, trained, min_iou)
        for counter, n in res["launches"].items():
            want = per_step.get(counter, 0) * SERVE_STEPS
            if n != want:
                raise AssertionError(f"{label}: {counter} launched {n} times in "
                                     f"{SERVE_STEPS} steps, expected {want}")
            entry = trunk_entry if counter == "trunk_int8" else counter
            if entry in by_name:
                by_name[entry]["launches"] += n
        med = statistics.median(res["times_ms"])
        iou_name = "foreground IoU" if "simplex_err" in res else "alpha IoU"
        quality = (f"{iou_name} vs ground truth {res['iou']:.4f}"
                   + (f" (least allowed {min_iou:.4f})" if min_iou is not None else "")
                   + (f", class_alpha sums to 1 within {res['simplex_err']:.2e}"
                      if "simplex_err" in res else "")
                   + f", face_applied on "
                   f"{res['applied']} streams, mean det_score {res['det_score']:.4f}"
                   + (f", trunk vs plain on 2 streams {res['trunk_err']:.3e} (tolerance "
                      f"{TRUNK_TOL:g})" if "trunk_err" in res else "")
                   if trained else
                   f"alpha inside/outside the ellipse {res['alpha_in']:.4f}/"
                   f"{res['alpha_out']:.4f}")
        say(f"  serve: median step {med:.2f} ms over {SERVE_STEPS} steps (host clock, "
            f"synchronized; first {res['times_ms'][0]:.1f} ms), launches "
            f"{res['launches']}, {quality}, health {res['health']}, peak device memory "
            f"{res['peak_mib']:.0f} MiB")
        torch.cuda.empty_cache()
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
