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
     widths (trained multi-class weights, exact), with its one-class head at
     the nano and the femto widths (the trained fast_int8_nano and _femto
     weights, exact), the fused temporal refine
     (bf16 and f32 refined alpha), the int8 decoder level at micro's u2 and
     u1 levels (beside it, on the same inputs, the trunk's split form of
     the same function: two conv launches, held and timed as its
     yardstick), the fused 3x3 conv in its four forms (act or not, residual
     or not; given the OHWI weights and not) at plan B's layer shapes
     (beside it the trunk's own conv on the same inputs, held and timed as
     its yardstick), the u1-out trunk at pico widths, the
     natural layout's fused composite (720p, 288x512 alpha), the
     plane-prior temporal refine, fused_refine (f32 out), the fast
     form of the temporal refine in its three forms (head-grid logits
     [64, 72, 128], tap lanes [48, 64, 72, 128], both), and the stochastic
     rounding f32 -> bf16 on 64 M values (+-0, subnormals, exact values,
     +-inf, NaNs, values next to bf16's largest, normals at many scales):
     bit for bit, every output one of its two bf16 neighbours, a block of
     one value rounded up at its probability within 5 sigma;
  4-29. serve: Engine(64, ...) answers 8 steps of 720p frames in
     twenty-six phases, each with every launch count set to 0 just before it and read
     just after, and none of its steps a passthrough (the engine's count of
     them must stay 0):
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
      13-16. active (the float MatteNet over natural frames) as it stands,
          with use_fused_composite=True, prior_impl='plane' and
          warp_impl='exact';
      17-19. the colour and blur backgrounds: fast_int8_pico with
          background='color' (the packed colour), active with
          use_fused_composite=True and background='color' (the composite
          kernel with a one-row u8 background, held against its plain
          version on the last step's inputs bit for bit) and active with
          background='blur' (the frames blurred, the plain composite);
          each with its image-background phase's IoU bar, and where the
          served alpha upsamples to 0 the frame must be the background
          exactly;
      20-21. fast_int8_nano and fast_int8_femto as their presets stand
          (the trunk at the nano and femto widths, one class; fd 256 / lmk
          192, f32 refined alpha), trained weights, the same frames;
      22-25. the reference application's other pipelines as their presets
          stand, on the unfused refine chain (no counted kernel):
          blaze_tracking (translation tracking, the detector on every
          stream's 720p frame every step, a colour background), branch
          (the max blend and the hole-filling EMA; the even streams primed
          with PRIMED_AFFINE), rvm (the RecurrentMatteNet, its ConvGRU
          state in StreamState.rec) and u2 (the SaliencyNet at 320x320, no
          temporal stage, a colour background; its alpha scored on the
          288x512 truth by nearest taps), trained weights, the same frames;
      26-27. fast (the float plan-A MatteNetHD on the natural u8 frames,
          its 5x5 stride-5 stem the resize, the nearest u8 guide, the
          refine kernel once a step) as its preset stands and with
          use_fused_composite=True (the composite kernel once a step, held
          against its plain version on the last step's inputs);
      28. multiclass (the K=4 float MatteNet over the frames resized to the
          mask, the per-class composite of the f32 frames with the blur;
          no counted kernel), its class map means held to the reference's;
      29. active with refined_dtype='bf16' (the refine kernel's bf16 out,
          the plain composite's bf16 upsample);
     each checks shapes, dtypes, value ranges, the alpha against the frames'
     ground truth (phases 5-29) or the ellipse (phase 4), that each counted
     wrapper ran its expected number of times (every other one none), with
     the face path on that it was applied to at least one stream, in phases
     7-8 and 28 that class_alpha sums to 1 within 1e-3, in phases 7-29 that
     the IoU is at most 0.02 below the reference engine's, and in every trained
     s2d phase that the served trunk equals its plain version on two
     streams; each prints its median step time and the peak device memory;
  30. degrade: Engine(64, fast_int8_pico) with the trained weights loaded
     through load_matting_params/load_face_params from weights/*.npz, its
     step replaced by one that raises, through process and through
     dispatch/collect: two passthrough failures, 'degraded' after the
     third, a fourth call served as passthrough without running the step,
     each passthrough frame equal to its input byte for byte and alpha f32
     ones; the step restored and the probe due, the probe serves and
     health reads 'ok'; then one real failure on the card each of an
     out-of-memory and a launch the alpha head's C entry point refuses;
  31. render: the sample background templates at each privacy level,
     rendered at 720p with PIL (background/render.py) and served;
  32. server: a ControlServer on that engine at 127.0.0.1 on a free port:
     /stats, /healthz (503 while degraded), knobs, reset, a background
     colour, the privacy level and a template between served steps;
  33. chunked, packed: process_chunked(frames, 16) against process on a
     second engine, element by element; output_layout='packed' after
     depth_to_space against 'natural', byte for byte;
  34. api: segment, composite (colour, blur, image) and process_frame on
     the committed frames with weights/mattenet.npz, the mask IoU within
     0.02 of the active phase's;
  35. rotation, the production serving loop: StreamScheduler(Engine(400,
     fast_int8_pico with refine_alpha_src='lowres', guide_kernel_unfold=
     True, guide_source='host'), group_sizes=[96, 96, 96, 96, 16],
     fused_rounds=True) over the port's native FramePool (48 guide lanes
     emitted while it packs), trained weights, the committed frames pushed
     per stream: a priming round, 8 rounds and a drain; the trunk and the
     fast refine once a group a round and no other kernel, the face path
     applied with the stagger, alpha IoU >= 0.5; one more round timed by
     its parts, its step under torch.cuda.set_sync_debug_mode('error');
     one more round whose trunk and fast refine inputs are kept at each
     group size (96 and 16), and each kernel held against its plain
     version on them at the kernels phase's tolerances;
  36. rotation failure: on that rotation, one round failing after its
     first two groups wrote their rows: every group's input back as
     passthrough, the state restored from the failing dispatch's snapshot
     (affine, has_affine, frame_idx; a cold EMA), three rounds served,
     then one more round with its snapshot under
     set_sync_debug_mode('error');
  37. routes: S=64 in groups [24, 24, 16], face_min_interval_s=0, the same
     frames through that route with fused rounds and through
     fast_int8_pico as its preset stands under per-group step_pipelined:
     prev_alpha within 1e-5, the refined alpha within 1e-2, IoU within
     0.001; then on each route a round held as in phase 35 (trunk, fast
     and analytic refine at 24 and 16 streams);
  38. train: the plan-D pico MatteNetHD at its full widths, fit on the
     card with tools/train_flagship.py's schedule at fewer steps (20 at
     240x320 batch 32, then 5 at 720x1280 batch 8), every loss and
     grad_norm finite and every leaf moved; one step's forward and
     backward on the card against the CPU (bf16 and f32); the trained
     tree stochastically rounded to bf16 through the kernel, leaf by
     leaf, quantized by the port's quantizer and served one step of
     Engine(8, fast_int8_pico, face_path=False) through the CUDA trunk;
     it prints ms a step (CUDA events) and the peak memory.
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
TRUNK_WIDTHS_TOL = 0  # one class at the nano and femto widths: the same, held exact
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


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def trunk_launches(x0, tp) -> list[dict]:
    """The pico/nano trunk's 11 launches (kernels/trunk_int8.py::_nano_u1,
    then the head) one by one on ``x0``, each with its own multiply-adds
    and the bytes it reads and writes (inputs once, output once), and for
    the 1x1 convs the (M, K, N) of their product."""
    from video_stream_segmenetation_tpu_torch.kernels import trunk_int8 as TK

    lib, stream = TK._launcher(x0)
    f32, i8 = torch.float32, torch.int8
    rows, acts = [], {"x0": x0}

    def conv(name, src, out_dtype, stride=1, dil=1, mode=0, res=None, up=None):
        layer, x = tp[name], acts[src]
        r, u = acts.get(res), acts.get(up)

        def fn():
            return TK._conv(lib, stream, x, layer, out_dtype, stride=stride, dil=dil,
                            mode=mode, res=r, up=u)
        y = acts[name] = fn()
        cout, kh, kw, cin = layer["w"].shape
        m = y.numel() // cout
        rows.append({"name": name, "fn": fn, "macs": m * kh * kw * cin * cout,
                     "bytes": _nbytes(x, r, u, y, *layer.values()),
                     "mkn": (m, cin, cout) if kh == kw == 1 else None, "x": x,
                     "w": layer["w"]})

    conv("d2dn", "x0", i8, stride=2)
    conv("d2b", "d2dn", i8)
    conv("d3dn", "d2b", i8, stride=2)
    conv("d3b", "d3dn", i8)
    conv("ctx", "d3b", f32, dil=3, mode=2, res="d3b")
    ctx_f = acts["ctx"]
    se = tp["se"]
    acts["se"] = TK._se_requant(lib, stream, ctx_f, se)
    rows.append({"name": "se", "fn": lambda: TK._se_requant(lib, stream, ctx_f, se),
                 "macs": ctx_f.shape[0] * (se["k0"].numel() + se["k1"].numel()),
                 "bytes": _nbytes(ctx_f, acts["se"], *se.values()), "mkn": None})
    conv("u2red_up", "se", f32, mode=1)
    conv("u2red_skip", "d2b", i8, up="u2red_up")
    conv("u1red_up", "u2red_skip", f32, mode=1)
    conv("u1red_skip", "x0", i8, up="u1red_up")
    u1, head = acts["u1red_skip"], tp["alpha"]
    logits = TK._alpha_head(lib, stream, u1, head)
    k = head["w"].shape[0]
    rows.append({"name": "alpha head", "fn": lambda: TK._alpha_head(lib, stream, u1, head),
                 "macs": logits.numel() // k * 9 * u1.shape[-1] * k,
                 "bytes": _nbytes(u1, logits, *head.values()), "mkn": None})
    return rows


def print_trunk_launches(name: str, x0, tp) -> None:
    """Each launch's CUDA-event time beside its own bound, and, for the 1x1
    convs, ``torch._int_mm``'s time for the same M x K x N product (a
    yardstick for the product alone; the port never calls it)."""
    total = {"ms": 0.0, "bound": 0.0}
    for r in trunk_launches(x0, tp):
        ms = cuda_time_ms(r["fn"], 20)
        b_ms, b_by = bound(r["bytes"], 2 * r["macs"], INT8_OPS_PER_S)
        line = (f"  {name} launch {r['name']:10s}: {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
                f"{r['macs'] / 1e9:.2f} G MAC, {r['bytes'] / 1e6:.1f} MB)")
        if r["mkn"] is not None:
            m, kk, n = r["mkn"]
            a = r["x"].reshape(m, kk)
            b = r["w"].reshape(n, kk).t()
            try:
                mm_ms = cuda_time_ms(lambda: torch._int_mm(a, b), 20)
                line += f"; torch._int_mm {m}x{kk}x{n}: {mm_ms:.4f} ms"
            except RuntimeError as err:  # a yardstick only: say why it has none
                line += f"; torch._int_mm {m}x{kk}x{n}: refused ({str(err)[:80]})"
        say(line)
        total["ms"] += ms
        total["bound"] += b_ms
    say(f"  {name} launches summed: {total['ms']:.4f} ms, their bounds summed "
        f"{total['bound']:.4f} ms")


def check_trunk(dev) -> list[dict]:
    """The trunk kernel at S=64, 720p: the one-class head at the pico
    widths (seeded weights, random s8 stem output), then the K=4 head at
    the pico and the nano widths with the trained multi-class weights, and
    the one-class head at the nano and femto widths (every level at 128
    channels) with the trained fast_int8_nano/_femto weights, each on the
    stem output of the committed frames."""
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
    print_trunk_launches("trunk_int8", x0, tp)
    clip, _ = bridge.load_frames()
    frames_p = space_to_depth(torch.as_tensor(clip[np.arange(S) % 2], device=dev),
                              blk).contiguous()
    for name, export, tol in (("trunk_int8_k4_pico", "mattenet_hd10_mc_pico", TRUNK_K4_TOL),
                              ("trunk_int8_k4_nano", "mattenet_hd10_mc", TRUNK_K4_TOL),
                              ("trunk_int8_nano", "mattenet_hd10_nano", TRUNK_WIDTHS_TOL),
                              ("trunk_int8_femto", "mattenet_hd10_femto", TRUNK_WIDTHS_TOL)):
        model = Q.QuantizedMatteNetHD(bridge.load_export(bridge.WEIGHTS_DIR / f"{export}.npz"),
                                      blk, 1, device=dev)
        with pinned():
            x0 = model.stem(frames_p)
        entries.append(_trunk_entry(name, x0, model.trunk, tol))
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


def fast_refine_inputs(dev, seed):
    """The fast refine's inputs at S=64, 720p shapes: head-grid logits
    ``[S, 72, 128]`` f32 (spread over +-4), the full-resolution alpha
    they upsample to (sigmoid of the f32 interpolation products), a random
    planar u8 guide ``[S, 3, 288, 512]`` and its tap lanes ``[48, S, 72,
    128]`` (lane (c*4 + y%4)*4 + x%4 at (y/4, x/4)), and the rest of
    :func:`_refine_inputs`."""
    from video_stream_segmenetation_tpu_torch.ops.resize import resize_bilinear_mxu
    from video_stream_segmenetation_tpu_torch.runtime.precision import pinned

    (_, prev, guide, affine, initialized, use_warp, has_prior, prior_params,
     knobs) = _refine_inputs(dev, seed)
    h, w = prev.shape[-2:]
    fy = fx = 4
    gen = torch.Generator(device=dev).manual_seed(seed + 100)
    logits = (torch.rand((S, h // fy, w // fx), generator=gen, device=dev) - 0.5) * 8.0
    with pinned():
        alpha = torch.sigmoid(resize_bilinear_mxu(logits, (h, w), "half_pixel",
                                                  channel_last=False)).contiguous()
    lanes = guide.reshape(S, 3, h // fy, fy, w // fx, fx).permute(1, 3, 5, 0, 2, 4) \
        .reshape(3 * fy * fx, S, h // fy, w // fx).contiguous()
    return (logits, alpha, lanes, (fy, fx), prev, guide, affine, initialized, use_warp,
            has_prior, prior_params, knobs)


# the fast refine's three forms: (label, head-grid logits, tap lanes)
FAST_FORMS = (("lowres", True, False), ("lanes", False, True), ("lowres+lanes", True, True))


def check_refine_fast(dev) -> dict:
    """The fast form of the temporal refine in its three forms (the
    head-grid logits, the tap lanes, both; bf16 refined alpha) against its
    plain version, then CUDA-event times of each and of the plain version,
    and the bound of the form the production rotation serves (both)."""
    from video_stream_segmenetation_tpu_torch.kernels import refine_fused as TR
    from video_stream_segmenetation_tpu_torch.ops.warp import separable_warp_indices
    from video_stream_segmenetation_tpu_torch.runtime.precision import pinned

    (logits, alpha, lanes, geom, prev, guide, affine, initialized, use_warp, has_prior,
     prior_params, knobs) = fast_refine_inputs(dev, 9)
    h, w = prev.shape[-2:]
    yi, xi = separable_warp_indices(affine, (h, w))
    table = TR.scalar_table(knobs, use_warp, initialized, 0.3, prior_params, has_prior)
    errs, times = {}, {}
    for label, lowres, use_lanes in FAST_FORMS:
        a_src = logits if lowres else alpha
        g_src = lanes if use_lanes else guide
        hw = (h, w) if lowres else None
        gg = geom if use_lanes else None
        got_prev, got = TR.fused_temporal_refine_fast(
            a_src, prev, affine, use_warp, initialized, 0.3, g_src, prior_params, has_prior,
            knobs, alpha_lowres_hw=hw, guide_lanes_geom=gg)
        with pinned():
            want_prev, want = TR.fused_temporal_refine_plain(a_src, prev, yi, xi, g_src, table,
                                                             torch.bfloat16, None, hw, gg)
        torch.cuda.synchronize()
        err_prev = (got_prev - want_prev).abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        say(f"  refine_fused_fast {label}: new_prev max_abs_err {err_prev:.3e} (tolerance "
            f"{PREV_TOL:g}), refined {got.dtype} max_abs_err {err:.3e} (tolerance "
            f"{REFINED_TOL:g}); refined mean {want.float().mean().item():.4f}")
        if got.dtype != torch.bfloat16 or not (err_prev <= PREV_TOL and err <= REFINED_TOL):
            raise AssertionError(f"fast refine kernel ({label}) disagrees with its plain "
                                 f"version: {err_prev}, {err}")
        errs[label] = max(err_prev, err)
        ms = cuda_time_ms(lambda: TR._launch(a_src, prev, yi, xi, g_src, table,
                                             torch.bfloat16, None, hw, gg), 20)
        with pinned():
            plain_ms = cuda_time_ms(lambda: TR.fused_temporal_refine_plain(
                a_src, prev, yi, xi, g_src, table, torch.bfloat16, None, hw, gg), 3)
        times[label] = (ms, plain_ms)
        say(f"  refine_fused_fast {label}: {ms:.3f} ms, plain {plain_ms:.3f} ms")
    px = S * h * w
    # both cuts: prev read, new_prev and the bf16 alpha written, the logits
    # and the lanes read once; plus the indices, the table and the taps
    bytes_moved = (px * (4 + 4 + 2) + logits.numel() * 4 + lanes.numel()
                   + yi.numel() * 4 + xi.numel() * 4 + table.numel() * 4 + (h + w) * 16)
    # the upsample and sigmoid: 6 products and sums of the two taps, the
    # exp and the division (~10 a pixel)
    ops = refine_ops(table, (h, w)) + 10 * px
    bound_ms, bound_by = bound(bytes_moved, ops, F32_OPS_PER_S)
    ms, plain_ms = times["lowres+lanes"]
    say(f"  refine_fused_fast lowres+lanes: bound {bound_ms:.4f} ms ({bound_by}; "
        f"{bytes_moved / px:.2f} B a pixel, {bytes_moved / 1e6:.1f} MB)")
    return {"name": "refine_fused_fast", "route": "cuda",
            "source": "video_stream_segmenetation_tpu_torch/csrc/refine_fused.cu",
            "replaces": "video_stream_segmenetation_tpu/kernels/refine_fused.py:330",
            "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "forms_ms": {k: v[0] for k, v in times.items()}}


def check_decoder(dev) -> dict:
    """The int8 decoder level at micro's two levels (720p, S=64), trained
    micro weights, s8 activations on the relu6 lattice; beside it, on the
    same inputs, the trunk's split form of the same function (an f32
    up-path conv, then the skip conv adding it: two launches of the
    trunk's conv), held bit for bit too and timed as the yardstick."""
    from video_stream_segmenetation_tpu_torch import bridge
    from video_stream_segmenetation_tpu_torch.kernels import decoder_int8 as DK
    from video_stream_segmenetation_tpu_torch.kernels import trunk_int8 as TK
    from video_stream_segmenetation_tpu_torch.models import quantized as Q

    tp = Q.trunk_params(bridge.load_export(bridge.WEIGHTS_DIR / "mattenet_hd10_micro.npz"),
                      dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    hp, wp = FRAME_HW[0] // 10, FRAME_HW[1] // 10
    total = {"ms": 0.0, "plain_ms": 0.0, "split_ms": 0.0, "bytes": 0, "macs": 0, "err": 0.0}
    forms = {}
    for level, (sh, sw), (ca, cb) in (("u2", (hp // 4, wp // 4), (256, 192)),
                                      ("u1", (hp // 2, wp // 2), (192, 128))):
        up, skip_l = tp[f"{level}red_up"], tp[f"{level}red_skip"]
        small = torch.randint(0, 128, (S, sh, sw, ca), generator=gen, device=dev,
                              dtype=torch.int32).to(torch.int8)
        skip = torch.randint(0, 128, (S, 2 * sh, 2 * sw, cb), generator=gen, device=dev,
                             dtype=torch.int32).to(torch.int8)
        lib, stream = TK._launcher(small)

        def split():
            ya = TK._conv(lib, stream, small, up, torch.float32, mode=1)
            return TK._conv(lib, stream, skip, skip_l, torch.int8, up=ya)
        got = DK.fused_decoder_level(small, skip, up, skip_l)
        got_split = split()
        want = Q.split_conv_up(small, skip, up, skip_l)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        split_err = (got_split.float() - want.float()).abs().max().item()
        hist = torch.bincount(want.flatten().to(torch.int64), minlength=128)
        say(f"  decoder_int8 {level}: small {tuple(small.shape)} skip {tuple(skip.shape)} "
            f"-> {tuple(got.shape)} max_abs_err {err:g} (tolerance {DECODER_TOL}); the "
            f"trunk's split form {split_err:g}; out at 0: {hist[0].item() / want.numel():.3f}"
            f", at 127: {hist[127].item() / want.numel():.3f}")
        if got.dtype != torch.int8 or err > DECODER_TOL:
            raise AssertionError(f"decoder kernel disagrees with its plain version at "
                                 f"{level}: {err}")
        if got_split.dtype != torch.int8 or split_err > DECODER_TOL:
            raise AssertionError(f"the trunk's split form disagrees with the plain decoder "
                                 f"level at {level}: {split_err}")
        ms = cuda_time_ms(lambda: DK.fused_decoder_level(small, skip, up, skip_l), 20)
        split_ms = cuda_time_ms(split, 20)
        plain_ms = cuda_time_ms(
            lambda: Q.split_conv_up(small, skip, up, skip_l), 3)
        cout = up["w"].shape[0]
        bytes_moved = (small.numel() + skip.numel() + got.numel() + up["w"].numel()
                       + skip_l["w"].numel() + 8 * cout)
        macs = (small.numel() + skip.numel()) * cout
        b_ms, b_by = bound(bytes_moved, 2 * macs, INT8_OPS_PER_S)
        say(f"  decoder_int8 {level}: {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}; {bytes_moved / 1e6:.1f} MB, {macs / 1e9:.2f} G MAC); "
            f"the trunk's split form (two conv launches) on the same inputs {split_ms:.4f} ms")
        forms[level] = ms
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("split_ms", split_ms),
                     ("bytes", bytes_moved), ("macs", macs)):
            total[k] += v
        total["err"] = max(total["err"], err)
    forms["trunk split"] = total["split_ms"]
    bound_ms, bound_by = bound(total["bytes"], 2 * total["macs"], INT8_OPS_PER_S)
    say(f"  decoder_int8 both levels: {total['ms']:.4f} ms, plain {total['plain_ms']:.3f} ms,"
        f" bound {bound_ms:.4f} ms ({bound_by}); the trunk's split form "
        f"{total['split_ms']:.4f} ms")
    return {"name": "decoder_int8", "route": "cuda",
            "source": "video_stream_segmenetation_tpu_torch/csrc/decoder_int8.cu",
            "replaces": "video_stream_segmenetation_tpu/kernels/decoder_int8.py:100",
            "max_abs_err": total["err"], "ms": total["ms"], "plain_ms": total["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "forms_ms": forms}


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
    form (act, no residual), with the trunk's own conv (which the 'xla'
    route serves) timed on the same inputs beside them."""
    from video_stream_segmenetation_tpu_torch import bridge
    from video_stream_segmenetation_tpu_torch.kernels import conv_int8 as TC
    from video_stream_segmenetation_tpu_torch.kernels import trunk_int8 as TK
    from video_stream_segmenetation_tpu_torch.models import quantized as Q

    tp = Q.trunk_params(bridge.load_export(bridge.WEIGHTS_DIR / "mattenet_hd10.npz"), dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    hp, wp = FRAME_HW[0] // 10, FRAME_HW[1] // 10
    total = {"ms": 0.0, "plain_ms": 0.0, "trunk_ms": 0.0, "bytes": 0, "macs": 0, "err": 0.0}
    forms = {}
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
                # the OHWI copy the trunks pass (_qconv), and without it
                got = TC.conv3x3_i8_fused(*args, w_ohwi=layer["w"])
                got_t = TC.conv3x3_i8_fused(*args)
                want = TC.conv3x3_i8_plain(*args)
                torch.cuda.synchronize()
                errs += [(g.int() - want.int()).abs().max().item()
                         if g.dtype == want.dtype == torch.int8 else math.inf
                         for g in (got, got_t)]
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
                                                      dilation=dil, w_ohwi=layer["w"]), 10)
        plain_ms = cuda_time_ms(lambda: TC.conv3x3_i8_plain(x, wq, layer["mult"],
                                                            layer["bias"], dilation=dil), 2)
        # the same 3x3 requant through the trunk's own conv (int8_conv_impl='xla')
        lib, stream = TK._launcher(x)
        trunk_err = (TK._conv(lib, stream, x, layer, torch.int8, dil=dil).int()
                     - TC.conv3x3_i8_plain(x, wq, layer["mult"], layer["bias"],
                                           dilation=dil).int()).abs().max().item()
        if trunk_err > CONV_TOL:
            raise AssertionError(f"the trunk's conv disagrees with the plain 3x3 conv at "
                                 f"{name}: {trunk_err}")
        trunk_ms = cuda_time_ms(lambda: TK._conv(lib, stream, x, layer, torch.int8, dil=dil), 10)
        macs = x.numel() * 9 * cout
        bytes_moved = x.numel() + x.numel() // cin * cout + wq.numel() + 8 * cout
        b_ms, b_by = bound(bytes_moved, 2 * macs, INT8_OPS_PER_S)
        say(f"  conv3x3_i8_fused {name}: {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}; {macs / 1e9:.2f} G MAC, {bytes_moved / 1e6:.1f} MB); "
            f"the trunk's conv on the same inputs {trunk_ms:.4f} ms (max_abs_err {trunk_err})")
        forms[name] = ms
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("trunk_ms", trunk_ms),
                     ("bytes", bytes_moved), ("macs", macs)):
            total[k] += v
    forms["trunk conv"] = total["trunk_ms"]
    bound_ms, bound_by = bound(total["bytes"], 2 * total["macs"], INT8_OPS_PER_S)
    say(f"  conv3x3_i8_fused, plan B's four routed layers: {total['ms']:.4f} ms, plain "
        f"{total['plain_ms']:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}); the trunk's "
        f"conv on the same inputs {total['trunk_ms']:.4f} ms")
    return {"name": "conv3x3_i8_fused", "route": "cuda",
            "source": "video_stream_segmenetation_tpu_torch/csrc/conv_int8.cu",
            "replaces": "video_stream_segmenetation_tpu/kernels/conv_int8.py:116",
            "max_abs_err": total["err"], "ms": total["ms"], "plain_ms": total["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "forms_ms": forms}


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
    # the one-row background (a colour background's form, bg_stride 0)
    bg1 = bg[:1].contiguous()
    got1 = KC.fused_composite(frames, alpha, bg1)
    with pinned():
        want = KC.fused_composite_plain(frames, alpha, bg)
        want1 = KC.fused_composite_plain(frames, alpha, bg1)
    torch.cuda.synchronize()
    diff = (got.int() - want.int()).abs()
    err = max(diff.max().item(), (got1.int() - want1.int()).abs().max().item())
    say(f"  composite_fused: frames {tuple(frames.shape)} alpha {tuple(alpha.shape)}, "
        f"background of S rows and of one row: max_abs_err {err} u8 steps (tolerance "
        f"{COMPOSITE_TOL}), values apart {(diff > 0).sum().item()}")
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
    ms1 = cuda_time_ms(lambda: KC.fused_composite(frames, alpha, bg1), 20)
    bound1_ms, bound1_by = bound(2 * frames.numel() + bg1.numel() + 4 * alpha.numel(), ops,
                                 F32_OPS_PER_S)
    say(f"  composite_fused: {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}; {bytes_moved / 1e6:.1f} MB); one-row background {ms1:.3f} ms, bound "
        f"{bound1_ms:.4f} ms ({bound1_by})")
    return {"name": "composite_fused", "route": "cuda",
            "source": "video_stream_segmenetation_tpu_torch/csrc/composite_fused.cu",
            "replaces": "video_stream_segmenetation_tpu/kernels/composite_fused.py:84",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}



SR_N = 64 << 20  # 64 M f32 elements (256 MB)
SR_BLOCK = 4 << 20  # a block of one value rounded up with a known probability
SR_OPS = 30  # integer operations an element: a Philox draw (10 rounds) per 4, the add


def stochastic_inputs(dev) -> tuple[torch.Tensor, int, float]:
    """64 M f32 values: +-0, subnormals, values exact in bf16, +-inf, NaNs
    (quiet, signalling, payloads in the low and the high bits), values next
    to bf16's largest finite value, a block of one value whose low 16 bits
    make it round up with probability ``p``, and random normals at many
    scales.  Returns (x, the block's offset, p)."""
    gen = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn(SR_N, generator=gen, device=dev)
    x *= torch.pow(10.0, torch.randint(-30, 30, (SR_N,), generator=gen, device=dev).float())
    bits = x.view(torch.int32)
    q = SR_N // 16
    bits[:q] &= -65536  # exact in bf16
    mag = torch.randint(0, 1 << 23, (q,), generator=gen, device=dev, dtype=torch.int32)
    neg = torch.randint(0, 2, (q,), generator=gen, device=dev).bool()
    bits[q: 2 * q] = torch.where(neg, mag | -(1 << 31), mag)  # subnormals, +-0
    ints = lambda *v: torch.tensor(  # noqa: E731
        np.asarray(v, np.uint32).view(np.int32), device=dev)
    special = ints(0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000, 0x7F800001,
                   0xFF800001, 0x7FFFFFFF, 0xFFFFFFFF, 0x00000000, 0x80000000)
    near_max = ints(0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F8000, 0x7F7F0001, 0xFF7F0000)
    n_sp = 1 << 16
    bits[2 * q: 2 * q + n_sp] = special.repeat(n_sp // len(special) + 1)[:n_sp]
    bits[2 * q + n_sp: 2 * q + 2 * n_sp] = near_max.repeat(n_sp // len(near_max) + 1)[:n_sp]
    low = 19661  # ~0.3 of 2^16
    off = 3 * q
    bits[off: off + SR_BLOCK] = 0x3F810000 + low  # 1.0078125 + a share of the gap
    return x, off, low / 65536.0


def check_stochastic_round(dev) -> dict:
    """The stochastic-rounding kernel on 64 M mixed f32 values, against its
    plain version bit for bit (NaN payloads included); every finite output
    one of its input's two bf16 neighbours; the block of one value rounded
    up at a share within 5 sigma of its probability."""
    from video_stream_segmenetation_tpu_torch.kernels import stochastic_round as SR

    x, off, p = stochastic_inputs(dev)
    got = SR.stochastic_round_bf16(x, 123)
    want = SR.stochastic_round_bf16_plain(x, 123)
    torch.cuda.synchronize()
    gb, wb = got.view(torch.int16), want.view(torch.int16)
    apart = int((gb != wb).sum().item())
    finite = torch.isfinite(want)
    err = (got.float() - want.float())[finite].abs().max().item() if apart else 0.0
    xb = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    ob = gb.to(torch.int64) & 0xFFFF
    xnan = torch.isnan(x)
    neighbour = (ob == (xb >> 16)) | (ob == (xb >> 16) + 1)
    not_neighbour = int((~neighbour & ~xnan).sum().item())
    nan_kept = bool(torch.equal(ob[xnan], (xb[xnan] >> 16) | 0x40))
    up = (ob[off: off + SR_BLOCK] != (xb[off] >> 16)).double().mean().item()
    sigma = math.sqrt(p * (1 - p) / SR_BLOCK)
    say(f"  stochastic_round: {SR_N} values, {apart} bit patterns apart from the plain "
        f"version (tolerance 0), max_abs_err {err:.3e}; {not_neighbour} non-NaN outputs "
        f"off their two bf16 neighbours; NaNs quiet and signed {nan_kept}; rounded up "
        f"{up:.6f} of a block of {SR_BLOCK} at p = {p:.6f} ({(up - p) / sigma:+.2f} sigma)")
    if apart or not_neighbour or not nan_kept or abs(up - p) > 5 * sigma:
        raise AssertionError("stochastic rounding kernel: disagrees with its plain version "
                             "or off its distribution")
    ms = cuda_time_ms(lambda: SR.stochastic_round_bf16(x, 123), 20)
    plain_ms = cuda_time_ms(lambda: SR.stochastic_round_bf16_plain(x, 123), 2)
    bound_ms, bound_by = bound(6 * SR_N, SR_OPS * SR_N, F32_OPS_PER_S)
    say(f"  stochastic_round: {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}; 6 B an element); no single PyTorch call rounds stochastically")
    del x, got, want
    return {"name": "stochastic_round", "route": "cuda",
            "source": "video_stream_segmenetation_tpu_torch/csrc/stochastic_round.cu",
            "replaces": "video_stream_segmenetation_tpu/utils/quantize.py:91",
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
                 "active": 0.5460, "active_exact_warp": 0.5429,
                 # tests/test_torch_api.py::test_trained_segment_iou_720p: the
                 # reference's segment (the model's alpha, no refine)
                 "api": 0.6680,
                 # tests/test_torch_zoo_720p.py and test_torch_zoo_720p_models.py,
                 # 8 steps: the nano and femto checkpoints find little of this
                 # person (as micro's); branch with PRIMED_AFFINE on the even
                 # streams; u2's 320x320 alpha on the 288x512 truth by nearest
                 # taps
                 "fast_int8_nano": 0.2030, "fast_int8_femto": 0.0790,
                 "blaze_tracking": 0.5370, "branch": 0.6142, "rvm": 0.8185,
                 "u2": 0.8921,
                 # tests/test_torch_fast.py and test_torch_multiclass_natural.py,
                 # 8 steps: the plan-A MatteNetHD; the K=4 MatteNet finds none
                 # of this person (it was fitted to another synthetic scene),
                 # so its phase is held to the class means below as well
                 "fast": 0.5878, "multiclass": 0.0}
IOU_SLACK = 0.02
# The reference engine's mean of each class map over the last step's two
# streams (tests/test_torch_multiclass_natural.py::test_trained_engine_iou_720p);
# the served maps' means (each frame on half the streams) are held to them
# within CLASS_MEAN_TOL (the port on the CPU is within 1e-3)
REFERENCE_CLASS_MEANS = {"multiclass": (0.8593, 0.0725, 0.0581, 0.0101)}
CLASS_MEAN_TOL = 5e-3

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
    # the colour and blur backgrounds: the alpha does not depend on the
    # background, so each phase has its image-background phase's bar
    ("fast_int8_pico, background='color'", "fast_int8_pico", {"background": "color"}, True,
     {"trunk_int8": 1, "refine_fused": 1}, 0.5, "trunk_int8"),
    ("active, use_fused_composite=True, background='color'", "active",
     {"use_fused_composite": True, "background": "color"}, True,
     {"refine_fused": 1, "composite_fused": 1}, REFERENCE_IOU["active"] - IOU_SLACK, None),
    ("active, background='blur'", "active", {"background": "blur"}, True,
     {"refine_fused": 1}, REFERENCE_IOU["active"] - IOU_SLACK, None),
    # the trunk at the nano and femto widths with the one-class head
    ("fast_int8_nano", "fast_int8_nano", {}, True, {"trunk_int8": 1, "refine_fused": 1},
     REFERENCE_IOU["fast_int8_nano"] - IOU_SLACK, "trunk_int8_nano"),
    ("fast_int8_femto", "fast_int8_femto", {}, True, {"trunk_int8": 1, "refine_fused": 1},
     REFERENCE_IOU["fast_int8_femto"] - IOU_SLACK, "trunk_int8_femto"),
    # the reference application's other pipelines: the unfused refine chain
    # (morphology off), no counted kernel
    ("blaze_tracking", "blaze_tracking", {}, True, {},
     REFERENCE_IOU["blaze_tracking"] - IOU_SLACK, None),
    ("branch", "branch", {}, True, {}, REFERENCE_IOU["branch"] - IOU_SLACK, None),
    ("rvm", "rvm", {}, True, {}, REFERENCE_IOU["rvm"] - IOU_SLACK, None),
    ("u2", "u2", {}, True, {}, REFERENCE_IOU["u2"] - IOU_SLACK, None),
    # the float plan-A MatteNetHD over the natural frames (fast), with the
    # composite kernel too; the natural K=4 MatteNet (multiclass: no
    # counted kernel); active's bf16 refined alpha
    ("fast", "fast", {}, True, {"refine_fused": 1}, REFERENCE_IOU["fast"] - IOU_SLACK, None),
    ("fast, use_fused_composite=True", "fast", {"use_fused_composite": True}, True,
     {"refine_fused": 1, "composite_fused": 1}, REFERENCE_IOU["fast"] - IOU_SLACK, None),
    ("multiclass", "multiclass", {}, True, {}, REFERENCE_IOU["multiclass"] - IOU_SLACK, None),
    ("active, refined_dtype='bf16'", "active", {"refined_dtype": "bf16"}, True,
     {"refine_fused": 1}, REFERENCE_IOU["active"] - IOU_SLACK, None),
)
# branch: with the face path off nothing in serving sets an affine, so the
# even streams start with this 2-pixel shift (mask coordinates) and the max
# blend runs from the second step (the reference's tests prime it so too)
PRIMED_AFFINE = (1.0, 0.0, 2.0, 0.0, 1.0, -2.0)


def _counters():
    from video_stream_segmenetation_tpu_torch.kernels import (
        composite_fused,
        conv_int8,
        decoder_int8,
        refine_fused,
        stochastic_round,
        trunk_int8,
    )

    return {"trunk_int8": trunk_int8.fused_nano_trunk_alpha,
            "trunk_int8_u1": trunk_int8.fused_nano_trunk,
            "micro_trunk": trunk_int8.micro_trunk_alpha,
            "full_trunk": trunk_int8.full_trunk_alpha,
            "light_trunk": trunk_int8.light_trunk_alpha,
            "refine_fused": refine_fused.fused_temporal_refine,
            "refine_fused_fast": refine_fused.fused_temporal_refine_fast,
            "refine_fused_plane": refine_fused.fused_temporal_refine_plane,
            "fused_refine": refine_fused.fused_refine,
            "composite_fused": composite_fused.fused_composite,
            "decoder_int8": decoder_int8.fused_decoder_level,
            "conv3x3_i8_fused": conv_int8.conv3x3_i8_fused,
            "stochastic_round": stochastic_round.stochastic_round_bf16}


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
    if name == "branch":
        even = torch.as_tensor(np.arange(num_streams) % 2 == 0, device=eng.device)
        eng.state.affine[even] = torch.tensor(PRIMED_AFFINE, device=eng.device)
        eng.state.has_affine[even] = True
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
    held_composite = {}
    for t in range(steps):
        if trained:
            frames, truth = batches[t % 2]
        else:
            frames, inside = synthetic_frames(rng, base, t)
        last = t == steps - 1
        if last and statics.use_fused_composite is True:
            restore = record_composite(held_composite)
        t0 = time.perf_counter()
        try:
            out = eng.process(frames)
        finally:
            if last and statics.use_fused_composite is True:
                restore()
        if device != "cpu":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if out["passthrough"]:
            raise AssertionError(f"step {t} was served as passthrough: "
                                 f"{eng.stats()['health']}")
        applied |= out["face_applied"].cpu().numpy()
        ds = out["det_score"].cpu().numpy()
        scores.extend(ds[ds > 0].tolist())
    launches = {k: c.launches for k, c in counters.items()}
    passthrough = eng.stats()["passthrough_steps"]
    if passthrough:
        raise AssertionError(f"{passthrough} passthrough steps in a serve phase")
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
           "passthrough": passthrough,
           "det_score": float(np.mean(scores)) if scores else 0.0,
           "peak_mib": (torch.cuda.max_memory_allocated() / 2**20 if device != "cpu"
                        else None)}
    if statics.background != "image":
        res["background"] = statics.background
        res["bg_pixels"] = background_check(statics, frames, out)
    if held_composite:
        res["composite_err"] = hold_composite(held_composite)
    if multiclass:
        ca = out["class_alpha"]
        if tuple(ca.shape) != (num_streams, mh, mw, statics.num_classes) \
                or not bool(torch.isfinite(ca).all()):
            raise AssertionError(f"class_alpha {tuple(ca.shape)} not finite or misshaped")
        res["simplex_err"] = (ca.sum(-1) - 1.0).abs().max().item()
        if not res["simplex_err"] <= 1e-3:
            raise AssertionError(f"class_alpha sums to 1 only within {res['simplex_err']}")
        if trained and name in REFERENCE_CLASS_MEANS:
            res["class_means"] = ca.double().mean(dim=(0, 1, 2)).tolist()
            err = max(abs(g - w) for g, w in zip(res["class_means"],
                                                  REFERENCE_CLASS_MEANS[name]))
            if not err <= CLASS_MEAN_TOL:
                raise AssertionError(f"class map means {res['class_means']} vs the "
                                     f"reference's {REFERENCE_CLASS_MEANS[name]}: {err}")
    if trained:
        if multiclass:
            pred = (1.0 - out["class_alpha"][..., 0]).cpu().numpy() > 0.5
            step = truth.shape[1] // mh
            truth = truth[:, ::step, ::step]
        else:
            # a mask off the truth's grid (u2's 320x320) by nearest taps,
            # as tests/test_torch_zoo_720p.py scores the reference's
            th, tw = truth.shape[1:]
            pred = alpha.cpu().numpy()[:, (np.arange(th) * mh) // th][:, :, (np.arange(tw) * mw)
                                                                        // tw] > 0.5
        inter = (pred & truth).sum(axis=(1, 2))
        union = np.maximum((pred | truth).sum(axis=(1, 2)), 1)
        res["iou"] = float(np.mean(inter / union))
        if min_iou is not None and res["iou"] < min_iou:
            raise AssertionError(f"alpha IoU against the ground truth {res['iou']:.3f} "
                                 f"< {min_iou}")
        # (the multi-class step never reads face_path, as the reference's)
        if statics.face_path and not multiclass and res["applied"] == 0:
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


def record_composite(held: dict):
    """Keep the inputs of the step's next fused_composite call in ``held``
    (the call itself goes on and counts); returns the undo."""
    from video_stream_segmenetation_tpu_torch.runtime import pipeline

    orig = pipeline.fused_composite

    def rec(frames, alpha, background):
        held.setdefault("args", (frames.clone(), alpha.clone(), background.clone()))
        return orig(frames, alpha, background)

    pipeline.fused_composite = rec
    return lambda: setattr(pipeline, "fused_composite", orig)


def hold_composite(held: dict) -> int:
    """The composite kernel against its plain version on a served step's
    inputs (these launches come after the phase's counts were read)."""
    from video_stream_segmenetation_tpu_torch.kernels import composite_fused as KC
    from video_stream_segmenetation_tpu_torch.runtime.precision import pinned

    frames, alpha, bg = held["args"]
    got = KC.fused_composite(frames, alpha, bg)
    with pinned():
        want = KC.fused_composite_plain(frames, alpha.float(), bg)
    err = (got.int() - want.int()).abs().max().item()
    if err > COMPOSITE_TOL:
        raise AssertionError(f"composite kernel on a served step's inputs (background "
                             f"{tuple(bg.shape)}) disagrees with its plain version: {err}")
    return err


def background_check(statics, frames_np, out) -> int:
    """Where the served alpha upsamples to exactly 0 (every tap on a zero
    of the refined alpha), the served frame is the background: the colour
    rounded to u8, or the frame blurred.  Returns the pixels checked."""
    from video_stream_segmenetation_tpu_torch.ops.blur import gaussian_blur_auto
    from video_stream_segmenetation_tpu_torch.ops.color import denormalize_to_u8
    from video_stream_segmenetation_tpu_torch.ops.resize import interp_matrix

    fh, fw = statics.frame_hw
    alpha = out["alpha"].double()
    dev = alpha.device
    a_h = interp_matrix(fh, alpha.shape[1], "half_pixel", device=dev).double()
    a_w = interp_matrix(fw, alpha.shape[2], "half_pixel", device=dev).double()
    zero = (a_h @ alpha @ a_w.t()) == 0
    frame = out["frame"]
    if statics.background == "color":
        want = denormalize_to_u8(torch.tensor(statics.bg_color, device=dev))
        got = frame[zero]
        bad = (got != want).any(-1).sum().item()
    else:
        f = torch.as_tensor(frames_np, device=dev)
        bg = denormalize_to_u8(gaussian_blur_auto(f.float() / 255.0, statics.bg_blur_sigma))
        bad = (frame[zero] != bg[zero]).any(-1).sum().item()
    checked = int(zero.sum().item())
    if checked == 0 or bad:
        raise AssertionError(f"background='{statics.background}': {bad} of {checked} "
                             "pixels where the alpha is 0 are not the background")
    return checked


# the production rotation: 400 streams as 4 x 96 + 16, the fast refine's
# inputs from the native pool (the reference's ARCHITECTURE.md
# "Production serving")
ROTATION = (96, 96, 96, 96, 16)
FAST_ROUTE = {"refine_alpha_src": "lowres", "guide_kernel_unfold": True, "guide_source": "host"}
ROUNDS = 8


def _iou(alpha, truth) -> float:
    pred = alpha.float().cpu().numpy() > 0.5
    inter = (pred & truth).sum(axis=(1, 2))
    union = np.maximum((pred | truth).sum(axis=(1, 2)), 1)
    return float(np.mean(inter / union))


def rotation(device, sizes, overrides, rounds: int, fused: bool = True,
             min_interval=None, sync_check: bool = False) -> dict:
    """Serve ``fast_int8_pico`` (with ``overrides``, trained weights) through
    the port's StreamScheduler over its native FramePool, streams in groups
    of ``sizes``, the committed 720p frames pushed per stream and round
    (frame (s + r) % 2), ``rounds`` rounds: with ``fused`` through
    step_round (the first call primes, a drain collects the last round),
    else per-group step_pipelined (dispatch_range) and a drain.
    Returns the launches of the run, per round the streams the face path
    was applied to, the times, the last round's alpha (all streams, in
    slot order), IoU and the engine.  With ``sync_check`` one more round's
    step runs, after its ingest, under torch.cuda.set_sync_debug_mode
    ('error'): a host synchronisation inside the round raises."""
    from video_stream_segmenetation_tpu_torch import bridge
    from video_stream_segmenetation_tpu_torch.runtime.presets import preset
    from video_stream_segmenetation_tpu_torch.runtime.scheduler import StreamScheduler
    from video_stream_segmenetation_tpu_torch.service.engine import Engine

    statics = preset("fast_int8_pico", **overrides)
    n = sum(sizes)
    fh, fw = FRAME_HW
    eng = Engine(n, statics, **bridge.trained_weights(statics), device=device)
    if min_interval is not None:
        eng.face_min_interval_s = min_interval
    sched = StreamScheduler(eng, group_sizes=list(sizes), fused_rounds=fused)
    if sched.pool is None:
        raise AssertionError(f"the native FramePool did not build ({sched.pool_error!r}): "
                             "the scheduler fell back to host arrays")
    sched.admit_all()
    grad = np.linspace(0, 255, fw, dtype=np.float32)[None, :, None]
    for s in range(n):
        eng.set_background(s, np.broadcast_to(grad * ((s % 3) + 1) / 3.0,
                                              (fh, fw, 3)).astype(np.uint8))
    clip, gt = bridge.load_frames()
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    counters = _counters()
    for c in counters.values():
        c.launches = 0

    def push(r):
        for s in range(n):
            sched.push_frame(s, clip[(s + r) % 2])

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    applied, last, periods, latencies = [], {}, [], []

    def take(results):
        hit = np.zeros((n,), bool)
        if any(res["passthrough"] for res in results):
            raise AssertionError(f"a rotation round was served as passthrough: "
                                 f"{eng.stats()['health']}")
        for res in results:
            i0, i1 = res["slots"]
            hit[i0:i1] = res["face_applied"].cpu().numpy()
            last[i0] = res
        applied.append(hit)

    t_start = time.perf_counter()
    if fused:
        for r in range(rounds):
            push(r)
            tok = sched._inflight
            t0 = time.perf_counter()
            outs = sched.step_round()
            t1 = time.perf_counter()
            periods.append((t1 - t0) * 1e3)
            if outs is not None:
                latencies.append((t1 - tok["t0"]) * 1e3)
                take(outs)
        take(sched.drain())
    else:
        for r in range(rounds):
            push(r)
            round_res = []
            t0 = time.perf_counter()
            for _ in range(len(sizes)):
                out = sched.step_pipelined()
                if out is not None:
                    round_res.append(out)
            periods.append((time.perf_counter() - t0) * 1e3)
            if round_res:
                take(round_res)
        take([sched.drain()])
    last_round = rounds - 1
    sync()
    wall_s = time.perf_counter() - t_start
    launches = {k: c.launches for k, c in counters.items()}
    alpha = torch.cat([last[i0]["alpha"] for i0 in sorted(last)])
    truth = gt[(np.arange(n) + last_round) % 2] > 127
    res = {"engine": eng, "sched": sched, "sizes": list(sizes), "launches": launches,
           "applied": applied,
           "alpha": alpha, "iou": _iou(alpha, truth), "periods_ms": periods,
           "latencies_ms": latencies, "wall_s": wall_s,
           "peak_mib": (torch.cuda.max_memory_allocated() / 2**20 if device != "cpu"
                        else None), "pool_lanes": sched.pool.num_lanes,
           "health": eng.stats()["health"]["state"]}
    if sync_check:
        # one more round, its parts timed apart: the pool's assemble (pack
        # and lanes, host), the ingest (host -> device), the round step
        push(rounds)
        offs = sched.group_offsets
        sync()
        t0 = time.perf_counter()
        host = [sched._group_frames(offs[g], offs[g + 1])[0] for g in range(len(sizes))]
        t1 = time.perf_counter()
        step_frames = [eng._ingest(f, rows=offs[g + 1] - offs[g])[1]
                       for g, f in enumerate(host)]
        sync()
        t2 = time.perf_counter()
        # the checked round takes the recovery snapshot too
        eng._dispatches = 0
        pending = eng._snap_pending
        if device != "cpu":
            torch.cuda.set_sync_debug_mode("error")
        try:
            eng.round_step(list(sizes), step_frames, time.monotonic())
            t3 = time.perf_counter()
        finally:
            if device != "cpu":
                torch.cuda.set_sync_debug_mode("default")
        if eng._snap_pending is pending:
            raise AssertionError("the sync-checked round took no recovery snapshot")
        sync()
        t4 = time.perf_counter()
        res["parts_ms"] = {"assemble": (t1 - t0) * 1e3, "ingest": (t2 - t1) * 1e3,
                           "round_enqueue": (t3 - t2) * 1e3, "round": (t4 - t2) * 1e3}
    return res


REFINE_FORMS = ("fused_temporal_refine", "fused_temporal_refine_plane",
                "fused_temporal_refine_fast")


def hold_round(res, r: int) -> dict:
    """One more round of a :func:`rotation`'s engine (frames of round
    ``r``) through its round step, keeping the inputs of the trunk and of
    the temporal refine of the first group of each size; then each kernel
    against its plain version on those inputs, at the shapes the serving
    loop gave it, at the kernels phase's tolerances.  Its launches come
    after the rotation's counts were read.  Returns {(counter, S): error}
    (the refine's error the larger of new_prev's and the refined alpha's)."""
    from video_stream_segmenetation_tpu_torch import bridge
    from video_stream_segmenetation_tpu_torch.kernels import refine_fused as TR
    from video_stream_segmenetation_tpu_torch.ops.warp import separable_warp_indices
    from video_stream_segmenetation_tpu_torch.runtime import pipeline
    from video_stream_segmenetation_tpu_torch.runtime.precision import pinned

    eng, sched, sizes = res["engine"], res["sched"], res["sizes"]
    model = eng.model
    clip, _ = bridge.load_frames()
    for s in range(eng.num_streams):
        sched.push_frame(s, clip[(s + r) % 2])
    offs = sched.group_offsets
    step_frames = [eng._ingest(sched._group_frames(offs[g], offs[g + 1])[0],
                               rows=offs[g + 1] - offs[g])[1] for g in range(len(sizes))]
    calls = {}

    def keep(a):
        return a.clone() if isinstance(a, torch.Tensor) else a

    def recorder(name, fn):
        def rec(*args, **kw):
            key = (name, int(args[0].shape[0]))
            if key not in calls:
                calls[key] = ([keep(a) for a in args], {k: keep(v) for k, v in kw.items()})
            return fn(*args, **kw)
        return rec

    origs = {n: getattr(pipeline, n) for n in REFINE_FORMS}
    for n, fn in origs.items():
        setattr(pipeline, n, recorder(n, fn))
    model.trunk_logits = recorder("trunk", model.trunk_logits)
    try:
        eng.round_step(sizes, step_frames, time.monotonic())
    finally:
        for n, fn in origs.items():
            setattr(pipeline, n, fn)
        del model.trunk_logits
    held = {}
    for (name, s), (args, kw) in sorted(calls.items()):
        if name == "trunk":
            err = trunk_err(model, args[0])
            tol = TRUNK_TOL
            held[("trunk_int8", s)] = err
            if not err <= tol:
                raise AssertionError(f"trunk kernel at S={s} disagrees with its plain version "
                                     f"on the serving loop's input: {err}")
            continue
        (alpha, prev, affine, use_warp, initialized, wb, guide, prior, has_prior,
         knobs) = args
        out_dtype = kw.get("out_dtype", torch.bfloat16)
        plane = prior if name == "fused_temporal_refine_plane" else None
        params = torch.zeros((s, 4), device=prev.device) if plane is not None else prior
        h, w = prev.shape[-2:]
        yi, xi = separable_warp_indices(affine, (h, w))
        table = TR.scalar_table(knobs, use_warp, initialized, wb, params, has_prior)
        with pinned():
            got_prev, got = getattr(TR, name)(*args, **kw)
            want_prev, want = TR.fused_temporal_refine_plain(
                alpha, prev, yi, xi, guide, table, out_dtype, plane,
                kw.get("alpha_lowres_hw"), kw.get("guide_lanes_geom"))
        err_prev = (got_prev - want_prev).abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        tol = REFINED_TOL if out_dtype == torch.bfloat16 else REFINED_F32_TOL
        counter = {"fused_temporal_refine": "refine_fused",
                   "fused_temporal_refine_plane": "refine_fused_plane",
                   "fused_temporal_refine_fast": "refine_fused_fast"}[name]
        held[(counter, s)] = max(err_prev, err)
        if not (err_prev <= PREV_TOL and err <= tol):
            raise AssertionError(f"{counter} at S={s} disagrees with its plain version on the "
                                 f"serving loop's inputs: {err_prev}, {err}")
    missing = {("trunk_int8", g) for g in sizes} - held.keys()
    if missing:
        raise AssertionError(f"held round: no trunk input kept for {missing}")
    return held


def phase_production(device, sizes=ROTATION, rounds=ROUNDS) -> dict:
    """Phase A: the production rotation (fast refine, host lanes, fused
    rounds) at full size, with its assertions; returns :func:`rotation`'s
    figures."""
    n = sum(sizes)
    # one priming round, then the timed ones
    res = rotation(device, sizes, FAST_ROUTE, rounds + 1, fused=True, sync_check=True)
    eng = res["engine"]
    if res["pool_lanes"] != 48:
        raise AssertionError(f"the pool emits {res['pool_lanes']} guide lanes, not 48")
    if not (eng.host_lanes and eng.routing["use_lowres_alpha"]):
        raise AssertionError(f"the fast route is not taken: {eng.routing}")
    served = rounds + 1
    want = {"trunk_int8": len(sizes) * served, "refine_fused_fast": len(sizes) * served}
    for counter, got in res["launches"].items():
        if got != want.get(counter, 0):
            raise AssertionError(f"production rotation: {counter} launched {got} times in "
                                 f"{served} rounds, expected {want.get(counter, 0)}")
    per_round = [int(a.sum()) for a in res["applied"]]
    union = np.logical_or.reduce(res["applied"][:6])
    k_sum = sum(-(-g // eng.statics.lmk_interval) for g in sizes)
    if not (min(per_round) >= n / eng.statics.lmk_interval / 2 and max(per_round) <= k_sum
            and union.sum() >= 0.9 * n):
        raise AssertionError(f"face path applied on {per_round} streams a round (at most "
                             f"{k_sum}), {int(union.sum())} of {n} over six rounds")
    if res["iou"] < 0.5:
        raise AssertionError(f"production rotation: alpha IoU {res['iou']:.4f} < 0.5")
    if not bool(torch.isfinite(res["alpha"].float()).all()) or res["alpha"].dtype != \
            torch.bfloat16 or tuple(res["alpha"].shape) != (n, *eng.statics.mask_hw):
        raise AssertionError(f"alpha {tuple(res['alpha'].shape)} {res['alpha'].dtype}")
    res["per_round"] = per_round
    res["union6"] = int(union.sum())
    res["held"] = hold_round(res, rounds + 2)
    if {("refine_fused_fast", g) for g in sizes} - res["held"].keys():
        raise AssertionError(f"production rotation: the held round kept {res['held']}")
    return res


# Phase B's bars: prev_alpha (f32 state; the two routes' upsample differ
# by ulps), the refined alpha (one bf16 step plus the gamma's x^0.4 near
# the noise cutoff), the foreground IoU
ROUTE_PREV_TOL = 1e-5
ROUTE_ALPHA_TOL = 1e-2
ROUTE_IOU_TOL = 1e-3


def phase_routes(device, sizes=(24, 24, 16), rounds=ROUNDS) -> dict:
    """Phase B: the same frames through (i) the production route with
    fused rounds and (ii) fast_int8_pico as its preset stands under
    per-group step_pipelined, face_min_interval_s=0 on both; the states
    and alphas agree."""
    a = rotation(device, sizes, FAST_ROUTE, rounds, fused=True, min_interval=0.0)
    b = rotation(device, sizes, {}, rounds, fused=False, min_interval=0.0)
    for label, res, counter in (("fused, fast route", a, "refine_fused_fast"),
                                ("pipelined, preset", b, "refine_fused")):
        want = {"trunk_int8": len(sizes) * rounds, counter: len(sizes) * rounds}
        for c, got in res["launches"].items():
            if got != want.get(c, 0):
                raise AssertionError(f"routes ({label}): {c} launched {got} times, "
                                     f"expected {want.get(c, 0)}")
    prev_err = (a["engine"].state.prev_alpha - b["engine"].state.prev_alpha).abs().max().item()
    alpha_err = (a["alpha"].float() - b["alpha"].float()).abs().max().item()
    iou_err = abs(a["iou"] - b["iou"])
    if not torch.equal(a["engine"].state.frame_idx, b["engine"].state.frame_idx):
        raise AssertionError("routes: the two schedulers served different frame counts")
    if not (prev_err <= ROUTE_PREV_TOL and alpha_err <= ROUTE_ALPHA_TOL
            and iou_err <= ROUTE_IOU_TOL):
        raise AssertionError(f"routes disagree: prev_alpha {prev_err}, alpha {alpha_err}, "
                             f"IoU {a['iou']} vs {b['iou']}")
    held = hold_round(a, rounds)
    for key, err in hold_round(b, rounds).items():
        held[key] = max(err, held.get(key, 0.0))
    return {"a": a, "b": b, "prev_err": prev_err, "alpha_err": alpha_err,
            "iou_err": iou_err, "held": held}


def _pico_engine(device, num_streams: int | None = None, **kw):
    """Engine(fast_int8_pico) at 720p (statics overrides and Engine options
    in ``kw``), the committed trained weights loaded through its numpy
    loaders, every slot admitted, gradient backgrounds."""
    from video_stream_segmenetation_tpu_torch.bridge import WEIGHTS_DIR
    from video_stream_segmenetation_tpu_torch.runtime.presets import preset
    from video_stream_segmenetation_tpu_torch.service.engine import Engine

    num_streams = num_streams or S
    opts = {k: kw.pop(k) for k in ("output_layout", "collect_sync") if k in kw}
    eng = Engine(num_streams, preset("fast_int8_pico", **kw), device=device, **opts)
    eng.load_matting_params(WEIGHTS_DIR / "mattenet_hd10_pico.npz")
    eng.load_face_params(WEIGHTS_DIR / "facefinder_128.npz", WEIGHTS_DIR / "landmarknet_128.npz")
    eng.admit_all()
    fh, fw = FRAME_HW
    grad = np.linspace(0, 255, fw, dtype=np.float32)[None, :, None]
    for s in range(num_streams):
        eng.set_background(s, np.broadcast_to(grad * ((s % 3) + 1) / 3.0,
                                              (fh, fw, 3)).astype(np.uint8))
    return eng


def _committed(num_streams: int, t: int = 0):
    """The committed frames for ``num_streams`` streams (stream s takes
    frame (s + t) % 2) and their ground truth at the mask grid."""
    from video_stream_segmenetation_tpu_torch import bridge

    clip, gt = bridge.load_frames()
    order = (np.arange(num_streams) + t) % 2
    return clip[order], gt[order] > 127


def expect_passthrough(eng, out: dict, frames_in) -> None:
    """A passthrough result: the input frames byte for byte, alpha f32
    ones, no face applied."""
    mh, mw = eng.statics.mask_hw
    want = torch.as_tensor(np.asarray(frames_in)).to(out["frame"].device)
    a = out["alpha"]
    if not (out["passthrough"] and torch.equal(out["frame"], want)
            and a.dtype == torch.float32 and tuple(a.shape) == (want.shape[0], mh, mw)
            and bool((a == 1).all()) and not bool(out["face_applied"].any())):
        raise AssertionError(f"not a passthrough: passthrough={out['passthrough']}, frame "
                             f"{tuple(out['frame'].shape)}, alpha {a.dtype} "
                             f"{tuple(a.shape)}")


def _refused_launch(device):
    """A step that a kernel's C entry point refuses: the int8 alpha head
    with Cin % 4 != 0 (kernels/_build.py::check raises)."""
    from video_stream_segmenetation_tpu_torch.kernels import _build

    def step(*args):
        lib = _build.library()
        _build.check(lib, lib.vst_alpha_head_i8(None, None, None, None, None, 1, 1, 1, 3, 1,
                                                torch.cuda.current_stream(device).cuda_stream),
                     "alpha head")
    return step


def _out_of_memory(device):
    def step(*args):
        torch.empty(1 << 46, dtype=torch.uint8, device=device)  # 64 TiB
    return step


def phase_degrade(device) -> dict:
    """Passthrough degradation on fast_int8_pico at 720p, S=64, trained
    weights: the step replaced by one that raises, through process and
    through dispatch/collect: the first two failures are passthrough, health
    reads 'degraded' after the third, a fourth call serves passthrough
    without running the step; the step restored and the probe due, the
    probe serves and health reads 'ok'.  Then one real failure on the
    card each of an out-of-memory and a launch the C entry point refuses,
    each followed by a served step."""
    eng = _pico_engine(device)
    frames, truth = _committed(S)
    out = eng.process(frames)
    if out["passthrough"] or _iou(out["alpha"], truth) < 0.5:
        raise AssertionError(f"degrade: the first step was not served well "
                             f"({out['passthrough']}, IoU {_iou(out['alpha'], truth)})")
    real = eng._step
    calls = []

    def broken(*args):
        calls.append(1)
        raise RuntimeError("injected step failure")

    res = {}
    for label, run in (("process", lambda: eng.process(frames)),
                       ("dispatch/collect", lambda: eng.collect(eng.dispatch(frames)))):
        eng._step = broken
        calls.clear()
        states = []
        for _ in range(4):
            expect_passthrough(eng, run(), frames)
            states.append(eng.health.state.value)
        if states != ["ok", "ok", "degraded", "degraded"] or len(calls) != 3:
            raise AssertionError(f"degrade ({label}): health {states}, step ran "
                                 f"{len(calls)} times for 4 calls")
        eng._step = real
        eng.health._degraded_at = 0.0  # the probe is due
        out = run()
        if out["passthrough"] or eng.health.state.value != "ok":
            raise AssertionError(f"degrade ({label}): the probe did not serve")
        res[label] = states
    for label, step in (("out of memory", _out_of_memory(device)),
                        ("refused launch", _refused_launch(device))):
        eng._step = step
        expect_passthrough(eng, eng.process(frames), frames)
        err = eng.health.last_error
        eng._step = real
        out = eng.process(frames)
        if out["passthrough"] or eng.health.state.value != "ok":
            raise AssertionError(f"degrade ({label}): no served step after it ({err})")
        res[label] = err
    res["iou"] = _iou(out["alpha"], truth)
    res["passthrough"] = eng.stats()["passthrough_steps"]
    res["engine"] = eng
    return res


def _http(port: int, method: str, path: str, body=None):
    """One request to the control server on localhost (http.client: no
    proxy is consulted)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, body=data, headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def phase_render(eng) -> dict:
    """The personalised backgrounds (background/render.py, PIL) at 720p:
    each sample template at each privacy level, rendered and set as stream
    backgrounds; a served step over them.  Returns the renderers by slot
    (slot 0: the demo employee's default template) and the figures."""
    from video_stream_segmenetation_tpu_torch import background as bgm

    data = bgm.sample_app_data()
    rendered, times = {}, []
    slot = 0
    for tid, template in data.templates.items():
        for level in ("low", "medium", "high"):
            r = bgm.BackgroundRenderer(template, data.employees["demo"], privacy=level,
                                       canvas_hw=FRAME_HW)
            t0 = time.perf_counter()
            img = r.render()
            times.append((time.perf_counter() - t0) * 1e3)
            if img.shape != (*FRAME_HW, 3) or img.dtype != np.uint8 or not img.any():
                raise AssertionError(f"render {tid}/{level}: {img.shape} {img.dtype}")
            rendered[(tid, level)] = img
            eng.set_background(slot % eng.num_streams, img)
            slot += 1
    # each level up shows more of badge_left's layers
    badge = [rendered[("badge_left", lv)] for lv in ("low", "medium", "high")]
    if np.array_equal(badge[0], badge[1]) or np.array_equal(badge[1], badge[2]):
        raise AssertionError("render: a privacy level renders what the level below does")
    painted = {f"{tid}/{lv}": int((img.sum(-1) > 0).sum()) for (tid, lv), img in rendered.items()}
    frames, _ = _committed(S)
    if eng.process(frames)["passthrough"]:
        raise AssertionError("render: the step over the rendered backgrounds passed through")
    emp = data.employees["demo"]
    renderers = {0: bgm.BackgroundRenderer(data.templates[emp.default_template_id], emp,
                                           canvas_hw=FRAME_HW)}
    return {"renderers": renderers, "painted": painted, "render_ms": times}


def phase_server(eng, renderers) -> dict:
    """The control server (service/server.py) on the degrade phase's engine
    at 127.0.0.1 on a free port: /stats, /healthz (503 while degraded),
    knobs, reset, a background colour, the privacy level and a template
    (re-rendered) between served steps."""
    from video_stream_segmenetation_tpu_torch.service.server import ControlServer

    frames, _ = _committed(S)
    real = eng._step
    seen = {}
    srv = ControlServer(eng, renderers=renderers).start()
    try:
        code, body = _http(srv.port, "GET", "/stats")
        if code != 200 or not {"fps", "health", "passthrough_steps"} <= set(body):
            raise AssertionError(f"/stats: {code} {sorted(body)}")
        seen["/healthz ok"] = _http(srv.port, "GET", "/healthz")

        def broken(*args):
            raise RuntimeError("injected step failure")

        eng._step = broken
        for _ in range(3):
            eng.process(frames)
        seen["/healthz degraded"] = _http(srv.port, "GET", "/healthz")
        eng._step = real
        eng.health._degraded_at = 0.0
        eng.process(frames)
        seen["/healthz probed"] = _http(srv.port, "GET", "/healthz")
        if [c for c, _ in seen.values()] != [200, 503, 200] \
                or seen["/healthz degraded"][1] != {"state": "degraded"}:
            raise AssertionError(f"/healthz: {seen}")
        slot = 3
        code, _ = _http(srv.port, "POST", f"/streams/{slot}/knobs",
                        {"gamma": 1.9, "use_bilateral": False})
        served = [eng.process(frames)]
        gamma = eng.knobs.gamma[slot].item()
        code2, _ = _http(srv.port, "POST", f"/streams/{slot}/reset")
        served.append(eng.process(frames))
        gamma_reset = eng.knobs.gamma[slot].item()
        code3, _ = _http(srv.port, "POST", f"/streams/{slot}/background",
                         {"color": [10, 200, 30]})
        bg = eng.backgrounds[slot]
        served.append(eng.process(frames))
        code4, streams = _http(srv.port, "GET", "/streams")
        if (code, code2, code3, code4) != (200,) * 4 or abs(gamma - 1.9) > 1e-6 \
                or abs(gamma_reset - 0.4) > 1e-6 or any(o["passthrough"] for o in served) \
                or not bool((bg.reshape(-1, 3) == torch.tensor([10, 200, 30], device=bg.device,
                                                               dtype=torch.uint8)).all()) \
                or len(streams["streams"]) != S:
            raise AssertionError(f"control server: codes {(code, code2, code3, code4)}, gamma "
                                 f"{gamma} then {gamma_reset}")
        seen["knobs gamma"] = gamma
        seen["reset gamma"] = gamma_reset
        seen["streams"] = streams["streams"][slot]
        before = eng.backgrounds[0].clone()
        seen["privacy high"] = _http(srv.port, "POST", "/streams/0/privacy", {"level": "high"})
        after_privacy = eng.backgrounds[0].clone()
        seen["template"] = _http(srv.port, "POST", "/streams/0/background",
                                 {"template_id": "minimal_center"})
        out = eng.process(frames)
        if seen["privacy high"][0] != 200 or seen["template"][0] != 200 \
                or torch.equal(before, after_privacy) \
                or torch.equal(after_privacy, eng.backgrounds[0]) or out["passthrough"]:
            raise AssertionError(f"control server: privacy {seen['privacy high']}, template "
                                 f"{seen['template']}")
    finally:
        srv.stop()
    return seen


def phase_chunked_packed(device) -> dict:
    """process_chunked(frames, S/4) against process on a second engine from
    the same weights (face_batch=S: every firing stream's face round runs
    whatever the chunk, which process_chunked's compaction per chunk would
    otherwise change; face_min_interval_s=0), element by element over 3
    steps; then output_layout='packed' after depth_to_space against
    'natural', byte for byte over 2 steps."""
    from video_stream_segmenetation_tpu_torch.ops.layout import depth_to_space

    res = {}
    a, b = (_pico_engine(device, face_batch=S) for _ in range(2))
    for e in (a, b):
        e.face_min_interval_s = 0.0
    diffs, applied = [], 0
    for t in range(3):
        frames, _ = _committed(S, t)
        oa, ob = a.process(frames), b.process_chunked(frames, S // 4)
        applied += int(ob["face_applied"].sum().item())
        for k in ("frame", "alpha", "face_applied", "det_score", "face_prior_params"):
            if not torch.equal(oa[k], ob[k]):
                diffs.append((t, k, (oa[k].float() - ob[k].float()).abs().max().item()))
        if oa["passthrough"] or ob["passthrough"]:
            raise AssertionError("chunked: a step was served as passthrough")
    for k in ("prev_alpha", "affine", "has_affine", "frame_idx"):
        if not torch.equal(getattr(a.state, k), getattr(b.state, k)):
            diffs.append(("state", k, (getattr(a.state, k).float()
                                       - getattr(b.state, k).float()).abs().max().item()))
    if diffs:
        raise AssertionError(f"process_chunked({S // 4}) differs from process: {diffs}")
    res["chunked_applied"] = applied
    del a, b
    n, p = _pico_engine(device), _pico_engine(device, output_layout="packed")
    for e in (n, p):
        e.face_min_interval_s = 0.0
    for t in range(2):
        frames, _ = _committed(S, t)
        on, op = n.process(frames), p.process(frames)
        if tuple(op["frame"].shape) != (S, FRAME_HW[0] // 10, FRAME_HW[1] // 10, 300) \
                or not torch.equal(
                depth_to_space(op["frame"], 10), on["frame"]):
            raise AssertionError(f"output_layout='packed' ({tuple(op['frame'].shape)}) is "
                                 "not the natural frames packed")
    res["packed_shape"] = tuple(op["frame"].shape)
    return res


def phase_api(device, active_iou: float) -> dict:
    """api.segment / composite (colour, blur, image) / process_frame on the
    committed 720p frames with the trained weights/mattenet.npz: the mask
    IoU at most IOU_SLACK below the reference's segment and below the
    active serve phase (the model's alpha without the refine scores above
    the engine's: 0.6690 against 0.6401 on an H100 80GB HBM3 at 700 W);
    with the mask made hard, where it upsamples to 0 the colour composite
    is the colour and the blur composite the blurred frame; process_frame
    equals segment then composite, for a batch and for one frame."""
    from video_stream_segmenetation_tpu_torch import api
    from video_stream_segmenetation_tpu_torch.ops.blur import gaussian_blur_auto
    from video_stream_segmenetation_tpu_torch.ops.color import denormalize_to_u8
    from video_stream_segmenetation_tpu_torch.ops.resize import resize_bilinear

    frames, truth = _committed(2)
    mask = api.segment(frames, device=device)
    if tuple(mask.shape) != (2, 288, 512) or mask.dtype != torch.float32 \
            or mask.device.type != torch.device(device).type \
            or not bool(torch.isfinite(mask).all()):
        raise AssertionError(f"segment: {tuple(mask.shape)} {mask.dtype} {mask.device}")
    iou = _iou(mask, truth)
    least = max(REFERENCE_IOU["api"], active_iou) - IOU_SLACK
    if iou < least:
        raise AssertionError(f"segment: IoU {iou:.4f} < {least:.4f} (the reference's segment "
                             f"{REFERENCE_IOU['api']}, the active phase {active_iou:.4f})")
    fh, fw = FRAME_HW
    # the mask made hard, so that the composite has pixels of pure
    # background to check (the model's sigmoid is never exactly 0)
    hard = (mask > 0.5).float()
    zero = resize_bilinear(hard, (fh, fw), method="half_pixel", channel_last=False) == 0
    color = (20 / 255, 25 / 255, 30 / 255)
    out_c = api.composite(frames, hard, color, device=device)
    out_b = api.composite(frames, hard, bg_blur_sigma=8.0, device=device)
    grad = np.linspace(0, 255, 640, dtype=np.float32)[None, :, None]
    image = np.broadcast_to(grad, (360, 640, 3)).astype(np.uint8)
    out_i = api.composite(frames, mask, image, device=device)
    pf_out, pf_mask = api.process_frame(frames, background=image, device=device)
    one, one_mask = api.process_frame(frames[0], background=color, device=device)
    one_seg = api.segment(frames[0], device=device)
    one_comp = api.composite(frames[0], one_seg, color, device=device)
    f = torch.as_tensor(frames, device=mask.device)
    blurred = denormalize_to_u8(gaussian_blur_auto(f.float() / 255.0, 8.0))
    want_c = torch.tensor([20, 25, 30], dtype=torch.uint8, device=mask.device)
    checks = {
        "colour where the mask is 0": bool((out_c[zero] == want_c).all()),
        "blur where the mask is 0": torch.equal(out_b[zero], blurred[zero]),
        "process_frame = segment + composite": torch.equal(pf_mask, mask)
        and torch.equal(pf_out, out_i),
        "one frame": tuple(one.shape) == (fh, fw, 3) and tuple(one_mask.shape) == (288, 512)
        and torch.equal(one_mask, one_seg) and torch.equal(one, one_comp),
        "u8 frames": all(o.dtype == torch.uint8 and tuple(o.shape) == (2, fh, fw, 3)
                         for o in (out_c, out_b, out_i)),
    }
    if not all(checks.values()) or int(zero.sum()) == 0:
        raise AssertionError(f"api: {checks}, {int(zero.sum())} zero-mask pixels")
    return {"iou": iou, "zero_pixels": int(zero.sum()), "checks": checks}


def phase_rotation_failure(res: dict) -> dict:
    """On the production rotation's engine and scheduler (phase A's), one
    round made to fail after its first two groups wrote their rows:
    collect_round serves every group's input (the pool's packed frames) as
    passthrough; the state is restored from the snapshot the failing
    dispatch took (affine, has_affine and frame_idx equal to it and to the
    state before the round, read back once here; the EMA cold); the next
    three rounds are served; then one more round's step, its snapshot
    included, under set_sync_debug_mode('error')."""
    from video_stream_segmenetation_tpu_torch.ops.layout import space_to_depth

    eng, sched, sizes = res["engine"], res["sched"], res["sizes"]
    n = sum(sizes)
    offs = sched.group_offsets
    clip, gt = _committed(2)

    def push(r):
        for s in range(n):
            sched.push_frame(s, clip[(s + r) % 2])

    torch.cuda.synchronize()
    cheap = eng._CHEAP_FIELDS
    before = {k: getattr(eng.state, k).clone() for k in cheap}
    real_for, real_recover = eng._round_step_for, eng._recover_state
    kept = {}

    def failing_for(group_sizes):
        def round_fails(full_state, frames_list, bgs, knobs, face_last, now, mi):
            for g in range(2):
                eng._range_step(full_state, offs[g], frames_list[g], bgs, knobs, face_last,
                                now, mi, sizes[g])
            raise RuntimeError("injected failure in the round's third group")
        return round_fails

    def recover():
        kept["snap"] = eng._snap_pending
        real_recover()

    eng._round_step_for, eng._recover_state = failing_for, recover
    eng._dispatches = 0  # the failing dispatch takes the snapshot
    passthrough0 = eng.passthrough_steps
    try:
        push(0)
        if sched.step_round() is not None:
            raise AssertionError("rotation failure: a round was in flight")
        outs = sched.drain()
    finally:
        eng._round_step_for, eng._recover_state = real_for, real_recover
    for g, out in enumerate(outs):
        i0, i1 = offs[g], offs[g + 1]
        want = space_to_depth(torch.as_tensor(clip[(np.arange(i0, i1)) % 2]), 10)
        expect_passthrough(eng, out, want.numpy())
    snap = kept.get("snap")
    if snap is None or snap["kind"] != "cheap_packed":
        raise AssertionError(f"rotation failure: no cheap snapshot was restored ({snap})")
    from_snap = eng._cheap_unpack(snap["host"]["packed"])
    st = eng.state
    for k in cheap:
        got = getattr(st, k)
        if not (torch.equal(got.cpu(), from_snap[k]) and torch.equal(got, before[k])):
            raise AssertionError(f"rotation failure: {k} is not the snapshot's")
    if bool(st.prev_alpha.any()) or bool(st.initialized.any()):
        raise AssertionError("rotation failure: the EMA is not cold after the recovery")
    h = eng.health.snapshot()
    if (h["state"], h["consecutive_failures"]) != ("ok", 1):
        raise AssertionError(f"rotation failure: health {h}")
    served = []
    for r in range(1, 4):
        push(r)
        got = sched.step_round()
        if got is not None:
            served.append(got)
    served.append(sched.drain())
    ious = []
    for r, outs in enumerate(served, start=1):
        if any(o["passthrough"] for o in outs):
            raise AssertionError("rotation failure: a round after the recovery passed through")
        alpha = torch.cat([o["alpha"] for o in outs])
        ious.append(_iou(alpha, gt[(np.arange(n) + r) % 2]))
    if eng.passthrough_steps - passthrough0 != len(sizes) or min(ious) < 0.5:
        raise AssertionError(f"rotation failure: {eng.passthrough_steps - passthrough0} "
                             f"passthrough results, IoU {ious}")
    # one more round's step with its snapshot, no host sync allowed
    push(4)
    host = [sched._group_frames(offs[g], offs[g + 1])[0] for g in range(len(sizes))]
    step_frames = [eng._ingest(f, rows=offs[g + 1] - offs[g])[1] for g, f in enumerate(host)]
    torch.cuda.synchronize()
    eng._dispatches = 0
    pending = eng._snap_pending
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.round_step(list(sizes), step_frames, time.monotonic())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if eng._snap_pending is pending:
        raise AssertionError("rotation failure: the checked round took no snapshot")
    return {"ious": ious, "health": eng.health.snapshot()["state"],
            "frame_idx": before["frame_idx"][:3].tolist()}


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
    return trunk_err(model, model.stem(fp))


def trunk_err(model, x0) -> float:
    """:func:`trunk_vs_plain` on the stem output ``x0``."""
    from video_stream_segmenetation_tpu_torch.kernels import trunk_int8 as TK
    from video_stream_segmenetation_tpu_torch.models import quantized as Q

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



# the train phase: tools/train_flagship.py's pico job at fewer steps
TRAIN_STEPS, FT_STEPS = 20, 5
STEP_HW, STEP_BATCH = (240, 320), 4
# one step's forward and backward on the card against the CPU, the same
# tree and batch: bf16 (the trained dtype) by the loss within 1e-2 relative
# and a gradient cosine of at least 0.99 a leaf (cuDNN and the CPU round
# their bf16 convolutions' sums at other places; the JAX-vs-port bars of
# tests/test_torch_train.py); f32 with TF32 off by the loss within 1e-4 and
# each leaf's gradient within 1e-3 relative L2 (cuDNN's f32 algorithms sum
# in other orders than the CPU's, through a whole backward pass)
STEP_BF16_LOSS_TOL, STEP_BF16_COS = 1e-2, 0.99
STEP_F32_LOSS_TOL, STEP_F32_GRAD_TOL = 1e-4, 1e-3
# then one whole train_step in f32 on each side (the clip, AdamW's moments,
# its bias correction and decay on every leaf, the update applied): each
# leaf's first and second moments and its update (the parameter after less
# before) within 1e-3 relative L2 of the CPU's.  The moments carry the
# clipped gradients' gap (~1e-6); the first update is near lr * sign(g), so
# it departs only where a gradient near 0 changes sign, and by the rounding
# of p + u in f32 (an ulp of p, ~1e-5 of u)
STEP_F32_UPDATE_TOL = 1e-3


def fit_timed(model, **fit_kw) -> dict:
    """``train.loop.fit`` on the card with a CUDA event after every step:
    the trained tree, the history, each step's losses and grad_norm, the
    ms between consecutive steps' ends (the batch's generation and the
    step), the peak device memory."""
    from video_stream_segmenetation_tpu_torch.train.loop import fit

    events, seen = [], []

    def on_step(i, metrics):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        seen.append(torch.stack([metrics["loss"], metrics["grad_norm"]]))

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tree, history = fit(model, on_step=on_step, **fit_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    loss, gnorm = torch.stack(seen).cpu().numpy().T
    return {"tree": tree, "history": history, "loss": loss, "grad_norm": gnorm,
            "ms": ms, "wall_s": wall, "peak_mib": torch.cuda.max_memory_allocated() / 2**20}


def step_vs_cpu(tree, dev) -> dict:
    """One training step's forward and backward (the matting loss, the
    gradient of every leaf) on the card and on the CPU, from the same tree
    and the same synthetic batch (batch 4 at 240x320, made on the CPU), in
    bf16 and in f32; then one whole f32 ``train_step`` on each side from a
    fresh optimizer, its moments and updates leaf by leaf."""
    from video_stream_segmenetation_tpu_torch.models.mattenet_hd import MatteNetHD
    from video_stream_segmenetation_tpu_torch.runtime.precision import pinned
    from video_stream_segmenetation_tpu_torch.train import flagship as FL
    from video_stream_segmenetation_tpu_torch.train.loop import synthetic_matting_batch
    from video_stream_segmenetation_tpu_torch.train.losses import matting_loss
    from video_stream_segmenetation_tpu_torch.train.step import (
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    frames, gt = synthetic_matting_batch(torch.Generator().manual_seed(3), STEP_BATCH, STEP_HW)
    res = {}
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        side = {}
        for d in ("cpu", dev):
            m = MatteNetHD(10, 4, "pico", dtype=dt, params=tree, device=d)
            fr, g = frames.to(d), gt.to(d)
            with pinned():
                loss, _ = matting_loss(m(fr), g, fr)
                grads = torch.autograd.grad(loss, list(m.parameters()))
            side[str(d)] = (loss.item(), [t.double().cpu().flatten() for t in grads])
        (lc, gc), (lg, gg) = side["cpu"], side[str(dev)]
        cos = min(float(a @ b / max(a.norm() * b.norm(), 1e-30)) for a, b in zip(gc, gg))
        rel = max(float((a - b).norm() / max(b.norm(), 1e-30)) for a, b in zip(gg, gc))
        res[name] = {"loss_rel": abs(lg - lc) / abs(lc), "min_cos": cos, "max_rel_l2": rel,
                     "loss_card": lg, "loss_cpu": lc}

    side = {}
    for d in ("cpu", dev):
        m = MatteNetHD(10, 4, "pico", dtype=torch.float32, params=tree, device=d)
        tx = make_optimizer(FL.LR)
        state, _ = init_train_state(m, tx)
        before = {k: p.detach().clone() for k, p in state.params.items()}
        with pinned():
            state, _ = make_train_step(m, tx)(state, frames.to(d), gt.to(d))
        flat = lambda t: t.detach().double().cpu().flatten()  # noqa: E731
        side[str(d)] = {k: (flat(p - before[k]), flat(state.opt_state.mu[k]),
                            flat(state.opt_state.nu[k])) for k, p in state.params.items()}
    gaps = [[float((g - c).norm() / max(c.norm(), 1e-30)) for g, c in zip(side[str(dev)][k], cs)]
            for k, cs in side["cpu"].items()]
    res["update"] = {"update": max(g[0] for g in gaps), "mu": max(g[1] for g in gaps),
                     "nu": max(g[2] for g in gaps), "leaves": len(gaps)}
    return res


def phase_train(dev, counters: dict) -> dict:
    """The plan-D pico MatteNetHD trained on the card at its full widths
    (c0 128, c2 128, c3 192) with tools/train_flagship.py's schedule at
    fewer steps, held against a CPU step; the trained tree stochastically
    rounded to bf16 through the kernel, quantized by the port's quantizer
    and served one step through the CUDA trunk.  ``counters`` are set to 0
    before and read after."""
    from video_stream_segmenetation_tpu_torch import bridge
    from video_stream_segmenetation_tpu_torch.kernels import stochastic_round as SR
    from video_stream_segmenetation_tpu_torch.models.mattenet_hd import MatteNetHD, init_params
    from video_stream_segmenetation_tpu_torch.runtime.presets import preset
    from video_stream_segmenetation_tpu_torch.service.engine import Engine
    from video_stream_segmenetation_tpu_torch.train import flagship as FL
    from video_stream_segmenetation_tpu_torch.utils import quantize as UQ

    for c in counters.values():
        c.launches = 0
    model = MatteNetHD(FL.STEM_STRIDE, FL.HEAD_UPSAMPLE, "pico", device=dev)
    pre = fit_timed(model, hw=FL.PRETRAIN_HW, batch=FL.PRETRAIN_BATCH, steps=TRAIN_STEPS,
                    lr=FL.LR, log_every=10)
    ft = fit_timed(model, hw=FL.SERVE_HW, batch=FL.SERVE_BATCH, steps=FT_STEPS, lr=FL.LR / 3,
                   log_every=10, init_params=pre["tree"], seed=1)
    for label, r in (("pretrain", pre), ("fine-tune", ft)):
        if not (np.isfinite(r["loss"]).all() and np.isfinite(r["grad_norm"]).all()):
            raise AssertionError(f"train ({label}): a loss or grad_norm is not finite: "
                                 f"{r['loss']} {r['grad_norm']}")
    start = bridge.flatten(init_params("pico", 0))
    trained = bridge.flatten(ft["tree"])
    still = [k for k, v in start.items() if np.array_equal(v, trained[k])]
    if still or not all(np.isfinite(v).all() for v in trained.values()):
        raise AssertionError(f"train: leaves that did not move or are not finite: {still}")

    held = step_vs_cpu(ft["tree"], dev)
    b, f, u = held["bf16"], held["f32"], held["update"]
    if not (b["loss_rel"] <= STEP_BF16_LOSS_TOL and b["min_cos"] >= STEP_BF16_COS
            and f["loss_rel"] <= STEP_F32_LOSS_TOL and f["max_rel_l2"] <= STEP_F32_GRAD_TOL
            and max(u["update"], u["mu"], u["nu"]) <= STEP_F32_UPDATE_TOL):
        raise AssertionError(f"train: the card's step departs from the CPU's: {held}")

    # every leaf stochastically rounded to bf16 through the quantization
    # module's entry point (the kernel), each held against the plain version
    # bit for bit: the leaves' lengths reach the kernel's scalar tail
    rounded, sr_err = {}, 0.0
    for i, (k, v) in enumerate(trained.items()):
        x = torch.as_tensor(v, device=dev)
        r = UQ.stochastic_round_bf16(x, seed=i)
        want = SR.stochastic_round_bf16_plain(x, seed=i)
        xb = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        rb = r.view(torch.int16).to(torch.int64) & 0xFFFF
        if not torch.equal(r.view(torch.int16), want.view(torch.int16)):
            sr_err = max(sr_err, (r.float() - want.float()).abs().max().item())
            raise AssertionError(f"train: {k} {tuple(x.shape)} rounded apart from the plain "
                                 f"version (tolerance 0), max_abs_err {sr_err:.3e}")
        if not bool(((rb == xb >> 16) | (rb == (xb >> 16) + 1)).all()):
            raise AssertionError(f"train: {k} rounded off its bf16 neighbours")
        rounded[k] = r.float().cpu().numpy()
    qerr = UQ.quantization_error({k: torch.as_tensor(v, device=dev) for k, v in rounded.items()})
    rounded = bridge.unflatten(rounded)

    # the rounded tree quantized by the port's quantizer, served one step
    eng = Engine(8, preset("fast_int8_pico", face_path=False),
                 params=bridge.params_from_jax(rounded, FL.STEM_STRIDE, "pico"), device=dev)
    eng.admit_all()
    rng = np.random.default_rng(0)
    base = (rng.random((8, *FRAME_HW, 3)) * 90).astype(np.uint8)
    frames, _ = synthetic_frames(rng, base, 0)
    out = eng.process(frames)
    torch.cuda.synchronize()
    alpha = out["alpha"].float()
    if tuple(alpha.shape) != (8, *eng.statics.mask_hw) or tuple(out["frame"].shape) != \
            (8, *FRAME_HW, 3) or not bool(torch.isfinite(alpha).all()) \
            or alpha.min() < 0 or alpha.max() > 1:
        raise AssertionError(f"train: the served step gave alpha {tuple(alpha.shape)}, "
                             f"frame {tuple(out['frame'].shape)}")
    launches = {k: c.launches for k, c in counters.items()}
    want = {"stochastic_round": len(trained), "trunk_int8": 1, "refine_fused": 1}
    if launches != {k: want.get(k, 0) for k in launches}:
        raise AssertionError(f"train: launches {launches}, expected {want}")
    return {"pre": pre, "ft": ft, "held": held, "launches": launches, "leaves": len(trained),
            "shapes": sorted({tuple(v.shape) for v in trained.values()}), "sr_err": sr_err,
            "qerr": qerr, "alpha_mean": alpha.mean().item()}

def hold(by_name: dict, phase: str, held: dict) -> None:
    """Print a held round's errors and fold them into the kernels'
    ``max_abs_err``."""
    for (counter, s), err in held.items():
        by_name[counter]["max_abs_err"] = max(by_name[counter]["max_abs_err"], err)
    say(f"  {phase}: one more round, each kernel held against its plain version on the "
        f"inputs the round gave it (tolerances as in the kernels phase): "
        + ", ".join(f"{c} S={s} {e:.3e}" for (c, s), e in sorted(held.items())))


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
    steps = 12 + len(PHASES)
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
               check_fused_refine(dev), check_refine_fast(dev), check_stochastic_round(dev)]
    torch.cuda.empty_cache()

    for k in kernels:
        k["launches"] = 0
    by_name = {k["name"]: k for k in kernels}
    phase_iou = {}
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
                   + (f", class map means {[round(v, 4) for v in res['class_means']]} "
                      f"(the reference's {REFERENCE_CLASS_MEANS[preset_name]}, tolerance "
                      f"{CLASS_MEAN_TOL:g})" if "class_means" in res else "")
                   + f", face_applied on "
                   f"{res['applied']} streams, mean det_score {res['det_score']:.4f}"
                   + (f", trunk vs plain on 2 streams {res['trunk_err']:.3e} (tolerance "
                      f"{TRUNK_TOL:g})" if "trunk_err" in res else "")
                   if trained else
                   f"alpha inside/outside the ellipse {res['alpha_in']:.4f}/"
                   f"{res['alpha_out']:.4f}")
        if "composite_err" in res:
            by_name["composite_fused"]["max_abs_err"] = max(
                by_name["composite_fused"]["max_abs_err"], res["composite_err"])
            quality += (f", the composite kernel on the last step's inputs (background "
                        f"{'one row' if overrides.get('background') == 'color' else 'S rows'})"
                        f" vs plain {res['composite_err']} (tolerance {COMPOSITE_TOL})")
        if "bg_pixels" in res:
            quality += (f", the {res['background']} background exact on the "
                        f"{res['bg_pixels']} pixels where the alpha is 0")
        phase_iou[label] = res.get("iou")
        say(f"  serve: median step {med:.2f} ms over {SERVE_STEPS} steps (host clock, "
            f"synchronized; first {res['times_ms'][0]:.1f} ms), launches "
            f"{res['launches']}, {quality}, health {res['health']}, passthrough steps "
            f"{res['passthrough']}, peak device memory {res['peak_mib']:.0f} MiB")
        torch.cuda.empty_cache()

    k = 4 + len(PHASES)
    say(f"[{k}/{steps} degrade] Engine({S}, fast_int8_pico), weights loaded with "
        "load_matting_params/load_face_params from weights/*.npz, committed frames: the "
        "step made to fail through process and through dispatch/collect, then an "
        "out-of-memory and a refused launch on the card")
    dg = phase_degrade("cuda")
    say(f"  degrade: health after 4 failing calls {dg['process']} (process), "
        f"{dg['dispatch/collect']} (dispatch/collect), each passthrough frame equal to its "
        f"input byte for byte and alpha f32 ones, the probe served and health ok; out of "
        f"memory: {dg['out of memory'][:90]!r}; refused launch: "
        f"{dg['refused launch']!r}; each followed by a served step; alpha IoU after "
        f"{dg['iou']:.4f}; passthrough results {dg['passthrough']}")
    eng = dg.pop("engine")
    say(f"[{k + 1}/{steps} render] the sample templates at each privacy level, rendered at "
        f"720p (PIL) and served as backgrounds")
    rd = phase_render(eng)
    say(f"  render: pixels painted {rd['painted']}; median render "
        f"{statistics.median(rd['render_ms']):.1f} ms (host clock); a served step over them")
    say(f"[{k + 2}/{steps} server] ControlServer on that engine at 127.0.0.1, a free port")
    sv = phase_server(eng, rd["renderers"])
    say(f"  server: " + "; ".join(f"{key} {val}" for key, val in sv.items()))
    del dg, eng, rd
    torch.cuda.empty_cache()
    say(f"[{k + 3}/{steps} chunked, packed] process_chunked(frames, {S // 4}) vs process (two "
        "engines, same weights), 3 steps; output_layout='packed' vs 'natural', 2 steps")
    cp = phase_chunked_packed("cuda")
    say(f"  chunked: frame, alpha, face outputs and state equal element by element "
        f"(face applied {cp['chunked_applied']} times over the 3 steps); packed "
        f"{cp['packed_shape']} after depth_to_space equal to natural byte for byte")
    torch.cuda.empty_cache()
    say(f"[{k + 4}/{steps} api] segment, composite (colour, blur, image) and process_frame "
        "on the committed frames with weights/mattenet.npz")
    ap = phase_api("cuda", phase_iou["active"])
    say(f"  api: mask IoU vs ground truth {ap['iou']:.4f} (least allowed: the reference's "
        f"segment {REFERENCE_IOU['api']} and the active phase's {phase_iou['active']:.4f}, "
        f"less {IOU_SLACK}); {ap['zero_pixels']} pixels where the hard mask is 0; "
        + ", ".join(k2 for k2, v in ap["checks"].items() if v))
    torch.cuda.empty_cache()

    n = sum(ROTATION)
    say(f"[{k + 5}/{steps} rotation] StreamScheduler(Engine({n}, fast_int8_pico, "
        f"{FAST_ROUTE}), group_sizes={list(ROTATION)}, fused_rounds=True) over the native "
        f"FramePool: 1 priming + {ROUNDS} rounds and a drain, trained weights, committed "
        "frames")
    res = phase_production("cuda")
    for counter, got in res["launches"].items():
        if counter in by_name:
            by_name[counter]["launches"] += got
    say(f"  rotation: median round {statistics.median(res['latencies_ms']):.2f} ms dispatch "
        f"to collect (host clock; {len(res['latencies_ms'])} rounds, "
        f"{[round(t, 1) for t in res['latencies_ms']]}), median step_round call "
        f"{statistics.median(res['periods_ms'][1:]):.2f} ms; {res['wall_s']:.1f} s for all "
        f"rounds with the pushes; launches {res['launches']}; native pool, "
        f"{res['pool_lanes']} guide lanes; face applied a round {res['per_round']}, "
        f"{res['union6']} of {n} streams over the first six; alpha IoU vs ground truth "
        f"{res['iou']:.4f} (least allowed 0.5); one more round, timed apart and its step "
        f"under set_sync_debug_mode('error'): "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in res["parts_ms"].items())
        + f"; health {res['health']}; peak device memory "
        f"{res['peak_mib']:.0f} MiB; {smi}")
    hold(by_name, "rotation", res["held"])
    say(f"[{k + 6}/{steps} rotation failure] that rotation, one round failing after its "
        "first two groups wrote their rows, then three rounds")
    rf = phase_rotation_failure(res)
    say(f"  rotation failure: every group's input served back as passthrough; affine, "
        f"has_affine and frame_idx restored equal to the snapshot the failing dispatch "
        f"took (frame_idx {rf['frame_idx']}...), the EMA cold; the next rounds served, "
        f"alpha IoU {[round(v, 4) for v in rf['ious']]}, health {rf['health']}; one more "
        f"round with its snapshot under set_sync_debug_mode('error')")
    res["sched"].stop()
    del res, rf
    torch.cuda.empty_cache()

    say(f"[{k + 7}/{steps} routes] the same frames, S=64, group_sizes=[24, 24, "
        f"16], face_min_interval_s=0: the fast route with fused rounds vs fast_int8_pico "
        f"as it stands under per-group step_pipelined, {ROUNDS} rounds")
    rb = phase_routes("cuda")
    for res in (rb["a"], rb["b"]):
        for counter, got in res["launches"].items():
            if counter in by_name:
                by_name[counter]["launches"] += got
    say(f"  routes: prev_alpha max_abs_err {rb['prev_err']:.3e} (tolerance "
        f"{ROUTE_PREV_TOL:g}), refined alpha {rb['alpha_err']:.3e} (tolerance "
        f"{ROUTE_ALPHA_TOL:g}), IoU {rb['a']['iou']:.4f} vs {rb['b']['iou']:.4f} (tolerance "
        f"{ROUTE_IOU_TOL:g}); median round {statistics.median(rb['a']['latencies_ms']):.2f} "
        f"ms fused (dispatch to collect), {statistics.median(rb['b']['periods_ms']):.2f} ms "
        f"pipelined (three ticks)")
    hold(by_name, "routes", rb["held"])
    del rb
    torch.cuda.empty_cache()

    say(f"[{k + 8}/{steps} train] the pico MatteNetHD (c0 128, c2 128, c3 192) on "
        f"the card: fit {TRAIN_STEPS} steps at 240x320 batch 32 lr 5e-4, then {FT_STEPS} at "
        "720x1280 batch 8 lr 5e-4/3 seed 1; one step against the CPU; the trained tree "
        "stochastically rounded, quantized and served one step of Engine(8, fast_int8_pico, "
        "face_path=False)")
    counters = _counters()
    tr = phase_train(dev, counters)
    for counter, got in tr["launches"].items():
        if counter in by_name:
            by_name[counter]["launches"] += got
    for label, r in (("pretrain 240x320 b32", tr["pre"]), ("fine-tune 720x1280 b8", tr["ft"])):
        say(f"  train {label}: median step {statistics.median(r['ms'][1:]):.2f} ms (CUDA "
            f"events between steps' ends: the batch's generation and the step; median of "
            f"{len(r['ms']) - 1} intervals after the first), {r['wall_s']:.1f} s for the "
            f"fit, peak device memory "
            f"{r['peak_mib']:.0f} MiB; losses {[round(float(v), 4) for v in r['loss']]}; "
            f"grad_norm {[round(float(v), 3) for v in r['grad_norm']]}; history "
            f"{r['history']}; {smi}")
    h = tr["held"]
    say(f"  train: card vs CPU step (batch 4 at 240x320, the trained tree): bf16 loss "
        f"{h['bf16']['loss_card']:.6f} vs {h['bf16']['loss_cpu']:.6f} (relative "
        f"{h['bf16']['loss_rel']:.2e}, tolerance {STEP_BF16_LOSS_TOL:g}), least gradient "
        f"cosine {h['bf16']['min_cos']:.5f} (at least {STEP_BF16_COS}); f32 loss relative "
        f"{h['f32']['loss_rel']:.2e} (tolerance {STEP_F32_LOSS_TOL:g}), largest gradient "
        f"relative L2 {h['f32']['max_rel_l2']:.2e} (tolerance {STEP_F32_GRAD_TOL:g}); one "
        f"f32 train_step each (clip, AdamW, update applied), largest relative L2 over "
        f"{h['update']['leaves']} leaves: update {h['update']['update']:.2e}, mu "
        f"{h['update']['mu']:.2e}, nu {h['update']['nu']:.2e} (tolerance "
        f"{STEP_F32_UPDATE_TOL:g})")
    by_name["stochastic_round"]["max_abs_err"] = max(
        by_name["stochastic_round"]["max_abs_err"], tr["sr_err"])
    say(f"  train: {tr['leaves']} leaves stochastically rounded through the kernel (shapes "
        f"{tr['shapes']}), each equal to the plain version bit for bit (tolerance 0, "
        f"max_abs_err {tr['sr_err']:.3e}); int8 quantization_error of the rounded tree "
        f"{tr['qerr']:.4f}; served one step, alpha mean {tr['alpha_mean']:.4f}; launches "
        f"{tr['launches']}")
    del tr
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
