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
     its one-class head (its 9 launches, u2red and u1red through the decoder
     kernel, each timed beside its own bound), the int8 alpha head alone (K=1
     and the trained K=4 head, at 72x128 and at a ragged 70x120, exact) and
     the SE alone (exact on the trained pico's ctx plane, within one s8 step
     on a seeded one, the elements apart counted; the head's and the SE's
     calls on the main path are its trunk calls times TRUNK_PARTS, which
     each served trunk form's check holds on the card), the trunk with its K=4 head at the pico and the nano
     widths (trained multi-class weights, exact), with its one-class head at
     the nano and the femto widths (the trained fast_int8_nano and _femto
     weights, exact), the fused temporal refine
     (bf16 and f32 refined alpha; every form also at a moved EMA gate, bit
     for bit with its plain version there but the forms fed head-grid
     logits), the int8 decoder level at micro's u2 and
     u1 levels, the fused 3x3 conv in its four forms (act or not, residual
     or not; given the OHWI weights and not) at plan B's layer shapes
     (beside it the trunk's own conv on the same inputs, held and timed as
     its yardstick), the u1-out trunk at pico widths, the
     natural layout's fused composite (720p, 288x512 alpha) at each upsample
     method's taps (half-pixel, asymmetric, align-corners), the
     plane-prior temporal refine, fused_refine (f32 out), the fast
     form of the temporal refine in its three forms (head-grid logits
     [64, 72, 128], tap lanes [48, 64, 72, 128], both), and the stochastic
     rounding f32 -> bf16 on 64 M values (+-0, subnormals, exact values,
     +-inf, NaNs, values next to bf16's largest, normals at many scales):
     bit for bit, every output one of its two bf16 neighbours, a block of
     one value rounded up at its probability within 5 sigma; then the
     refine kernel's bench-only debug variants ('no_morph', 'no_bilateral',
     both) of the analytic (bf16), plane (f32) and fast (logits and lanes)
     forms against their plain versions with the same tokens, and timed;
  4-38. serve: Engine(64, ...) answers 8 steps of 720p frames in
     thirty-five phases, each with every launch count set to 0 just before it
     and read just after, and none of its steps a passthrough (the engine's
     count of them must stay 0):
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
          stream's 720p frame every step, a colour background; the face
          gate off, face_min_interval_s=0, as its bar's reference), branch
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
      30-33. the face subpath's other forms on the pico trunk:
          fast_int8_pico_refface as its preset stands (the reference
          application's MediaPipe detector and landmark graphs at 256/192
          on the port's ONNX executor, f32 under pinned precision; the
          landmark graph takes the committed person's face for no face,
          as the reference's engine does, so the phase requires the
          detector's prior applied instead of the affine), fast_int8_pico
          with face_precision='int8' (the int8 FaceFinder and
          LandmarkNet), with face_compact=False (the face models on all 64
          streams at each cadence step) and with face_tracking=
          'translation' (the detector on every firing stream's guide, the
          centre's delta as a whole-pixel translation);
      34-38. the serving options of the float MatteNetHD and the upsample
          and warp: fast with frame_layout='s2d' (the trained plan-A
          mattenet_hd over packed frames at block 5, its stem one product,
          the refine kernel once a step); fast_int8_pico with
          warp_impl='exact', upsample_precision='exact' and
          upsample_method='align_corners' (the 2-D nearest warp and the EMA
          in PyTorch, fused_refine once a step, held against its plain
          version and timed on the last step's inputs, the packed
          composite's f32 products at the align-corners taps); fast_int8
          (face path off) and multiclass_fast_pico with
          matting_precision='bf16' (the float plan B and the float K=4 pico
          over packed frames, on the seed-0 tree: no committed float
          export; their map means held to the reference's,
          REFERENCE_MEANS); active
          with upsample_method='asymmetric' and use_fused_composite=True
          (the composite kernel at the asymmetric taps);
     each checks shapes, dtypes, value ranges, the alpha against the frames'
     ground truth (phases 5-38) or the ellipse (phase 4), that each counted
     wrapper ran its expected number of times (every other one none), with
     the face path on that it was applied to at least one stream, in phases
     7-8, 28 and 37 that class_alpha sums to 1 within 1e-3, in the phases
     with a bar that the IoU is at most 0.02 below the reference engine's,
     and in every trained int8 s2d phase that the served trunk equals its
     plain version on two streams; each prints its median step time and the
     peak device memory;
  39. degrade: Engine(64, fast_int8_pico) with the trained weights loaded
     through load_matting_params/load_face_params from weights/*.npz, its
     step replaced by one that raises, through process and through
     dispatch/collect: two passthrough failures, 'degraded' after the
     third, a fourth call served as passthrough without running the step,
     each passthrough frame equal to its input byte for byte and alpha f32
     ones; the step restored and the probe due, the probe serves and
     health reads 'ok'; then one real failure on the card each of an
     out-of-memory and a launch the alpha head's C entry point refuses;
  40. render: the sample background templates at each privacy level,
     rendered at 720p with PIL (background/render.py) and served;
  41. server: a ControlServer on that engine at 127.0.0.1 on a free port:
     /stats, /healthz (503 while degraded), knobs, reset, a background
     colour, the privacy level and a template between served steps;
  42. chunked, packed: process_chunked(frames, 16) against process on a
     second engine, element by element; output_layout='packed' after
     depth_to_space against 'natural', byte for byte;
  43. api: segment, composite (colour, blur, image) and process_frame on
     the committed frames with weights/mattenet.npz, the mask IoU within
     0.02 of the active phase's;
  44. rotation, the production serving loop: StreamScheduler(Engine(400,
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
  45. rotation failure: on that rotation, one round failing after its
     first two groups wrote their rows: every group's input back as
     passthrough, the state restored from the failing dispatch's snapshot
     (affine, has_affine, frame_idx; a cold EMA), three rounds served,
     then one more round with its snapshot under
     set_sync_debug_mode('error');
  46. routes: S=64 in groups [24, 24, 16], face_min_interval_s=0, the same
     frames through that route with fused rounds and through
     fast_int8_pico as its preset stands under per-group step_pipelined:
     prev_alpha within 1e-5, the refined alpha within 1e-2, IoU within
     0.001; then on each route a round held as in phase 44 (trunk, fast
     and analytic refine at 24 and 16 streams);
  47. refface round: StreamScheduler(Engine(64, fast_int8_pico_refface),
     group_sizes=[24, 24, 16], fused_rounds=True), face_min_interval_s=0,
     2 rounds, then one more round whose step runs under
     torch.cuda.set_sync_debug_mode('error') (the MediaPipe graphs make no
     host synchronisation); the trunk and the refine kernel once a group a
     round; then the face models' forwards on K=11 streams (the compact
     batch of 64 streams at lmk_interval 6), CUDA events: the MediaPipe
     detector (256) and landmark graph (192), the int8 and the bf16
     FaceFinder and LandmarkNet (128), and the MediaPipe graphs on the card
     against the CPU on two of those streams;
  48. mesh (parallel/mesh.py): Engine(64, fast_int8_pico, mesh=
     make_mesh(4, devices=[cuda:0] * 4)) against Engine(64) on the trained
     weights and committed frames, face_min_interval_s=0, 8 steps (process,
     then dispatch/collect): face_applied equal, frames within one u8 step
     on all but 0.1 % of the pixels, alpha and prev_alpha within 2e-2 (the
     reference's mesh bars), the trunk and the refine kernel 4 times the
     one-device engine's launches; the fused rotation in groups [24, 24,
     16] over both engines, 3 rounds held group by group (5 pieces a round
     on the mesh), then one more mesh round under
     set_sync_debug_mode('error'); fit(mesh=...) of the pico at its widths
     in f32, 240x320 batch 32, against one device (one step's loss within
     1e-4 relative and summed gradients' least leaf cosine MESH_GRAD_COS,
     5 steps' losses within 1e-4 relative); graft_entry.
     dryrun_multichip(4); with several cards the engine and fit again with
     one shard a card (with one, the phase says that form was not run);
     the step and round medians (host clock) beside one device's;
  49. rollout (runtime/rollout.py): on Engine(64, fast_int8_pico), trained
     weights and the committed frames, a step rollout of 4 steps against 4
     sequential make_step calls on the same tagged frames (state and both
     buffers bit for bit; the trunk and the refine kernel 4 times), then
     its slope between chains of 2 and 10 steps (median of 5 paired reps;
     host clock and CUDA events; acc_mode 'buffer' and 'reduce') beside
     the host-clock median of 8 Engine.process calls; on the production
     rotation (400 streams in [96, 96, 96, 96, 16], the fast route), a round
     rollout of 3 rounds under set_sync_debug_mode('error') against 3
     sequential round steps (bit for bit; the trunk and the fast refine
     once a group a round), then its slope between 1 and 3 rounds (3 reps);
  50. snapshot: Engine(64, fast_int8_pico) saved after 3 steps
     (utils/checkpoint.py), restored into a fresh engine of another seed,
     both stepped 4 times on the same frames (the last a face cadence
     step): state and outputs bit for bit;
  51. train: the plan-D pico MatteNetHD at its full widths, fit on the
     card with tools/train_flagship.py's schedule at fewer steps (20 at
     240x320 batch 32, then 5 at 720x1280 batch 8), every loss and
     grad_norm finite and every leaf moved; one step's forward and
     backward on the card against the CPU (bf16 and f32); the trained
     tree stochastically rounded to bf16 through the kernel, leaf by
     leaf, quantized by the port's quantizer and served one step of
     Engine(8, fast_int8_pico, face_path=False) through the CUDA trunk;
     it prints ms a step (CUDA events) and the peak memory;
  52. train_zoo: every trainer of train/ at its full widths and the
     reference's geometry and batch, a few steps: the FaceFinder (FD 128)
     and the LandmarkNet (LMK 128) on 288x512 scenes, batch 32, 20 steps
     each (train/face_trainer.py); the RecurrentMatteNet (288x512, batch
     8, unroll 3), the SaliencyNet (320x320, batch 16) and the K=4
     MatteNet (288x512, batch 12), 5 steps each, the K=4 MatteNetHD pico
     5 steps at 240x320 batch 24 then 3 at 720p batch 6
     (train/variants.py); the flagship's plans A, B, C and the MatteNet,
     5 steps of pretraining and 3 of fine-tuning (train/flagship.py's
     rows through train/loop.py::fit).  Each: losses finite, every leaf
     moved (BatchNorm statistics included), one step's loss and gradients
     on the card against the CPU at phase 51's bars, ms a step (CUDA
     events) and the peak memory; then each trained tree serves 2 steps of
     Engine(8) at 720p on the committed frames with no passthrough: the
     face pair in fast_int8_pico (its face models run), the MatteNet in
     active, the K=4 MatteNet in multiclass, RVM in rvm, the SaliencyNet
     in u2, plan A in fast and the K=4 pico, quantized by the port's
     quantizer, in multiclass_fast_pico (the int8 trunk held against its
     plain version); last an articulated clip of 4 frames at 720p
     (utils/clips.py) rendered on the card against the CPU's render of
     the same draws;
  53. realbg: the photo-background trainers of train/realbg.py (realbg,
     flagship, active, u2, rvm, multiclass_pico) at their widths,
     geometry and batch, 4 steps a phase, on 4 photographs the phase
     writes at 1920x1080 and deletes: losses finite, every leaf the loss
     reads moved, one step's loss and gradients on the card against the
     CPU (f32 leaf cosines 0.9999, bf16 the whole gradient's 0.99), ms a
     step and the peak memory; fit(mesh=4 virtual shards, loss_fn=
     make_pipeline_loss) and the U2 loss: one step's loss within 1e-6 and
     the least leaf cosine MESH_GRAD_COS of one device's, fit's losses
     within 1e-4; the synthetic gate (evaluate.py) on the committed pico
     (held to the reference's record) and on the run's flagship candidate,
     the realistic gate on the committed pico over the photos, each gate's
     trunk and refine launches counted and the trunk held against its
     plain version;
  54. tools: the parity and tuning tools of the package on the card, each
     with its launch counts set to 0 before it and read after:
     parity_check on the committed frames cycled to 8 (fast_int8_pico at
     720p) against the masks of its own CPU run, every frame at least
     0.99, and --synthetic within 0.02 of the CPU's mean; face_parity's
     four sections (port fidelity 1e-4 relative, the decode's anchors all
     equal with IoU 0.9999, blaze's NMS count equal and rows within 1e-6);
     parity_matting's int8 against float pipelines at 720p (at least 0.99)
     and its whole report at --small's geometry with 2 oracle frames, each
     section within 0.02 of the CPU's (the oracle sections printed against
     their predicted 0.99); tune_adaptive_ema, two adapts at a moved gate
     and at the default (adapt 0 the same, adapt 1 not); and
     diag_realistic_clips, 8 frames a clip, on 4 photographs it writes.
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
from pathlib import Path

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
HEAD_TOL = 0  # the alpha head alone: exact s32 sums, the same f32 epilogue
# the SE alone: s8 out equal on the trained pico's ctx plane; on seeded planes
# the mean's float64 sums in another order than the plain version's may move
# an element on a rounding edge by one s8 step
SE_TRAINED_TOL, SE_SEEDED_TOL = 0, 1
COMPOSITE_TOL = 0  # u8 out: f64 row sums, bf16 rows, exact bf16 products, same blend


def say(*parts) -> None:
    print(*parts, flush=True)


def cuda_time_ms(fn, iters: int) -> float:
    """Mean CUDA-event time of ``fn`` over ``iters`` calls, after a warm-up
    (utils/profiling.py::event_ms)."""
    from video_stream_segmenetation_tpu_torch.utils.profiling import event_ms

    return event_ms(fn, iters)[0]


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
    """The pico/nano trunk's 9 launches (kernels/trunk_int8.py::_nano_u1,
    then the head) one by one on ``x0``, each with its own multiply-adds
    and the bytes it reads and writes (inputs once, output once), and for
    the 1x1 convs the (M, K, N) of their product.  u2red and u1red are one
    decoder-kernel launch each (kernels/decoder_int8.py::launch_level)."""
    from video_stream_segmenetation_tpu_torch.kernels import decoder_int8 as DK
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

    def level(name, small, skip):
        up, skip_l, a, b = tp[name + "_up"], tp[name + "_skip"], acts[small], acts[skip]

        def fn():
            return DK.launch_level(lib, stream, a, b, up, skip_l)
        y = acts[name] = fn()
        cout = up["w"].shape[0]
        rows.append({"name": name, "fn": fn, "macs": (a.numel() + b.numel()) * cout,
                     "bytes": _nbytes(a, b, y, up["w"], skip_l["w"], up["mult"], up["bias"]),
                     "mkn": None})

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
    level("u2red", "se", "d2b")
    level("u1red", "u2red", "x0")
    u1, head = acts["u1red"], tp["alpha"]
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


# the refine kernel's debug variants (the reference's bench-only tokens)
REFINE_DEBUGS = (("no_morph",), ("no_bilateral",), ("no_morph", "no_bilateral"))


def check_refine_debug(dev) -> dict:
    """Rows 2, 2p and 2f (the analytic form with its bf16 out, the plane
    form with f32, the fast form from logits and lanes) in each debug
    variant, on the inputs those rows' checks use, against the plain
    version with the same tokens at those rows' tolerances, and timed.
    Returns ``{row's kernel name: the largest error}``."""
    from video_stream_segmenetation_tpu_torch.kernels import refine_fused as TR
    from video_stream_segmenetation_tpu_torch.ops.prior import prior_plane_from_params
    from video_stream_segmenetation_tpu_torch.ops.warp import separable_warp_indices
    from video_stream_segmenetation_tpu_torch.runtime.precision import pinned

    f32, bf16 = torch.float32, torch.bfloat16
    forms = {}
    (alpha, prev, guide, affine, init, use_warp, has_prior, pp, knobs) = _refine_inputs(dev, 2)
    hw = alpha.shape[-2:]
    yi, xi = separable_warp_indices(affine, hw)
    table = TR.scalar_table(knobs, use_warp, init, 0.3, pp, has_prior)
    forms["refine_fused"] = (
        lambda d: TR._launch(alpha, prev, yi, xi, guide, table, bf16, debug=d),
        lambda d: TR.fused_temporal_refine_plain(alpha, prev, yi, xi, guide, table, bf16,
                                                 debug=d), REFINED_TOL)
    (alpha_p, prev_p, guide_p, affine_p, init_p, warp_p, hp_p, pp_p, knobs_p) = \
        _refine_inputs(dev, 6)
    plane = torch.where(hp_p[:, None, None], prior_plane_from_params(pp_p, hw),
                        torch.zeros((), device=dev)).contiguous()
    yi_p, xi_p = separable_warp_indices(affine_p, hw)
    table_p = TR.scalar_table(knobs_p, warp_p, init_p, 0.3, torch.zeros_like(pp_p), hp_p)
    forms["refine_fused_plane"] = (
        lambda d: TR._launch(alpha_p, prev_p, yi_p, xi_p, guide_p, table_p, f32, plane,
                             debug=d),
        lambda d: TR.fused_temporal_refine_plain(alpha_p, prev_p, yi_p, xi_p, guide_p, table_p,
                                                 f32, plane, debug=d), REFINED_F32_TOL)
    (logits, _, lanes, geom, prev_f, _, affine_f, init_f, warp_f, hp_f, pp_f,
     knobs_f) = fast_refine_inputs(dev, 9)
    yi_f, xi_f = separable_warp_indices(affine_f, hw)
    table_f = TR.scalar_table(knobs_f, warp_f, init_f, 0.3, pp_f, hp_f)
    forms["refine_fused_fast"] = (
        lambda d: TR._launch(logits, prev_f, yi_f, xi_f, lanes, table_f, bf16, None, hw, geom,
                             debug=d),
        lambda d: TR.fused_temporal_refine_plain(logits, prev_f, yi_f, xi_f, lanes, table_f,
                                                 bf16, None, hw, geom, d), REFINED_TOL)
    errs = {}
    for name, (kernel, plain, tol) in forms.items():
        for debug in REFINE_DEBUGS:
            got_prev, got = kernel(debug)
            with pinned():
                want_prev, want = plain(debug)
            torch.cuda.synchronize()
            err_prev = (got_prev - want_prev).abs().max().item()
            err = (got.float() - want.float()).abs().max().item()
            label = ",".join(debug)
            if not (err_prev <= PREV_TOL and err <= tol):
                raise AssertionError(f"{name} {label} disagrees with its plain version: "
                                     f"{err_prev}, {err}")
            ms = cuda_time_ms(lambda: kernel(debug), 20)
            say(f"  {name} {label}: new_prev max_abs_err {err_prev:.3e} (tolerance "
                f"{PREV_TOL:g}), refined {got.dtype} max_abs_err {err:.3e} (tolerance "
                f"{tol:g}), {ms:.3f} ms")
            errs[name] = max(errs.get(name, 0.0), err_prev, err)
    return errs


# the EMA's motion gate moved off runtime/config.py's (0.10, 0.40): (t0, t1)
MOVED_GATE = (0.05, 0.25)


def check_refine_gate(dev) -> dict:
    """Rows 2, 2p, 2f and 3 at :data:`MOVED_GATE`, runtime/config.py's gate
    moved (``ema_gate_at``) around each call: each form against its plain
    version at the same gate, on the inputs of its own check; the
    analytic, plane and lanes-fed forms and fused_refine bit for bit, the
    forms fed head-grid logits within the tolerances of their default-gate
    check (their upsample: two-tap sums against the plain version's
    interpolation products).  The gate is live where the refined alpha at
    the moved gate departs from the default gate's.  Returns ``{kernel
    name: the largest error}`` and prints each form's."""
    from video_stream_segmenetation_tpu_torch.kernels import refine_fused as TR
    from video_stream_segmenetation_tpu_torch.ops.prior import prior_plane_from_params
    from video_stream_segmenetation_tpu_torch.ops.temporal import temporal_ema
    from video_stream_segmenetation_tpu_torch.ops.warp import separable_warp_indices
    from video_stream_segmenetation_tpu_torch.runtime.config import ema_gate_at
    from video_stream_segmenetation_tpu_torch.runtime.precision import pinned

    t0, t1 = MOVED_GATE
    f32, bf16 = torch.float32, torch.bfloat16
    forms = []  # (label, counter, wrapper, plain, prev tol, alpha tol)
    (alpha, prev, guide, affine, init, use_warp, has_prior, pp, knobs) = _refine_inputs(dev, 2)
    hw = alpha.shape[-2:]
    yi, xi = separable_warp_indices(affine, hw)

    table = TR.scalar_table(knobs, use_warp, init, 0.3, pp, has_prior)
    forms.append(("analytic bf16", "refine_fused",
                  lambda: TR.fused_temporal_refine(alpha, prev, affine, use_warp, init, 0.3,
                                                   guide, pp, has_prior, knobs),
                  lambda: TR.fused_temporal_refine_plain(alpha, prev, yi, xi, guide, table),
                  0.0, 0.0))
    (alpha_p, prev_p, guide_p, affine_p, init_p, warp_p, hp_p, pp_p, knobs_p) = \
        _refine_inputs(dev, 6)
    plane = torch.where(hp_p[:, None, None], prior_plane_from_params(pp_p, hw),
                        torch.zeros((), device=dev)).contiguous()
    yi_p, xi_p = separable_warp_indices(affine_p, hw)
    table_p = TR.scalar_table(knobs_p, warp_p, init_p, 0.3, torch.zeros_like(pp_p), hp_p)
    forms.append(("plane f32", "refine_fused_plane",
                  lambda: TR.fused_temporal_refine_plane(
                      alpha_p, prev_p, affine_p, warp_p, init_p, 0.3, guide_p, plane, hp_p,
                      knobs_p, out_dtype=f32),
                  lambda: TR.fused_temporal_refine_plain(
                      alpha_p, prev_p, yi_p, xi_p, guide_p, table_p, f32, plane),
                  0.0, 0.0))
    (logits, alpha_f, lanes, geom, prev_f, guide_f, affine_f, init_f, warp_f, hp_f, pp_f,
     knobs_f) = fast_refine_inputs(dev, 9)
    yi_f, xi_f = separable_warp_indices(affine_f, hw)
    table_f = TR.scalar_table(knobs_f, warp_f, init_f, 0.3, pp_f, hp_f)
    for label, lowres, use_lanes in FAST_FORMS:
        a_src, g_src = (logits if lowres else alpha_f), (lanes if use_lanes else guide_f)
        lr, gg = (tuple(hw) if lowres else None), (geom if use_lanes else None)
        forms.append((
            f"fast {label}", "refine_fused_fast",
            lambda a_src=a_src, g_src=g_src, lr=lr, gg=gg: TR.fused_temporal_refine_fast(
                a_src, prev_f, affine_f, warp_f, init_f, 0.3, g_src, pp_f, hp_f, knobs_f,
                alpha_lowres_hw=lr, guide_lanes_geom=gg),
            lambda a_src=a_src, g_src=g_src, lr=lr, gg=gg: TR.fused_temporal_refine_plain(
                a_src, prev_f, yi_f, xi_f, g_src, table_f, bf16, None, lr, gg),
            PREV_TOL if lowres else 0.0, REFINED_TOL if lowres else 0.0))
    # row 3 reads no gate: the exact warp's EMA (ops/temporal.py) at the
    # moved gate makes its input, as a step at that gate does
    alpha_r, prev_r, guide_r, _, init_r, _, hp_r, pp_r, knobs_r = _refine_inputs(dev, 7)
    plane_r = torch.where(hp_r[:, None, None], prior_plane_from_params(pp_r, hw),
                          torch.zeros((), device=dev)).contiguous()

    def ema_r():
        return temporal_ema(prev_r, alpha_r, knobs_r.ema, init_r, adapt=knobs_r.ema_adapt)

    forms.append(("fused_refine after the exact warp's EMA", "fused_refine",
                  lambda: (ema_r()[0], TR.fused_refine(ema_r()[1].contiguous(), guide_r,
                                                       plane_r, hp_r, knobs_r)),
                  lambda: (ema_r()[0], TR.fused_refine_plain(
                      ema_r()[1].contiguous(), guide_r, plane_r, TR.refine_table(knobs_r, hp_r))),
                  0.0, 0.0))
    errs = {}
    for label, counter, kernel, plain, prev_tol, tol in forms:
        with ema_gate_at(t0, t1):
            got_prev, got = kernel()
            with pinned():
                want_prev, want = plain()
        with pinned():
            at_default = plain()[1]
        torch.cuda.synchronize()
        err_prev = (got_prev - want_prev).abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        live = (want.float() - at_default.float()).abs().max().item()
        say(f"  {counter} {label} at the gate t0={t0}, t1={t1}: new_prev max_abs_err "
            f"{err_prev:.3e} (tolerance {prev_tol:g}), refined {got.dtype} max_abs_err "
            f"{err:.3e} (tolerance {tol:g}); the refined alpha {live:.3e} from the default "
            f"gate's (must not be 0)")
        if not (err_prev <= prev_tol and err <= tol and live > 0):
            raise AssertionError(f"{counter} {label} at a moved gate: {err_prev}, {err}, "
                                 f"{live}")
        errs[counter] = max(errs.get(counter, 0.0), err_prev, err)
    return errs


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
    forms = {}
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
            f"-> {tuple(got.shape)} max_abs_err {err:g} (tolerance {DECODER_TOL}); out at 0: "
            f"{hist[0].item() / want.numel():.3f}, at 127: {hist[127].item() / want.numel():.3f}")
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
        forms[level] = ms
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


def check_alpha_head(dev) -> dict:
    """The int8 alpha head alone (kernels/trunk_int8.py::_alpha_head) against
    its plain version (models/quantized.py::alpha_head) at the pico trunk's
    u1, S=64, 72x128x128 (random s8 on the relu6 lattice): K=1 with the
    seeded pico's head and K=4 with the trained multi-class pico's, and at
    a ragged grid (70x120: a last band and columns that are partial); then
    times and the bound of the K=1 form the main path serves."""
    from video_stream_segmenetation_tpu_torch import bridge
    from video_stream_segmenetation_tpu_torch.kernels import trunk_int8 as TK
    from video_stream_segmenetation_tpu_torch.models import quantized as Q
    from video_stream_segmenetation_tpu_torch.models.mattenet_hd import init_pico_params

    blk = 10
    heads = {"K=1": Q.trunk_params(Q.quantize_mattenet_hd(init_pico_params(0, blk), blk),
                                   dev)["alpha"],
             "K=4": Q.trunk_params(bridge.load_export(
                 bridge.WEIGHTS_DIR / "mattenet_hd10_mc_pico.npz"), dev)["alpha"]}
    gen = torch.Generator(device=dev).manual_seed(6)
    u1 = torch.randint(0, 128, (S, FRAME_HW[0] // blk, FRAME_HW[1] // blk, 128), generator=gen,
                       device=dev, dtype=torch.int32).to(torch.int8)
    ragged = u1[:, :70, :120].contiguous()
    lib, stream = TK._launcher(u1)
    err, forms = 0.0, {}
    for label, head in heads.items():
        for x in (u1, ragged):
            got = TK._alpha_head(lib, stream, x, head)
            want = Q.alpha_head(x, head)
            torch.cuda.synchronize()
            e = (got - want).abs().max().item() if got.shape == want.shape else math.inf
            say(f"  alpha_head_i8 {label}: u1 {tuple(x.shape)} -> {tuple(got.shape)} "
                f"max_abs_err {e:.3e} (tolerance {HEAD_TOL})")
            err = max(err, e)
        forms[label] = cuda_time_ms(lambda: TK._alpha_head(lib, stream, u1, head), 20)
    if not err <= HEAD_TOL:
        raise AssertionError(f"alpha head kernel disagrees with its plain version: {err}")
    head = heads["K=1"]
    plain_ms = cuda_time_ms(lambda: Q.alpha_head(u1, head), 3)
    macs = u1.numel() * 9
    bytes_moved = u1.numel() + u1.numel() // 128 * 4 + _nbytes(*head.values())
    bound_ms, bound_by = bound(bytes_moved, 2 * macs, INT8_OPS_PER_S)
    say(f"  alpha_head_i8 K=1: {forms['K=1']:.4f} ms (K=4 {forms['K=4']:.4f} ms), plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}; {bytes_moved / 1e6:.1f} MB, "
        f"{macs / 1e9:.2f} G MAC)")
    return {"name": "alpha_head_i8", "route": "cuda",
            "source": "video_stream_segmenetation_tpu_torch/csrc/trunk_int8.cu",
            "replaces": "video_stream_segmenetation_tpu/kernels/trunk_int8.py:247",
            "max_abs_err": err, "ms": forms["K=1"], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "forms_ms": {"K=4": forms["K=4"]}}


def ctx_plane(x0, tp):
    """The pico/nano trunk's f32 ctx plane (relu6(ctx conv + d3), the SE's
    input) by the plain trunk's layers."""
    from video_stream_segmenetation_tpu_torch.models import quantized as Q

    d2 = Q._qconv(Q._down(x0, tp["d2dn"]), tp["d2b"])
    d3 = Q._qconv(Q._down(d2, tp["d3dn"]), tp["d3b"])
    c3 = Q._conv_i8(d3, tp["ctx"], dilation=3)
    # contiguous NHWC, as the trunk's ctx conv writes it (the plain conv's
    # output keeps the NCHW product's strides)
    return torch.clamp(c3 + d3.to(torch.float32) * Q.ACT_SCALE, 0.0, 6.0).contiguous()


def check_se(dev) -> dict:
    """The SE alone (kernels/trunk_int8.py::_se_requant: the float64 mean,
    dense layers and sigmoid, gate, requant) against its plain version
    (models/quantized.py::_se, then _requant) at S=64 on pico's ctx plane
    ([64, 18, 32, 192] f32): the trained pico's plane on the committed
    frames, equal; the seeded pico's plane on random s8 stem output, no
    element more than one s8 step apart (the count printed); then times and
    the bound on the trained plane."""
    from video_stream_segmenetation_tpu_torch import bridge
    from video_stream_segmenetation_tpu_torch.kernels import trunk_int8 as TK
    from video_stream_segmenetation_tpu_torch.models import quantized as Q
    from video_stream_segmenetation_tpu_torch.models.mattenet_hd import init_pico_params
    from video_stream_segmenetation_tpu_torch.ops.layout import space_to_depth
    from video_stream_segmenetation_tpu_torch.runtime.precision import pinned

    blk = 10
    model = Q.QuantizedMatteNetHD(bridge.load_export(bridge.WEIGHTS_DIR /
                                                     "mattenet_hd10_pico.npz"), blk, 1, device=dev)
    clip, _ = bridge.load_frames()
    fp = space_to_depth(torch.as_tensor(clip[np.arange(S) % 2], device=dev), blk).contiguous()
    with pinned():
        x0 = model.stem(fp)
    seeded = Q.trunk_params(Q.quantize_mattenet_hd(init_pico_params(0, blk), blk), dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    x0_seeded = torch.randint(0, 128, tuple(x0.shape), generator=gen, device=dev,
                              dtype=torch.int32).to(torch.int8)
    lib, stream = TK._launcher(x0)
    planes = {}
    for label, xin, tp, tol in (("trained", x0, model.trunk, SE_TRAINED_TOL),
                                ("seeded", x0_seeded, seeded, SE_SEEDED_TOL)):
        ctx_f = ctx_plane(xin, tp)
        got = TK._se_requant(lib, stream, ctx_f, tp["se"])
        want = Q._requant(Q._se(ctx_f, tp["se"]))
        torch.cuda.synchronize()
        diff = (got.int() - want.int()).abs()
        err, apart = diff.max().item(), int((diff > 0).sum().item())
        say(f"  se_requant {label} pico: ctx {tuple(ctx_f.shape)} -> {tuple(got.shape)} "
            f"{got.dtype}, max_abs_err {err} s8 steps (tolerance {tol}), {apart} of "
            f"{diff.numel()} elements apart")
        if got.dtype != torch.int8 or err > tol:
            raise AssertionError(f"SE kernel disagrees with its plain version on the {label} "
                                 f"plane: {err}")
        planes[label] = (ctx_f, tp["se"], err)
    ctx_f, se, _ = planes["trained"]
    ms = cuda_time_ms(lambda: TK._se_requant(lib, stream, ctx_f, se), 20)
    plain_ms = cuda_time_ms(lambda: Q._requant(Q._se(ctx_f, se)), 3)
    bytes_moved = _nbytes(ctx_f, *se.values()) + ctx_f.numel()
    bound_ms, bound_by = bound(bytes_moved, 2 * S * (se["k0"].numel() + se["k1"].numel()),
                               F32_OPS_PER_S)
    say(f"  se_requant: {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}; {bytes_moved / 1e6:.1f} MB)")
    return {"name": "se_requant", "route": "cuda",
            "source": "video_stream_segmenetation_tpu_torch/csrc/trunk_int8.cu",
            "replaces": "video_stream_segmenetation_tpu/kernels/trunk_int8.py:205",
            "max_abs_err": float(max(e for _, _, e in planes.values())), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


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


COMPOSITE_METHODS = ("half_pixel", "asymmetric", "align_corners")


def check_composite(dev) -> list[dict]:
    """The natural layout's fused composite at S=64, 720p, a 288x512 alpha
    (random, with rows of 0 and 1), random frames and backgrounds, against
    its plain version (the matrix form, TF32 off), at each upsample method's
    taps (one kernel: the wrapper hands it the method's tap tables).
    Returns the half-pixel entry and the asymmetric one (the taps a serve
    phase launches it at); the align-corners form is held and timed here
    and printed."""
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
    # the one-row background (a colour background's form, bg_stride 0)
    bg1 = bg[:1].contiguous()
    bytes_moved = 3 * frames.numel() + 4 * alpha.numel()
    # a pixel: two vertical taps (f64) of its row value, two horizontal
    # taps, the clip, and per channel the blend and the rounding (~6)
    ops = S * fh * (mw * 3 + fw * (5 + 3 * 6))
    bound_ms, bound_by = bound(bytes_moved, ops, F32_OPS_PER_S)
    entries = []
    for method in COMPOSITE_METHODS:
        got = KC.fused_composite(frames, alpha, bg, method=method)
        got1 = KC.fused_composite(frames, alpha, bg1, method=method)
        with pinned():
            want = KC.fused_composite_plain(frames, alpha, bg, method)
            want1 = KC.fused_composite_plain(frames, alpha, bg1, method)
        torch.cuda.synchronize()
        diff = (got.int() - want.int()).abs()
        err = max(diff.max().item(), (got1.int() - want1.int()).abs().max().item())
        say(f"  composite_fused ({method}): frames {tuple(frames.shape)} alpha "
            f"{tuple(alpha.shape)}, background of S rows and of one row: max_abs_err {err} "
            f"u8 steps (tolerance {COMPOSITE_TOL}), values apart {(diff > 0).sum().item()}")
        if got.dtype != torch.uint8 or err > COMPOSITE_TOL:
            raise AssertionError(f"composite kernel ({method}) disagrees with its plain "
                                 f"version: {err}")
        ms = cuda_time_ms(lambda: KC.fused_composite(frames, alpha, bg, method=method), 20)
        with pinned():
            plain_ms = cuda_time_ms(
                lambda: KC.fused_composite_plain(frames, alpha, bg, method), 3)
        line = (f"  composite_fused ({method}): {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}; {bytes_moved / 1e6:.1f} MB)")
        if method == "half_pixel":
            ms1 = cuda_time_ms(lambda: KC.fused_composite(frames, alpha, bg1), 20)
            bound1_ms, bound1_by = bound(2 * frames.numel() + bg1.numel() + 4 * alpha.numel(),
                                         ops, F32_OPS_PER_S)
            line += f"; one-row background {ms1:.3f} ms, bound {bound1_ms:.4f} ms ({bound1_by})"
        say(line)
        if method != "align_corners":
            entries.append({
                "name": "composite_fused" + ("" if method == "half_pixel" else f"_{method}"),
                "route": "cuda",
                "source": "video_stream_segmenetation_tpu_torch/csrc/composite_fused.cu",
                "replaces": "video_stream_segmenetation_tpu/kernels/composite_fused.py:84",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None})
    return entries



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
                 "fast": 0.5878, "multiclass": 0.0,
                 # tests/test_torch_face_720p.py and
                 # test_torch_face_options_720p.py, 8 steps, the reference on
                 # its CPU route (the unfused refine chain)
                 "fast_int8_pico_refface": 0.9250, "fast_int8_pico_int8_face": 0.8717,
                 "fast_int8_pico_uncompacted": 0.7862, "fast_int8_pico_translation": 0.8715,
                 # tests/test_torch_s2d_options_720p.py, 8 steps: the trained
                 # plan-A mattenet_hd over packed frames (block 5), and pico
                 # with the exact warp, exact upsample and align-corners taps
                 "fast_s2d": 0.5881, "fast_int8_pico_exact_align_corners": 0.8514}
IOU_SLACK = 0.02
# The reference engine's mean of each map over the last step's two streams,
# by phase label: the class maps of the trained K=4 MatteNet
# (tests/test_torch_multiclass_natural.py::test_trained_engine_iou_720p), and
# of the float MatteNetHD forms the card serves on the seed-0 tree (no
# committed float export), the alpha of float plan B over packed frames and
# the K=4 float pico's class maps (tests/test_torch_float_hd_720p.py: seeded
# nets find no person, so these phases have no IoU bar; plan B's with the
# face path off, whose compaction makes the means depend on S).  The served maps'
# means (each frame on half the streams) are held to them within
# CLASS_MEAN_TOL (the port on the CPU is within 1e-3)
REFERENCE_MEANS = {"multiclass": (0.8593, 0.0725, 0.0581, 0.0101),
                   "fast_int8, matting_precision='bf16', face_path=False": (0.7663,),
                   "multiclass_fast_pico, matting_precision='bf16'": (0.2145, 0.2207, 0.3036,
                                                                       0.2613)}
CLASS_MEAN_TOL = 5e-3

# serve phases: (label, preset, overrides, the weights and frames (True:
# trained weights and the committed frames; "seeded": the seed-0 matting
# tree, the trained face models and the committed frames; False: seeded
# weights and synthetic frames), launches a step of each counted wrapper
# that runs (every other one must not), the least IoU of the served alpha >
# 0.5 (multi-class: the foreground) against the frames' ground truth, the
# kernel entry the trunk_int8 counter's launches go to, or a dict from
# counter to the entry its launches go to).  The trained micro checkpoint
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
    # the face subpath's other forms on the pico trunk
    ("fast_int8_pico_refface", "fast_int8_pico_refface", {}, True,
     {"trunk_int8": 1, "refine_fused": 1}, REFERENCE_IOU["fast_int8_pico_refface"] - IOU_SLACK,
     "trunk_int8"),
    ("fast_int8_pico, face_precision='int8'", "fast_int8_pico", {"face_precision": "int8"},
     True, {"trunk_int8": 1, "refine_fused": 1},
     REFERENCE_IOU["fast_int8_pico_int8_face"] - IOU_SLACK, "trunk_int8"),
    ("fast_int8_pico, face_compact=False", "fast_int8_pico", {"face_compact": False}, True,
     {"trunk_int8": 1, "refine_fused": 1},
     REFERENCE_IOU["fast_int8_pico_uncompacted"] - IOU_SLACK, "trunk_int8"),
    ("fast_int8_pico, face_tracking='translation'", "fast_int8_pico",
     {"face_tracking": "translation"}, True, {"trunk_int8": 1, "refine_fused": 1},
     REFERENCE_IOU["fast_int8_pico_translation"] - IOU_SLACK, "trunk_int8"),
    # the float MatteNetHD over packed frames (trained plan A at block 5;
    # seeded plan B and the seeded K=4 pico, held to their means); pico
    # with the exact warp (fused_refine on the s2d route), the packed
    # composite's f32 products and the align-corners taps; the composite
    # kernel at the asymmetric taps (active's bar: the alpha does not depend
    # on the upsample)
    ("fast, frame_layout='s2d', s2d_block=5", "fast", {"frame_layout": "s2d", "s2d_block": 5},
     True, {"refine_fused": 1}, REFERENCE_IOU["fast_s2d"] - IOU_SLACK, None),
    ("fast_int8_pico, warp_impl='exact', upsample_precision='exact', "
     "upsample_method='align_corners'", "fast_int8_pico",
     {"warp_impl": "exact", "upsample_precision": "exact", "upsample_method": "align_corners"},
     True, {"trunk_int8": 1, "fused_refine": 1},
     REFERENCE_IOU["fast_int8_pico_exact_align_corners"] - IOU_SLACK,
     {"trunk_int8": "trunk_int8", "fused_refine": "fused_refine_s2d"}),
    ("fast_int8, matting_precision='bf16', face_path=False", "fast_int8",
     {"matting_precision": "bf16", "face_path": False}, "seeded", {"refine_fused": 1}, None,
     None),
    ("multiclass_fast_pico, matting_precision='bf16'", "multiclass_fast_pico",
     {"matting_precision": "bf16"}, "seeded", {}, None, None),
    ("active, upsample_method='asymmetric', use_fused_composite=True", "active",
     {"upsample_method": "asymmetric", "use_fused_composite": True}, True,
     {"refine_fused": 1, "composite_fused": 1}, REFERENCE_IOU["active"] - IOU_SLACK,
     {"composite_fused": "composite_fused_asymmetric"}),
)
# phases served with the face gate off (face_min_interval_s=0), as the
# reference engine that gives their bar runs (tests/test_torch_zoo_720p.py)
FACE_GATE_OFF = ("blaze_tracking",)
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


def _part_counters():
    """The trunk's head and SE entry points, counted apart from the trunks'
    own counts (kernels/trunk_int8.py::_alpha_head, _se_requant; one SE
    call is its two kernels): :func:`trunk_err` holds the calls of one
    trunk call to TRUNK_PARTS."""
    from video_stream_segmenetation_tpu_torch.kernels import trunk_int8

    return {"alpha_head_i8": trunk_int8._alpha_head, "se_requant": trunk_int8._se_requant}


# the head and SE entry-point calls (kernels/trunk_int8.py) in one call of
# each counted trunk: one head with the int8 head; one SE after ctx and one
# in each residual block that has one.  trunk_err holds every trunk form it
# checks to it on the card; the kernels line's alpha_head_i8 and se_requant
# launches are the main path's trunk calls times these (add_launches).
TRUNK_PARTS = {"trunk_int8": (1, 1), "trunk_int8_u1": (0, 1), "micro_trunk": (1, 3),
               "light_trunk": (1, 3), "full_trunk": (1, 3)}


def add_launches(by_name: dict, launches: dict, entries=None) -> None:
    """Add a phase's counts to the kernels line's entries (``entries``
    renames some counters), and its trunk calls' head and SE calls
    (TRUNK_PARTS) to alpha_head_i8 and se_requant."""
    for counter, n in launches.items():
        entry = (entries or {}).get(counter, counter)
        if entry in by_name:
            by_name[entry]["launches"] += n
        heads, ses = TRUNK_PARTS.get(counter, (0, 0))
        by_name["alpha_head_i8"]["launches"] += heads * n
        by_name["se_requant"]["launches"] += ses * n


def phase_label(name: str, overrides=None) -> str:
    """A serve phase's label: the preset and its overrides."""
    return name + "".join(f", {k}={v!r}" for k, v in (overrides or {}).items())


def serve(device, num_streams: int, steps: int, name: str = "fast_int8_pico",
          overrides=None, trained=False, min_iou=None, trees=None) -> dict:
    """Drive the port's Engine for ``steps`` steps; returns per-step times,
    the launch counts of the run, face and quality figures.  ``trained``:
    True, the trained weights and the committed frames; ``"seeded"``, the
    seed-0 matting tree with the trained face models, the committed
    frames; False, seeded weights and synthetic frames.  ``trees``
    (``params`` and/or ``face_params``, with ``trained=True``) replaces
    the committed weights by trees this run trained: then no reference
    mean or face bar applies, and with the face path on its models must
    have run on some stream.  With the int8 trunk on committed frames it
    then holds the served trunk against its plain version on the last
    frames of two streams (the card's inputs); the exact warp's
    fused_refine on the s2d layout is held and timed on the last step's
    inputs."""
    from video_stream_segmenetation_tpu_torch import bridge
    from video_stream_segmenetation_tpu_torch.runtime.presets import preset
    from video_stream_segmenetation_tpu_torch.service.engine import Engine

    statics = preset(name, **(overrides or {}))
    multiclass = statics.num_classes > 1
    fh, fw = FRAME_HW
    mh, mw = statics.mask_hw
    rng = np.random.default_rng(0)
    if trained:
        weights = (bridge.trained_weights(statics) if trained is True else
                   {"face_params": bridge.face_weights(statics)})
        weights.update(trees or {})
        eng = Engine(num_streams, statics, **weights, seed=0, device=device)
        clip, gt = bridge.load_frames()
        order = [np.arange(num_streams) % 2, (np.arange(num_streams) + 1) % 2]
        batches = [(clip[o], gt[o] > 127) for o in order]
    else:
        eng = Engine(num_streams, statics, seed=0, device=device)
        base = (rng.random((num_streams, fh, fw, 3)) * 90).astype(np.uint8)
    eng.admit_all()
    if name in FACE_GATE_OFF:
        # the engine's 0.180 s wall-clock face gate against steps of about
        # 90 ms would make the served IoU follow the host clock
        eng.face_min_interval_s = 0.0
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
    prior = np.zeros((num_streams,), bool)
    scores = []
    held_composite, held_refine = {}, {}
    s2d_refine = statics.frame_layout == "s2d" and statics.warp_impl == "exact"
    for t in range(steps):
        if trained:
            frames, truth = batches[t % 2]
        else:
            frames, inside = synthetic_frames(rng, base, t)
        last = t == steps - 1
        undo = []
        if last and statics.use_fused_composite is True:
            undo.append(record_composite(held_composite))
        if last and s2d_refine:
            undo.append(record_fused_refine(held_refine))
        t0 = time.perf_counter()
        try:
            out = eng.process(frames)
        finally:
            for restore in undo:
                restore()
        if device != "cpu":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if out["passthrough"]:
            raise AssertionError(f"step {t} was served as passthrough: "
                                 f"{eng.stats()['health']}")
        applied |= out["face_applied"].cpu().numpy()
        if "face_has_prior" in out:
            prior |= out["face_has_prior"].cpu().numpy()
        ds = out["det_score"].cpu().numpy()
        scores.extend(ds[ds > 0].tolist())
    launches = {k: c.launches for k, c in counters.items()}
    passthrough = eng.stats()["passthrough_steps"]
    if passthrough:
        raise AssertionError(f"{passthrough} passthrough steps in a serve phase")
    alpha = out["alpha"].float()
    from video_stream_segmenetation_tpu_torch.runtime.pipeline import refine_routing

    # refined_dtype applies on the fused temporal refine only, as the reference
    want_dtype = (torch.bfloat16 if statics.refined_dtype == "bf16" and not multiclass
                  and refine_routing(statics)["use_fused_tr"] else torch.float32)
    frame = out["frame"]
    if tuple(frame.shape) != (num_streams, fh, fw, 3) or frame.dtype != torch.uint8:
        raise AssertionError(f"frame {tuple(frame.shape)} {frame.dtype}")
    if tuple(alpha.shape) != (num_streams, mh, mw) or out["alpha"].dtype != want_dtype:
        raise AssertionError(f"alpha {tuple(alpha.shape)} {out['alpha'].dtype}")
    if not bool(torch.isfinite(alpha).all()) or alpha.min() < 0 or alpha.max() > 1:
        raise AssertionError("alpha is not finite in [0, 1]")
    res = {"times_ms": times, "launches": launches, "health":
           eng.stats()["health"]["state"], "applied": int(applied.sum()),
           "prior": int(prior.sum()),
           "passthrough": passthrough,
           "det_score": float(np.mean(scores)) if scores else 0.0,
           "peak_mib": (torch.cuda.max_memory_allocated() / 2**20 if device != "cpu"
                        else None)}
    if statics.background != "image":
        res["background"] = statics.background
        # a tree trained a few steps may leave no pixel at exactly 0
        res["bg_pixels"] = background_check(statics, frames, out, require=not trees)
    if held_composite:
        res["composite_err"] = hold_composite(held_composite)
    if held_refine:
        res["fused_refine"] = hold_fused_refine(held_refine)
    if multiclass:
        ca = out["class_alpha"]
        if tuple(ca.shape) != (num_streams, mh, mw, statics.num_classes) \
                or not bool(torch.isfinite(ca).all()):
            raise AssertionError(f"class_alpha {tuple(ca.shape)} not finite or misshaped")
        res["simplex_err"] = (ca.sum(-1) - 1.0).abs().max().item()
        if not res["simplex_err"] <= 1e-3:
            raise AssertionError(f"class_alpha sums to 1 only within {res['simplex_err']}")
    ref_means = None if trees else REFERENCE_MEANS.get(phase_label(name, overrides))
    if trained and ref_means is not None:
        maps = out["class_alpha"] if multiclass else alpha[..., None]
        res["class_means"] = maps.double().mean(dim=(0, 1, 2)).tolist()
        res["ref_means"] = ref_means
        err = max(abs(g - w) for g, w in zip(res["class_means"], ref_means))
        if not err <= CLASS_MEAN_TOL:
            raise AssertionError(f"map means {res['class_means']} vs the reference's "
                                 f"{ref_means}: {err}")
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
        # (the multi-class step never reads face_path, as the reference's).
        # The MediaPipe landmark graph takes the committed person's face
        # for no face (score 1e-5), as the reference's engine does
        # (tests/test_torch_face_720p.py): there the detector's prior must
        # have been applied instead of the affine
        if statics.face_path and not multiclass:
            got = res["prior"] if statics.face_models == "reference" else res["applied"]
            if trees:  # freshly trained face models: they must have run
                got = len(scores)
            if got == 0:
                raise AssertionError("the face path was applied to no stream")
        if statics.frame_layout == "s2d" and statics.matting_precision == "int8":
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

    def rec(frames, alpha, background, method="half_pixel"):
        held.setdefault("args", (frames.clone(), alpha.clone(), background.clone(), method))
        return orig(frames, alpha, background, method=method)

    pipeline.fused_composite = rec
    return lambda: setattr(pipeline, "fused_composite", orig)


def hold_composite(held: dict) -> int:
    """The composite kernel against its plain version on a served step's
    inputs (these launches come after the phase's counts were read)."""
    from video_stream_segmenetation_tpu_torch.kernels import composite_fused as KC
    from video_stream_segmenetation_tpu_torch.runtime.precision import pinned

    frames, alpha, bg, method = held["args"]
    got = KC.fused_composite(frames, alpha, bg, method=method)
    with pinned():
        want = KC.fused_composite_plain(frames, alpha.float(), bg, method)
    err = (got.int() - want.int()).abs().max().item()
    if err > COMPOSITE_TOL:
        raise AssertionError(f"composite kernel on a served step's inputs (background "
                             f"{tuple(bg.shape)}) disagrees with its plain version: {err}")
    return err


def record_fused_refine(held: dict):
    """Keep the inputs of the step's next fused_refine call in ``held`` (the
    call goes on and counts); returns the undo."""
    from video_stream_segmenetation_tpu_torch.runtime import pipeline

    orig = pipeline.fused_refine

    def rec(alpha, guide, prior, has_prior, knobs):
        held.setdefault("args", tuple(t.clone() for t in (alpha, guide, prior, has_prior))
                        + (knobs,))
        return orig(alpha, guide, prior, has_prior, knobs)

    pipeline.fused_refine = rec
    return lambda: setattr(pipeline, "fused_refine", orig)


def hold_fused_refine(held: dict) -> dict:
    """fused_refine against its plain version on a served step's inputs (the
    s2d exact-warp route: the warped and smoothed alpha, the planar u8
    guide off the packed frames, the prior plane), then both timed there
    (these launches come after the phase's counts were read)."""
    from video_stream_segmenetation_tpu_torch.kernels import refine_fused as TR

    alpha, guide, plane, has_prior, knobs = held["args"]
    table = TR.refine_table(knobs, has_prior)
    got = TR.fused_refine(alpha, guide, plane, has_prior, knobs)
    want = TR.fused_refine_plain(alpha, guide, plane, table)
    err = (got - want).abs().max().item()
    if not err <= REFINED_F32_TOL:
        raise AssertionError(f"fused_refine on a served step's inputs disagrees with its "
                             f"plain version: {err}")
    ms = cuda_time_ms(lambda: TR.fused_refine(alpha, guide, plane, has_prior, knobs), 20)
    plain_ms = cuda_time_ms(lambda: TR.fused_refine_plain(alpha, guide, plane, table), 3)
    s, h, w = alpha.shape
    px = s * h * w
    bytes_moved = px * (4 + 3 + 4 + 4) + table.numel() * 4
    ops = refine_ops(table, (h, w)) - 10 * px  # no EMA in this kernel
    bound_ms, bound_by = bound(bytes_moved, ops, F32_OPS_PER_S)
    return {"name": "fused_refine_s2d", "route": "cuda",
            "source": "video_stream_segmenetation_tpu_torch/csrc/refine_fused.cu",
            "replaces": "video_stream_segmenetation_tpu/kernels/refine_fused.py:522",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "shape": (s, h, w)}


def background_check(statics, frames_np, out, require: bool = True) -> int:
    """Where the served alpha upsamples to exactly 0 (every tap on a zero
    of the refined alpha), the served frame is the background: the colour
    rounded to u8, or the frame blurred.  Returns the pixels checked; with
    ``require`` there must be some."""
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
    if (require and checked == 0) or bad:
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
             min_interval=None, sync_check: bool = False,
             name: str = "fast_int8_pico") -> dict:
    """Serve the preset ``name`` (with ``overrides``, trained weights) through
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

    statics = preset(name, **overrides)
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
        step_frames = [eng._ingest(f, rows=offs[g + 1] - offs[g], i0=offs[g])[1]
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


# the face models' forwards are timed on the compact batch of S=64 streams
# at lmk_interval 6
FACE_K = 11
# the MediaPipe graphs on the card against the CPU, both f32 under pinned
# precision: the bar the reference holds its own jitted graph to against
# its numpy oracle
FACE_GRAPH_RTOL, FACE_GRAPH_ATOL = 1e-4, 1e-5


def phase_refface_round(device, sizes=(24, 24, 16), rounds=2) -> dict:
    """fast_int8_pico_refface through the rotation's fused rounds
    (face_min_interval_s=0), one more round whose step runs under
    set_sync_debug_mode('error'); then the face models' forwards on
    FACE_K streams, CUDA events, and the MediaPipe graphs on the card held
    against the CPU on two letterboxed committed frames."""
    from video_stream_segmenetation_tpu_torch import bridge
    from video_stream_segmenetation_tpu_torch.models.blazeface import FaceFinder
    from video_stream_segmenetation_tpu_torch.models.facemesh import LandmarkNet
    from video_stream_segmenetation_tpu_torch.models.quantized_face import (
        QuantizedFaceFinder,
        QuantizedLandmarkNet,
        quantize_face_finder,
        quantize_landmark_net,
    )
    from video_stream_segmenetation_tpu_torch.models.reference_face import (
        ReferenceFaceFinder,
        ReferenceLandmarkNet,
    )
    from video_stream_segmenetation_tpu_torch.runtime.pipeline import letterbox_to_square
    from video_stream_segmenetation_tpu_torch.runtime.precision import pinned

    res = rotation(device, sizes, {}, rounds, fused=True, min_interval=0.0, sync_check=True,
                   name="fast_int8_pico_refface")
    eng = res["engine"]
    if not (isinstance(eng.face_models.face, ReferenceFaceFinder)
            and isinstance(eng.face_models.lmk, ReferenceLandmarkNet)):
        raise AssertionError(f"refface round: the face models are {eng.face_models}")
    want = {"trunk_int8": len(sizes) * rounds, "refine_fused": len(sizes) * rounds}
    for counter, got in res["launches"].items():
        if got != want.get(counter, 0):
            raise AssertionError(f"refface round: {counter} launched {got} times in {rounds} "
                                 f"rounds, expected {want.get(counter, 0)}")
    out = {"launches": res["launches"], "parts_ms": res["parts_ms"], "iou": res["iou"],
           "peak_mib": res["peak_mib"], "latencies_ms": res["latencies_ms"]}
    res["sched"].stop()
    del res, eng
    torch.cuda.empty_cache()

    clip, _ = bridge.load_frames()
    x256 = letterbox_to_square(torch.as_tensor(clip).to(torch.float32) / 255.0, FRAME_HW, 256)
    x192 = torch.nn.functional.interpolate(x256.permute(0, 3, 1, 2), size=(192, 192),
                                           mode="bilinear").permute(0, 2, 3, 1).contiguous()
    x128 = torch.nn.functional.interpolate(x256.permute(0, 3, 1, 2), size=(128, 128),
                                           mode="bilinear").permute(0, 2, 3, 1).contiguous()
    reps = (FACE_K + 1) // 2

    def batch(x):
        return x.repeat(reps, 1, 1, 1)[:FACE_K].to(device)

    trees = {n: bridge.load_export(bridge.WEIGHTS_DIR / f"{n}.npz")
             for n in ("facefinder_128", "landmarknet_128")}
    with pinned():
        models = {
            "MediaPipe detector (256, f32 graph)": (ReferenceFaceFinder(device), x256),
            "MediaPipe landmarks (192, f32 graph)": (ReferenceLandmarkNet(device), x192),
            "FaceFinder bf16 (128)": (FaceFinder(trees["facefinder_128"], 128, device=device),
                                      x128),
            "LandmarkNet bf16 (128)": (LandmarkNet(trees["landmarknet_128"], device=device),
                                       x128),
            "FaceFinder int8 (128, exact int8 convs)": (QuantizedFaceFinder(
                quantize_face_finder(trees["facefinder_128"]), 128, device=device), x128),
            "LandmarkNet int8 (128, exact int8 convs)": (QuantizedLandmarkNet(
                quantize_landmark_net(trees["landmarknet_128"]), device=device), x128),
        }
        times = {}
        for label, (model, x) in models.items():
            xb = batch(x)
            times[label] = cuda_time_ms(lambda m=model, xb=xb: m(xb), 10)
        errs = {}
        for label, key, cpu_model in (
                ("detector", "MediaPipe detector (256, f32 graph)", ReferenceFaceFinder("cpu")),
                ("landmarks", "MediaPipe landmarks (192, f32 graph)",
                 ReferenceLandmarkNet("cpu"))):
            card_model, x = models[key]
            want = cpu_model(x)
            got = card_model(x.to(device))
            for name, w in want.items():
                g = got[name].cpu()
                errs[f"{label} {name}"] = (g - w).abs().max().item()
                if not bool(((g - w).abs() <= FACE_GRAPH_ATOL + FACE_GRAPH_RTOL * w.abs()).all()):
                    raise AssertionError(f"MediaPipe {label} {name} on the card vs the CPU: "
                                         f"{errs[f'{label} {name}']}")
    out.update(times_ms=times, graph_err=errs)
    return out


# the mesh phase: MESH_N virtual shards of the card (and, with several
# cards, one shard a card); the reference's mesh bars (tests/
# test_parallel_train.py:90-91, tests/test_mesh_rotation.py:65)
MESH_N = 4
MESH_STEPS = 8
MESH_SIZES = (24, 24, 16)
MESH_ROUNDS = 3
MESH_FRAME_STEP, MESH_FRAME_SHARE, MESH_STATE_TOL = 1, 1e-3, 2e-2
MESH_FIT = {"hw": (240, 320), "batch": 32, "steps": 5, "lr": 5e-4, "log_every": 1}
MESH_LOSS_RTOL = 1e-4
# (c)'s one-step check: the data-parallel step's loss and summed gradients
# against the one-device step's, same tree and batch (f32, TF32 off).  On
# the H100 the least leaf cosine read 1 - 1.8e-12 over 2, 4 and 8 virtual
# shards (PERF.md section 6, PR 20); the bar leaves five orders of margin
# and still catches another loss (a mean of per-shard losses).  The trees
# after MESH_FIT's five Adam steps are printed only: leaves that start at
# zero take Adam's sign-like first steps from gradients near zero, so
# their cosine reads the summation order's noise
MESH_GRAD_COS = 1 - 1e-7
MESH_SERVED = ("trunk_int8", "refine_fused")


def dp_grad_gap(mesh, card, hw, batch: int, seed: int = 0, loss: str = "matting") -> dict:
    """One training step's gradients over ``mesh``
    (train/step.py::make_dp_train_step's ``grads``: the whole batch's loss,
    the replicas' gradients summed in shard order) against the one-device
    step's, in f32 on the seeded tree of ``seed`` and one synthetic batch:
    ``{"loss_rel", "min_cos", "leaf"}``, the least leaf cosine and its leaf
    (a leaf zero on both sides counts as equal).  ``loss``: ``"matting"``
    (the plan-D pico at its widths, the step's own matting loss),
    ``"pipeline"`` (the pico, losses.make_pipeline_loss passed as
    ``loss_fn``) or ``"u2"`` (the SaliencyNet, train/realbg.py::
    u2_loss_fn)."""
    from video_stream_segmenetation_tpu_torch.models.mattenet_hd import MatteNetHD
    from video_stream_segmenetation_tpu_torch.models.u2net import SaliencyNet, init_u2net_params
    from video_stream_segmenetation_tpu_torch.runtime.precision import pinned
    from video_stream_segmenetation_tpu_torch.train import realbg as RB
    from video_stream_segmenetation_tpu_torch.train.loop import (
        seeded_tree,
        synthetic_matting_batch,
    )
    from video_stream_segmenetation_tpu_torch.train.losses import (
        make_pipeline_loss,
        matting_loss,
    )
    from video_stream_segmenetation_tpu_torch.train.step import (
        make_dp_train_step,
        make_optimizer,
    )

    def model():
        if loss == "u2":
            m = SaliencyNet(init_u2net_params(seed), dtype=torch.float32, device=card)
        else:
            m = MatteNetHD(10, 4, "pico", dtype=torch.float32, device=card)
            m.load_tree(seeded_tree(m, seed))
        m.requires_grad_(True)
        return m

    def loss_of(m):
        if loss == "pipeline":
            return make_pipeline_loss(m)
        if loss == "u2":
            return RB.u2_loss_fn(m)
        return lambda fr, gt: matting_loss(m(fr), gt, fr)

    models = [model(), model()]
    frames, gt = synthetic_matting_batch(torch.Generator(device=card).manual_seed(seed),
                                         batch, hw)
    named = list(models[0].named_parameters())
    with pinned():
        with torch.enable_grad():
            loss1, _ = loss_of(models[0])(frames, gt)
            g1 = torch.autograd.grad(loss1, [p for _, p in named], allow_unused=True)
        lossm, _, gm = make_dp_train_step(
            models[1], make_optimizer(), mesh, batch,
            loss_fn=None if loss == "matting" else loss_of(models[1])).grads(frames, gt)
    coss = {}
    for (k, p), a in zip(named, g1):
        a = (torch.zeros_like(p) if a is None else a).double().flatten()
        b = gm[k].double().flatten()
        na, nb = float(a.norm()), float(b.norm())
        coss[k] = 1.0 if na == nb == 0 else float(a @ b) / max(na * nb, 1e-300)
    leaf = min(coss, key=coss.get)
    lossm, loss1 = float(lossm.detach()), float(loss1.detach())
    return {"loss_rel": abs(lossm - loss1) / abs(loss1),
            "min_cos": coss[leaf], "leaf": leaf}


def _mesh_gap(got: dict, want: dict, what: str) -> dict:
    """One result against another within the mesh bars: face_applied equal,
    frames within one u8 step on all but 0.1 % of the pixels, alpha within
    MESH_STATE_TOL."""
    if not torch.equal(got["face_applied"].cpu(), want["face_applied"].cpu()):
        raise AssertionError(f"mesh {what}: face_applied differs")
    d = (got["frame"].to(torch.int32) - want["frame"].to(torch.int32)).abs()
    gap = {"frame_max": int(d.max().item()), "frame_share": float((d > 0).float().mean()),
           "alpha": float((got["alpha"].float() - want["alpha"].float()).abs().max())}
    if (gap["frame_max"] > MESH_FRAME_STEP or gap["frame_share"] >= MESH_FRAME_SHARE
            or gap["alpha"] > MESH_STATE_TOL):
        raise AssertionError(f"mesh {what}: {gap}")
    return gap


def _tree_leaves(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        return {k2: v for k, sub in tree.items()
                for k2, v in _tree_leaves(sub, f"{prefix}/{k}").items()}
    return {prefix: np.asarray(tree, np.float64)}


def phase_mesh(device) -> dict:
    """Engine(mesh=...) and fit(mesh=...) (parallel/mesh.py) on the card:
    (a) Engine(S, fast_int8_pico, mesh of MESH_N virtual shards) against
    Engine(S) on the committed frames and trained weights, face_min_interval
    0, MESH_STEPS steps (process, then dispatch/collect): face_applied equal,
    frames and alpha within the mesh bars, the trunk and the refine kernel
    exactly MESH_N times the one-device engine's launches; (b) the fused
    rotation StreamScheduler(group_sizes=MESH_SIZES) over the same two
    engines (the native pool), MESH_ROUNDS rounds, held group by group, the
    kernels once a piece (a group's part of a shard), then one more mesh
    round under set_sync_debug_mode('error'); (c) the plan-D pico at its
    widths in f32 over the mesh against one device from the same seed: one
    step's loss within MESH_LOSS_RTOL and summed gradients' least leaf
    cosine MESH_GRAD_COS (:func:`dp_grad_gap`), then fit's MESH_FIT losses
    within MESH_LOSS_RTOL (the trees' least leaf cosine printed); (d)
    graft_entry.dryrun_multichip(MESH_N).  With several
    cards (a) and (c) run again with one shard a card."""
    from video_stream_segmenetation_tpu_torch import bridge, graft_entry
    from video_stream_segmenetation_tpu_torch.models.mattenet_hd import MatteNetHD
    from video_stream_segmenetation_tpu_torch.parallel import make_mesh
    from video_stream_segmenetation_tpu_torch.runtime.scheduler import StreamScheduler
    from video_stream_segmenetation_tpu_torch.train.loop import fit

    counters = _counters()
    card = torch.device(device, 0) if device == "cuda" else torch.device(device)
    meshes = {"virtual": make_mesh(MESH_N, devices=[card] * MESH_N)}
    count_cards = torch.cuda.device_count() if device == "cuda" else 1
    if count_cards >= 2:
        meshes["cards"] = make_mesh(devices=[torch.device("cuda", i)
                                             for i in range(count_cards)])
    clip, _ = bridge.load_frames()
    batches = [np.ascontiguousarray(clip[(np.arange(S) + t) % 2]) for t in range(2)]
    out = {"launches": {k: 0 for k in counters}, "meshes": list(meshes)}

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    def count(fn):
        for c in counters.values():
            c.launches = 0
        r = fn()
        got = {k: c.launches for k, c in counters.items()}
        for k, v in got.items():
            out["launches"][k] += v
        return r, got

    def serve(eng):
        res, ms = [], []
        for t in range(MESH_STEPS):
            sync()
            t0 = time.perf_counter()
            if t < MESH_STEPS // 2:
                r = eng.process(batches[t % 2])
            else:
                r = eng.collect(eng.dispatch(batches[t % 2]))
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            if r["passthrough"]:
                raise AssertionError(f"mesh: a passthrough step: {eng.stats()['health']}")
            res.append({k: r[k] for k in ("frame", "alpha", "face_applied")})
        return res, ms

    # ---- (a) Engine(mesh) against one device
    engines, served = {}, {}
    for name, mesh in (("one", None), *meshes.items()):
        eng = _pico_engine(device, S, mesh=mesh)
        eng.face_min_interval_s = 0.0
        engines[name] = eng
        served[name] = count(lambda eng=eng: serve(eng))
    (one_res, one_ms), one_launch = served["one"]
    # a CPU rehearsal runs the plain versions: no launches there
    on_card = device != "cpu"
    a = {}
    for name in meshes:
        (res, ms), launch = served[name]
        n = len(meshes[name].data_devices)
        for counter, got in launch.items():
            want = n * one_launch[counter]
            steps = MESH_STEPS if on_card and counter in MESH_SERVED else 0
            if got != want or one_launch[counter] != steps:
                raise AssertionError(f"mesh ({name}): {counter} launched {got} times, the "
                                     f"one-device engine {one_launch[counter]}")
        gaps = [_mesh_gap(g, w, f"({name}) step {t}")
                for t, (g, w) in enumerate(zip(res, one_res))]
        st, st1 = engines[name].state, engines["one"].state
        if not torch.equal(st.frame_idx, st1.frame_idx):
            raise AssertionError(f"mesh ({name}): frame_idx differs")
        prev = float((st.prev_alpha - st1.prev_alpha).abs().max())
        if prev > MESH_STATE_TOL:
            raise AssertionError(f"mesh ({name}): prev_alpha {prev}")
        a[name] = {"launches": launch, "frame_max": max(g["frame_max"] for g in gaps),
                   "frame_share": max(g["frame_share"] for g in gaps),
                   "alpha": max(g["alpha"] for g in gaps), "prev_alpha": prev,
                   "applied": int(sum(int(g["face_applied"].sum()) for g in res)),
                   "process_ms": statistics.median(ms[:MESH_STEPS // 2]),
                   "dispatch_ms": statistics.median(ms[MESH_STEPS // 2:])}
    out["a"] = a
    out["one"] = {"launches": one_launch, "process_ms": statistics.median(
        one_ms[:MESH_STEPS // 2]), "dispatch_ms": statistics.median(one_ms[MESH_STEPS // 2:])}

    # ---- (b) the fused rotation over the same engines
    sizes = list(MESH_SIZES)
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(int).tolist()
    rounds, rms = {}, {}
    for name in ("one", "virtual"):
        eng = engines[name]
        sched = StreamScheduler(eng, group_sizes=sizes, fused_rounds=True)
        if sched.pool is None:
            raise AssertionError(f"mesh: the native FramePool did not build "
                                 f"({sched.pool_error!r})")

        def drive(sched=sched):
            got, ms = [], []
            for r in range(MESH_ROUNDS):
                for s in range(S):
                    sched.push_frame(s, clip[(s + r) % 2])
                sync()
                t0 = time.perf_counter()
                res = sched.step_round()
                sync()
                ms.append((time.perf_counter() - t0) * 1e3)
                got.extend(res or [])
            got.extend(sched.drain())
            return got, ms

        (got, ms), launch = count(drive)
        rounds[name], rms[name] = (got, launch, sched), ms
    pieces = sum(len(engines["virtual"]._pieces(offs[g], offs[g + 1]))
                 for g in range(len(sizes)))
    for counter in counters:
        want = {"one": len(sizes), "virtual": pieces}
        for name in ("one", "virtual"):
            got = rounds[name][1][counter]
            expect = want[name] * MESH_ROUNDS if on_card and counter in MESH_SERVED else 0
            if got != expect:
                raise AssertionError(f"mesh rotation ({name}): {counter} launched {got} "
                                     f"times, expected {expect}")
    gaps = []
    for i, (g, w) in enumerate(zip(rounds["virtual"][0], rounds["one"][0])):
        if g["slots"] != w["slots"] or g["passthrough"] or w["passthrough"]:
            raise AssertionError(f"mesh rotation: result {i} slots {g['slots']} vs "
                                 f"{w['slots']}, passthrough {g['passthrough']}")
        gaps.append(_mesh_gap(g, w, f"rotation result {i}"))
    st, st1 = engines["virtual"].state, engines["one"].state
    prev = float((st.prev_alpha - st1.prev_alpha).abs().max())
    if not torch.equal(st.frame_idx, st1.frame_idx) or prev > MESH_STATE_TOL:
        raise AssertionError(f"mesh rotation: state departs (prev_alpha {prev})")
    # one more mesh round, its step under set_sync_debug_mode('error')
    eng, sched = engines["virtual"], rounds["virtual"][2]
    for s in range(S):
        sched.push_frame(s, clip[s % 2])
    host = [sched._group_frames(offs[g], offs[g + 1])[0] for g in range(len(sizes))]
    step_frames = [eng._ingest(f, rows=offs[g + 1] - offs[g], i0=offs[g])[1]
                   for g, f in enumerate(host)]
    sync()
    eng._dispatches = 0
    if device != "cpu":
        torch.cuda.set_sync_debug_mode("error")
    try:
        eng.round_step(sizes, step_frames, time.monotonic())
    finally:
        if device != "cpu":
            torch.cuda.set_sync_debug_mode("default")
    sync()
    for name in ("one", "virtual"):
        rounds[name][2].stop()
    out["b"] = {"pieces": pieces, "launches": {n: rounds[n][1] for n in rounds},
                "frame_max": max(g["frame_max"] for g in gaps),
                "frame_share": max(g["frame_share"] for g in gaps),
                "alpha": max(g["alpha"] for g in gaps), "prev_alpha": prev,
                "round_ms": {n: statistics.median(rms[n]) for n in rms}}
    del engines, rounds, sched, eng
    if device != "cpu":
        torch.cuda.empty_cache()

    # ---- (c) fit over the mesh against one device
    fits = {}
    for name, mesh in (("one", None), *meshes.items()):
        model = MatteNetHD(10, 4, "pico", dtype=torch.float32, device=card)
        sync()
        t0 = time.perf_counter()
        tree, hist = fit(model, mesh=mesh, seed=0, **MESH_FIT)
        sync()
        fits[name] = (tree, hist, time.perf_counter() - t0)
    c = {}
    for name, mesh in meshes.items():
        grad = dp_grad_gap(mesh, card, MESH_FIT["hw"], MESH_FIT["batch"])
        if grad["loss_rel"] > MESH_LOSS_RTOL or grad["min_cos"] < MESH_GRAD_COS:
            raise AssertionError(f"mesh step ({name}) against one device: {grad}")
        tree, hist, wall = fits[name]
        tree1, hist1, _ = fits["one"]
        rel = max(abs(h["loss"] - h1["loss"]) / abs(h1["loss"]) for h, h1 in zip(hist, hist1))
        l1 = _tree_leaves(tree1)
        cos = min(float(np.dot(v.ravel(), l1[k].ravel())
                        / max(np.linalg.norm(v) * np.linalg.norm(l1[k]), 1e-30))
                  for k, v in _tree_leaves(tree).items())
        if len(hist) != MESH_FIT["steps"] or rel > MESH_LOSS_RTOL:
            raise AssertionError(f"mesh fit ({name}): loss relative {rel}")
        c[name] = {"grad": grad, "loss_rel": rel, "min_cos": cos, "wall_s": wall,
                   "losses": [h["loss"] for h in hist], "iou": hist[-1]["iou"]}
    out["c"] = c
    out["c_one"] = {"wall_s": fits["one"][2], "losses": [h["loss"] for h in fits["one"][1]]}

    # ---- (d) the dry run of the reference's entry point
    out["d"] = graft_entry.dryrun_multichip(MESH_N, None if device == "cuda"
                                            else [card] * MESH_N)
    return out


def say_mesh(ms: dict, smi: str, count: int) -> None:
    """Print the mesh phase's result lines."""
    for name, r in ms["a"].items():
        say(f"  mesh (a, {name}): face_applied equal on every step ({r['applied']} "
            f"applications), frames within {r['frame_max']} u8 step on all but "
            f"{r['frame_share']:.2e} of the pixels (bars {MESH_FRAME_STEP}, "
            f"{MESH_FRAME_SHARE:g}), alpha {r['alpha']:.3e}, prev_alpha {r['prev_alpha']:.3e} "
            f"(tolerance {MESH_STATE_TOL:g}); launches "
            + ", ".join(f"{c} {r['launches'][c]} vs {ms['one']['launches'][c]}"
                        for c in MESH_SERVED)
            + f" (one device); median step (host clock, synchronized) process "
            f"{r['process_ms']:.2f} ms vs {ms['one']['process_ms']:.2f} ms one device, "
            f"dispatch/collect {r['dispatch_ms']:.2f} ms vs {ms['one']['dispatch_ms']:.2f} ms; "
            f"{smi}")
    if "cards" not in ms["meshes"]:
        say(f"  mesh: the distinct-card form of (a) and (c) was not run: device_count={count}")
    b = ms["b"]
    say(f"  mesh (b): {b['pieces']} pieces a round on the mesh (3 groups on one device), "
        f"every group's result within the bars (frames {b['frame_max']} u8 step, share "
        f"{b['frame_share']:.2e}, alpha {b['alpha']:.3e}), prev_alpha {b['prev_alpha']:.3e}; "
        f"launches " + ", ".join(f"{n}: " + ", ".join(f"{c} {b['launches'][n][c]}"
                                                      for c in MESH_SERVED)
                                 for n in b["launches"])
        + f"; the checked round made no host synchronisation; median step_round call "
        f"{b['round_ms']['virtual']:.2f} ms mesh vs {b['round_ms']['one']:.2f} ms one device "
        f"(host clock, synchronized); {smi}")
    for name, r in ms["c"].items():
        g = r["grad"]
        say(f"  mesh (c, {name}): one step's loss relative {g['loss_rel']:.2e} (tolerance "
            f"{MESH_LOSS_RTOL:g}), summed gradients' least leaf cosine {g['min_cos']:.9f} "
            f"({g['leaf']}; at least {MESH_GRAD_COS}); fit losses "
            f"{[round(v, 5) for v in r['losses']]} vs one device "
            f"{[round(v, 5) for v in ms['c_one']['losses']]}, largest relative "
            f"{r['loss_rel']:.2e} (tolerance {MESH_LOSS_RTOL:g}), the trees' least leaf cosine "
            f"{r['min_cos']:.6f} (a reading, no bar), IoU {r['iou']:.4f}; "
            f"{r['wall_s']:.1f} s vs {ms['c_one']['wall_s']:.1f} s")
    say(f"  mesh (d): dryrun_multichip({MESH_N}) {ms['d']}")

# the step rollout: fast_int8_pico at S streams, a parity chain of
# ROLL_PARITY_N steps, slopes at (ROLL_N1, ROLL_N2) over ROLL_REPS paired
# reps; the round rollout: the production rotation (ROTATION, FAST_ROUTE),
# a parity chain of ROUND_N2 rounds, slopes at (ROUND_N1, ROUND_N2) over
# ROUND_REPS reps
ROLL_PARITY_N, ROLL_N1, ROLL_N2, ROLL_REPS = 4, 2, 10, 5
ROUND_N1, ROUND_N2, ROUND_REPS = 1, 3, 3


def _state_gap(a, b) -> float:
    """The largest difference of two StreamStates, every tensor."""
    from video_stream_segmenetation_tpu_torch.runtime.state import state_tensors

    return max((x.double() - y.double()).abs().max().item()
               for x, y in zip(state_tensors(a), state_tensors(b)))


def _acc_gap(a, b) -> float:
    """The largest difference of two accumulators (u8 buffers modulo 256)."""
    if a.dtype == torch.uint8:
        d = (a.int() - b.int()) % 256
        return torch.minimum(d, 256 - d).max().item()
    return (a.double() - b.double()).abs().max().item()


def phase_rollout(device) -> dict:
    """The rollouts (runtime/rollout.py) on the card.  The step rollout on
    fast_int8_pico at S streams (trained weights, committed frames): a chain
    of ROLL_PARITY_N steps against as many sequential make_step calls on the
    same tagged frames (state and both buffers bit for bit), then the slopes
    at (ROLL_N1, ROLL_N2) on both clocks in both acc_modes, beside the
    host-clock median of Engine.process.  The round rollout on the
    production rotation (ROTATION in groups, FAST_ROUTE): ROUND_N2 rounds
    under set_sync_debug_mode('error') against as many sequential round
    steps (bit for bit), the trunk and the fast refine launched once a
    group a round, then the slopes at (ROUND_N1, ROUND_N2)."""
    from video_stream_segmenetation_tpu_torch import bridge
    from video_stream_segmenetation_tpu_torch.runtime import rollout as RO
    from video_stream_segmenetation_tpu_torch.runtime.pipeline import (
        make_round_step,
        make_step,
    )
    from video_stream_segmenetation_tpu_torch.runtime.precision import pinned
    from video_stream_segmenetation_tpu_torch.runtime.presets import preset
    from video_stream_segmenetation_tpu_torch.runtime.state import map_state
    from video_stream_segmenetation_tpu_torch.service.engine import Engine

    counters = _counters()
    clip, _ = bridge.load_frames()
    out = {"launches": {k: 0 for k in counters}}

    def count(fn):
        for c in counters.values():
            c.launches = 0
        r = fn()
        got = {k: c.launches for k, c in counters.items()}
        for k, v in got.items():
            out["launches"][k] += v
        return r, got

    # ---- the step rollout
    st = preset("fast_int8_pico")
    weights = bridge.trained_weights(st)
    eng = Engine(S, st, **weights, seed=0, device=device)
    eng.face_min_interval_s = 0.0
    eng.admit_all()
    batches = [np.ascontiguousarray(clip[(np.arange(S) + t) % 2]) for t in range(2)]
    frames = batches[0]
    times = []
    for t in range(SERVE_STEPS):
        t0 = time.perf_counter()
        eng.process(batches[t % 2])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["process_ms"] = times
    fj = eng._ingest(frames)[1][0]
    gate = torch.ones((S,), dtype=torch.bool, device=eng.device)
    args = (eng.state, fj, eng.backgrounds, eng.knobs, gate)
    n = ROLL_PARITY_N
    rolls = {acc: RO.make_step_rollout(eng.model, st, eng.face_models, acc_mode=acc)
             for acc in ("buffer", "reduce")}
    (st_r, acc_f, acc_a), got = count(lambda: rolls["buffer"](*args, n))
    if device != "cpu" and (got["trunk_int8"] != n or got["refine_fused"] != n):
        raise AssertionError(f"step rollout of {n}: launches {got}")
    step = make_step(eng.model, st, eng.face_models)

    def sequential():
        s_, f_, a_ = eng.state, None, None
        with pinned():
            for i in range(n):
                s_, o = step(s_, fj if i == 0 else RO._perturb(fj, i), eng.backgrounds,
                             eng.knobs, gate)
                f_ = o["frame"] if f_ is None else f_ + o["frame"]
                a_ = o["alpha"] if a_ is None else a_ + o["alpha"]
        return s_, f_, a_

    (st_s, exp_f, exp_a), _ = count(sequential)
    torch.cuda.synchronize()
    out["step_parity"] = {"state": _state_gap(st_r, st_s), "frame": _acc_gap(acc_f, exp_f),
                          "alpha": _acc_gap(acc_a, exp_a)}
    if any(out["step_parity"].values()):
        raise AssertionError(f"step rollout vs {n} sequential steps: {out['step_parity']}")
    (timed, got) = count(lambda: RO.time_rollout([rolls["buffer"], rolls["reduce"]], args,
                                                 ROLL_N1, ROLL_N2, ROLL_REPS, device=device))
    out["step_slopes"] = dict(zip(("buffer", "reduce"), timed))
    del eng, rolls, args, st_r, st_s, acc_f, exp_f, acc_a, exp_a, fj
    torch.cuda.empty_cache()

    # ---- the round rollout: the production rotation
    sizes = list(ROTATION)
    nr = sum(sizes)
    st = preset("fast_int8_pico", **FAST_ROUTE)
    eng = Engine(nr, st, **weights, seed=0, device=device)
    eng.admit_all()
    offs = np.cumsum([0, *sizes])
    groups = [eng._ingest(np.ascontiguousarray(clip[np.arange(offs[g], offs[g + 1]) % 2]),
                          rows=sizes[g])[1][0] for g in range(len(sizes))]
    now0 = torch.full((), 5.0, dtype=torch.float32, device=eng.device)
    mi = eng._min_interval_device()

    def fresh():
        return (map_state(torch.clone, eng.state), groups, eng.backgrounds, eng.knobs,
                torch.full((nr,), -1e9, dtype=torch.float32, device=eng.device), now0, mi)

    roll = RO.make_round_rollout(eng.model, st, sizes, eng.face_models)
    roll(*fresh(), 1)  # first use: allocations and the library's handles
    torch.cuda.synchronize()
    n = ROUND_N2
    args = fresh()
    torch.cuda.set_sync_debug_mode("error")
    try:
        (rs, rlast, accs), got = count(lambda: roll(*args, n))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = len(sizes) * n
    if device != "cpu" and (got["trunk_int8"] != want or got["refine_fused_fast"] != want):
        raise AssertionError(f"round rollout of {n}: launches {got}, expected {want} each")
    rstep = make_round_step(eng.model, st, sizes, eng.face_models)

    def sequential_rounds():
        s_, _, _, _, last, _, _ = fresh()
        exp = None
        with pinned():
            for i in range(n):
                now = now0 + float(np.float32(i) * np.float32(1.0 / 30.0))
                fl = groups if i == 0 else [RO._perturb(f, i) for f in groups]
                s_, last, outs = rstep(s_, fl, eng.backgrounds, eng.knobs, last, now, mi)
                o = [(x["frame"], x["alpha"]) for x in outs]
                exp = o if exp is None else [(a + f, b + al) for (a, b), (f, al) in zip(exp, o)]
        return s_, last, exp

    (ss, slast, exp), _ = count(sequential_rounds)
    torch.cuda.synchronize()
    out["round_parity"] = {
        "state": _state_gap(rs, ss), "face_last": _acc_gap(rlast, slast),
        "frame": max(_acc_gap(a[0], e[0]) for a, e in zip(accs, exp)),
        "alpha": max(_acc_gap(a[1], e[1]) for a, e in zip(accs, exp))}
    if any(out["round_parity"].values()):
        raise AssertionError(f"round rollout vs {n} sequential rounds: {out['round_parity']}")
    del rs, ss, accs, exp
    (timed, _) = count(lambda: RO.time_rollout(roll, fresh, ROUND_N1, ROUND_N2, ROUND_REPS,
                                               device=device))
    out["round_slopes"] = timed
    del eng, groups
    torch.cuda.empty_cache()
    return out


SNAPSHOT_STEPS = 4


def phase_snapshot(device) -> dict:
    """utils/checkpoint.py on the card: Engine(S, fast_int8_pico) on the
    trained weights serves 3 steps of the committed frames and is saved; a
    fresh engine (another seed) restores it; both serve SNAPSHOT_STEPS more
    steps of the same frames (the last one a face cadence step), and every
    output and the state must be equal bit for bit."""
    import tempfile

    from video_stream_segmenetation_tpu_torch import bridge, utils
    from video_stream_segmenetation_tpu_torch.kernels import _build
    from video_stream_segmenetation_tpu_torch.runtime.presets import preset
    from video_stream_segmenetation_tpu_torch.service.engine import Engine

    counters = _counters()
    for c in counters.values():
        c.launches = 0
    st = preset("fast_int8_pico")
    clip, _ = bridge.load_frames()
    batches = [np.ascontiguousarray(clip[(np.arange(S) + t) % 2]) for t in range(2)]
    a = Engine(S, st, **bridge.trained_weights(st), seed=0, device=device)
    a.face_min_interval_s = 0.0
    a.admit_all()
    for t in range(3):
        a.process(batches[t % 2])
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        utils.save_engine(tmp + "/engine", a)
        size = sum(f.stat().st_size for f in Path(tmp).rglob("*") if f.is_file())
        b = Engine(S, st, seed=9, device=device)
        b.face_min_interval_s = 0.0
        b.admit_all()
        utils.restore_engine(tmp + "/engine", b)
    gaps = {"state after the restore": _state_gap(a.state, b.state)}
    for t in range(SNAPSHOT_STEPS):
        oa, ob = a.process(batches[t % 2]), b.process(batches[t % 2])
        for k in ("frame", "alpha", "det_score", "face_applied"):
            gaps[f"step {t} {k}"] = _acc_gap(oa[k], ob[k])
        gaps[f"step {t} state"] = _state_gap(a.state, b.state)
    if any(gaps.values()):
        raise AssertionError(f"restored engine departs from the uninterrupted one: {gaps}")
    return {"bytes": size, "launches": {k: c.launches for k, c in counters.items()},
            "applied": int(oa["face_applied"].sum().item())}


def _pico_engine(device, num_streams: int | None = None, **kw):
    """Engine(fast_int8_pico) at 720p (statics overrides and Engine options,
    ``mesh`` among them, in ``kw``), the committed trained weights loaded through its numpy
    loaders, every slot admitted, gradient backgrounds."""
    from video_stream_segmenetation_tpu_torch.bridge import WEIGHTS_DIR
    from video_stream_segmenetation_tpu_torch.runtime.presets import preset
    from video_stream_segmenetation_tpu_torch.service.engine import Engine

    num_streams = num_streams or S
    opts = {k: kw.pop(k) for k in ("output_layout", "collect_sync", "mesh") if k in kw}
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
    with Cin not a multiple of 32 (kernels/_build.py::check raises)."""
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
        def round_fails(step_frames, now):
            for g in range(2):
                eng._run_range(offs[g], offs[g + 1], step_frames[g], now)
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
    from_snap = eng._cheap_unpack(snap["host"][0]["packed"])
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
    """:func:`trunk_vs_plain` on the stem output ``x0``; the one trunk
    call it makes must call the head and the SE as TRUNK_PARTS says for its
    counter."""
    counters = {**_counters(), **_part_counters()}
    before = {k: c.launches for k, c in counters.items()}
    err = _trunk_err(model, x0)
    got = {k: c.launches - before[k] for k, c in counters.items()}
    trunks = [k for k in TRUNK_PARTS if got[k]]
    if len(trunks) != 1 or got[trunks[0]] != 1 or (
            got["alpha_head_i8"], got["se_requant"]) != TRUNK_PARTS[trunks[0]]:
        raise AssertionError(f"one trunk call ({model.decoder}, {model.head_impl} head) made "
                             f"the calls {got}; TRUNK_PARTS says {TRUNK_PARTS}")
    return err


def _trunk_err(model, x0) -> float:
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
# phase 52's bf16 leaf bar never falls below this, however far the CPU's own
# bf16 gradient of a leaf lies from its f32 one (a gradient the CPU gets
# wrong, not a rounding gap, would otherwise lower its own bar)
ZOO_BF16_COS_FLOOR = 0.9


def trainer_timed(run) -> dict:
    """``run(on_step) -> tree`` (a trainer of train/) on the card with a CUDA
    event after every step: the trained tree, each step's loss and
    grad_norm, the ms between consecutive steps' ends (the batch's
    generation and the step), the wall time and the peak device memory."""
    events, seen = [], []

    def on_step(i, metrics):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        seen.append(torch.stack([metrics["loss"], metrics["grad_norm"]]))

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tree = run(on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    loss, gnorm = torch.stack(seen).cpu().numpy().T
    return {"tree": tree, "loss": loss, "grad_norm": gnorm, "ms": ms, "wall_s": wall,
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20}


def fit_timed(model, **fit_kw) -> dict:
    """:func:`trainer_timed` of ``train.loop.fit``, its history added."""
    from video_stream_segmenetation_tpu_torch.train.loop import fit

    history = []

    def run(on_step):
        tree, hist = fit(model, on_step=on_step, **fit_kw)
        history.extend(hist)
        return tree

    return dict(trainer_timed(run), history=history)


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

# the train_zoo phase: every trainer of train/ at its full widths and the
# reference's geometry and batch, a few steps each
ZOO_FACE_STEPS, ZOO_STEPS, ZOO_FT_STEPS = 20, 5, 3
ZOO_CPU_BATCH = 2  # the card-vs-CPU step's batch (the trainers' geometry)
ZOO_SERVE_S, ZOO_SERVE_STEPS = 8, 2
CLIP_FRAMES = 4
# the trainers' geometry and batch (the reference's): hw and batch of each
ZOO_GEOM = {"face": ((288, 512), 32), "rvm": ((288, 512), 8), "u2": ((320, 320), 16),
            "multiclass": ((288, 512), 12), "mc_pre": ((240, 320), 24),
            "mc_ft": (FRAME_HW, 6)}
# the preset serving each trained tree (zoo_jobs' keys)
ZOO_SERVES = {"fast_int8_pico": {"face_params": {"face": "face", "lmk": "lmk"}},
              "active": {"params": "mattenet"}, "multiclass": {"params": "multiclass"},
              "rvm": {"params": "rvm"}, "u2": {"params": "u2"}, "fast": {"params": "plan_a"},
              "multiclass_fast_pico": {"params": "mc_pico"}}
# the clip's frames (u8) and alpha, card vs CPU: the two evaluate sin, atan2
# and sqrt to other last bits, and an f32 pixel coordinate at 720p resolves
# only 6.1e-5 px (its ulp between 512 and 1024) across soft edges at least
# 1 px wide (an H100 against its host CPU: 1.96e-5)
CLIP_U8_TOL, CLIP_ALPHA_TOL = 1, 5e-5


def zoo_jobs(dev) -> list[dict]:
    """The trainers, each ``{"label", "key", "start" (the seeded tree it starts
    from), "phases" [(label, run(on_step) -> tree)], "model(tree, dtype,
    device)", "batch()" (CPU tensors), "loss(model, *batch)"}``: the face
    models at FD/LMK 128 on 288x512 scenes, batch 32 (train/
    face_trainer.py); RVM, SaliencyNet, the K=4 MatteNet and the K=4
    MatteNetHD pico (train/variants.py); the flagship's plans A, B, C and
    the MatteNet (train/flagship.py, train/loop.py::fit)."""
    from video_stream_segmenetation_tpu_torch.models.blazeface import (
        FaceFinder,
        init_face_finder_params,
    )
    from video_stream_segmenetation_tpu_torch.models.facemesh import (
        LandmarkNet,
        init_landmark_net_params,
    )
    from video_stream_segmenetation_tpu_torch.models.mattenet_hd import MatteNetHD, init_params
    from video_stream_segmenetation_tpu_torch.models.modnet import MatteNet, init_mattenet_params
    from video_stream_segmenetation_tpu_torch.models.rvm import RecurrentMatteNet, init_rvm_params
    from video_stream_segmenetation_tpu_torch.models.u2net import SaliencyNet, init_u2net_params
    from video_stream_segmenetation_tpu_torch.train import face_trainer as FT
    from video_stream_segmenetation_tpu_torch.train import flagship as FL
    from video_stream_segmenetation_tpu_torch.train import variants as PV
    from video_stream_segmenetation_tpu_torch.train.face import (
        detector_loss,
        landmark_loss,
        synthetic_face_batch,
    )
    from video_stream_segmenetation_tpu_torch.train.loop import (
        fit,
        seeded_tree,
        synthetic_matting_batch,
    )
    from video_stream_segmenetation_tpu_torch.train.losses import matting_loss

    fd = lmk = 128
    (scene, face_b), b = ZOO_GEOM["face"], ZOO_CPU_BATCH
    (rvm_hw, rvm_b), (u2_hw, u2_b) = ZOO_GEOM["rvm"], ZOO_GEOM["u2"]
    (mc_hw, mc_b), (pre_hw, pre_b), (ft_hw, ft_b) = (ZOO_GEOM[k] for k in ("multiclass",
                                                                       "mc_pre", "mc_ft"))

    def gen():
        return torch.Generator().manual_seed(3)

    def face_batch():
        return synthetic_face_batch(gen(), b, scene)

    def class_batch(hw):
        def make():
            frames, _, _, parts = synthetic_face_batch(gen(), b, hw, return_parts=True)
            return frames, PV._class_simplex(parts)
        return make

    def matting_batch(hw):
        return lambda: synthetic_matting_batch(gen(), b, hw)

    def class_loss(m, frames, gt):
        return PV.class_loss(m(frames)["alpha"], gt)

    jobs = []
    fd_model = FaceFinder(init_face_finder_params(0), fd, device=dev)
    jobs.append({
        "label": f"FaceFinder FD {fd}, {scene[0]}x{scene[1]} scenes, batch {face_b}",
        "key": "face", "start": init_face_finder_params(0),
        "phases": [("", lambda on_step: FT.train_model(
            "facefinder", fd_model, FT.detector_loss_fn(fd_model, face_b, scene), ZOO_FACE_STEPS,
            on_step=on_step)[0])],
        "model": lambda t, dt, d: FaceFinder(t, fd, device=d, dtype=dt),
        "batch": lambda: FT.letterbox_batch(*face_batch()[:2], fd, scene),
        "loss": lambda m, x, gt: detector_loss(m(x), gt, m.anchors)})
    lmk_model = LandmarkNet(init_landmark_net_params(0), device=dev)

    def lmk_batch():
        frames, box, landmarks = face_batch()
        return FT.lmk_batch(FT.lmk_draws(gen(), b), frames, box, landmarks, lmk, scene)

    jobs.append({
        "label": f"LandmarkNet LMK {lmk}, batch {face_b}", "key": "lmk",
        "start": init_landmark_net_params(0),
        "phases": [("", lambda on_step: FT.train_model(
            "landmarknet", lmk_model, FT.landmark_loss_fn(lmk_model, face_b, lmk, scene),
            ZOO_FACE_STEPS, on_step=on_step)[0])],
        "model": lambda t, dt, d: LandmarkNet(t, device=d, dtype=dt), "batch": lmk_batch,
        "loss": lambda m, x, gt, face: landmark_loss(m(x), gt, face)})
    jobs.append({
        "label": f"RecurrentMatteNet {rvm_hw[0]}x{rvm_hw[1]}, batch {rvm_b}, unroll 3",
        "key": "rvm", "start": init_rvm_params(0),
        "phases": [("", lambda on_step: PV.train_rvm(ZOO_STEPS, rvm_hw, rvm_b, device=dev,
                                                     on_step=on_step)[0])],
        "model": lambda t, dt, d: RecurrentMatteNet(t, device=d, dtype=dt),
        "batch": lambda: (*synthetic_matting_batch(gen(), b, rvm_hw), torch.tensor(5)),
        "loss": lambda m, fr, gt, shift: PV.rvm_loss(m, fr, gt, shift, 3)})
    jobs.append({
        "label": f"SaliencyNet {u2_hw[0]}x{u2_hw[1]}, batch {u2_b}", "key": "u2",
        "start": init_u2net_params(0),
        "phases": [("", lambda on_step: PV.train_u2(ZOO_STEPS, u2_hw, u2_b, device=dev,
                                                    on_step=on_step)[0])],
        "model": lambda t, dt, d: SaliencyNet(t, device=d, dtype=dt),
        "batch": matting_batch(u2_hw), "loss": PV.u2_loss})
    jobs.append({
        "label": f"MatteNet K=4 {mc_hw[0]}x{mc_hw[1]}, batch {mc_b}", "key": "multiclass",
        "start": init_mattenet_params(0, 4),
        "phases": [("", lambda on_step: PV.train_multiclass(ZOO_STEPS, mc_hw, mc_b, device=dev,
                                                            on_step=on_step)[0])],
        "model": lambda t, dt, d: MatteNet(t, device=d, dtype=dt),
        "batch": class_batch(mc_hw), "loss": class_loss})
    mc = MatteNetHD(10, 4, "pico", device=dev, num_classes=4)
    jobs.append({
        "label": "MatteNetHD pico K=4", "key": "mc_pico",
        "start": init_params("pico", 0, 10, 4),
        "phases": [(f"{pre_hw[0]}x{pre_hw[1]} b{pre_b}", lambda on_step: PV._trainer(
                        "multiclass_hd/pre", mc, PV.class_loss_fn(mc, pre_b, pre_hw), ZOO_STEPS,
                        5e-4, on_step=on_step)[0]),
                   (f"{ft_hw[0]}x{ft_hw[1]} b{ft_b}", lambda on_step: PV._trainer(
                       "multiclass_hd/ft", mc, PV.class_loss_fn(mc, ft_b, ft_hw), ZOO_FT_STEPS,
                       2e-4, on_step=on_step)[0])],
        "model": lambda t, dt, d: MatteNetHD(10, 4, "pico", dtype=dt, params=t, device=d),
        "batch": class_batch(pre_hw), "loss": class_loss})
    for key in ("plan_a", "full", "light", "mattenet"):
        job = FL.JOBS[key]
        model = job.model(dev)
        (ph, pw), (sh, sw) = job.pretrain_hw, job.serve_hw

        def pre(on_step, job=job, model=model):
            return fit(model, hw=job.pretrain_hw, batch=job.pretrain_batch, steps=ZOO_STEPS,
                       lr=job.lr, log_every=ZOO_STEPS, on_step=on_step)[0]

        def ft(on_step, job=job, model=model):
            return fit(model, hw=job.serve_hw, batch=job.serve_batch, steps=ZOO_FT_STEPS,
                       lr=job.lr / 3, log_every=ZOO_FT_STEPS, init_params=model.tree(), seed=1,
                       on_step=on_step)[0]

        jobs.append({
            "label": f"flagship {job.name}", "key": key,
            "start": seeded_tree(model, 0),
            "phases": [(f"{ph}x{pw} b{job.pretrain_batch}", pre),
                       (f"{sh}x{sw} b{job.serve_batch}", ft)],
            "model": lambda t, dt, d, job=job: job.model(d, dt, t),
            "batch": matting_batch(job.pretrain_hw),
            "loss": lambda m, fr, gt: matting_loss(m(fr), gt, fr)})
    return jobs


def zoo_step_vs_cpu(job: dict, tree: dict, dev) -> dict:
    """One step's forward and backward of ``job``'s loss on the card and on
    the CPU, the same tree and batch (made on the CPU), in f32 then bf16:
    the losses and each leaf's gradient (a leaf the loss does not read: 0,
    as train/step.py takes it; ``"unread"`` names those leaves, and
    ``"unread_bf16"`` those whose bf16 gradient on the CPU is zero).  A
    leaf's bf16 cosine bar is 0.99, or where the CPU's own bf16 gradient
    lies farther from its f32 one, ``1 - 2 (1 - that cosine)`` (two bf16
    evaluations, independent roundings), never below
    :data:`ZOO_BF16_COS_FLOOR`; the whole gradient's cosine at least 0.99."""
    from video_stream_segmenetation_tpu_torch.runtime.precision import pinned

    import copy

    from video_stream_segmenetation_tpu_torch import bridge

    batch = job["batch"]()

    def grads(dt, d):
        """``(loss, gradients as float64 vectors, the leaves whose gradient
        is zero, by name, on the CPU)``."""
        m = job["model"](tree, dt, d)
        m.requires_grad_(True)
        params = list(m.parameters())
        with pinned():
            loss, _ = job["loss"](m, *(x.to(d) for x in batch))
            gs = torch.autograd.grad(loss, params, allow_unused=True)
        gs = [torch.zeros_like(p) if g is None else g for p, g in zip(params, gs)]
        zero = None
        if d == "cpu":
            g_model = copy.deepcopy(m)
            with torch.no_grad():
                for p, g in zip(g_model.parameters(), gs):
                    p.copy_(g)
            zero = [k for k, v in bridge.flatten(g_model.tree()).items() if not v.any()]
        return loss.item(), [g.double().cpu().flatten() for g in gs], zero

    def cos(a, b):
        na, nb = a.norm(), b.norm()
        return 1.0 if na == 0 and nb == 0 else float(a @ b / max(na * nb, 1e-30))

    (lc, gc, unread), (lg, gg, _) = grads(torch.float32, "cpu"), grads(torch.float32, dev)
    res = {"unread": unread,
           "f32": {"loss_rel": abs(lg - lc) / abs(lc), "loss_card": lg, "loss_cpu": lc,
                   "max_rel_l2": max(float((a - b).norm() / max(b.norm(), 1e-30))
                                     for a, b in zip(gg, gc)),
                   "min_cos": min(cos(a, b) for a, b in zip(gg, gc)), "leaves": len(gc)}}
    (bc, hc, res["unread_bf16"]), (bg, hg, _) = (grads(torch.bfloat16, "cpu"),
                                                 grads(torch.bfloat16, dev))
    bars = [max(ZOO_BF16_COS_FLOOR, min(STEP_BF16_COS, 1.0 - 2.0 * (1.0 - cos(h, g))))
            for h, g in zip(hc, gc)]
    coss = [cos(a, b) for a, b in zip(hg, hc)]
    res["bf16"] = {"loss_rel": abs(bg - bc) / abs(bc), "loss_card": bg, "loss_cpu": bc,
                   "min_cos": min(coss), "least_margin": min(c - bar for c, bar in zip(coss, bars)),
                   "min_bar": min(bars), "tree_cos": cos(torch.cat(hg), torch.cat(hc))}
    return res


def phase_train_zoo(dev) -> dict:
    """Every trainer of train/ on the card at its full widths and the
    reference's geometry and batch, a few steps each (:func:`zoo_jobs`):
    losses finite and every leaf moved, BatchNorm statistics included; one
    step against the CPU (:func:`zoo_step_vs_cpu`, phase 51's bars); each
    trained tree served ``ZOO_SERVE_STEPS`` steps of the Engine of the
    preset that serves its name at S=``ZOO_SERVE_S``, 720p, the committed
    frames (the int8 trunk held against its plain version; each serve's
    launch counts, as every serve phase's); then an articulated clip
    rendered on the card against the CPU's render of the same draws."""
    from video_stream_segmenetation_tpu_torch import bridge
    from video_stream_segmenetation_tpu_torch.train import person
    from video_stream_segmenetation_tpu_torch.utils.clips import articulated_clip

    t_phase = time.perf_counter()
    trained, out = {}, {"jobs": []}
    for job in zoo_jobs(dev):
        runs = [(label, trainer_timed(run)) for label, run in job["phases"]]
        tree = runs[-1][1]["tree"]
        for label, r in runs:
            if not (np.isfinite(r["loss"]).all() and np.isfinite(r["grad_norm"]).all()):
                raise AssertionError(f"train_zoo {job['label']} {label}: a loss or grad_norm "
                                     f"is not finite: {r['loss']} {r['grad_norm']}")
        t0 = time.perf_counter()
        held = zoo_step_vs_cpu(job, tree, dev)
        held["s"] = time.perf_counter() - t0
        # every leaf the loss reads moved (an unread head's zero gradient
        # leaves it where the weight decay's f32 rounding does)
        start, flat = bridge.flatten(job["start"]), bridge.flatten(tree)
        still = [k for k, v in start.items()
                 if np.array_equal(v, flat[k]) and k not in held["unread"]]
        if still or not all(np.isfinite(v).all() for v in flat.values()):
            raise AssertionError(f"train_zoo {job['label']}: leaves that did not move or are "
                                 f"not finite: {still}")
        stats = sum(k.startswith("batch_stats") for k in flat)
        b, f = held["bf16"], held["f32"]
        if not (b["loss_rel"] <= STEP_BF16_LOSS_TOL and b["least_margin"] >= 0
                and b["tree_cos"] >= STEP_BF16_COS
                and f["loss_rel"] <= STEP_F32_LOSS_TOL and f["max_rel_l2"] <= STEP_F32_GRAD_TOL):
            raise AssertionError(f"train_zoo {job['label']}: the card's step departs from the "
                                 f"CPU's: {held}")
        trained[job["key"]] = tree
        out["jobs"].append({"label": job["label"], "runs": runs, "held": held,
                            "leaves": len(flat), "stats": stats})
        torch.cuda.empty_cache()

    # each trained tree through the Engine of the preset that serves it
    serves = []
    for name, trees in ZOO_SERVES.items():
        trees = {k: (trained[v] if isinstance(v, str) else
                     {kk: trained[vv] for kk, vv in v.items()}) for k, v in trees.items()}
        if name == "multiclass_fast_pico":  # the int8 preset: the port's quantizer first
            trees["params"] = bridge.params_from_jax(trees["params"], 10, "pico")
        t0 = time.perf_counter()
        res = serve(torch.device(dev).type, ZOO_SERVE_S, ZOO_SERVE_STEPS, name, trained=True,
                    trees=trees)
        res["s"] = time.perf_counter() - t0
        serves.append((name, res))
        torch.cuda.empty_cache()
    out["serves"] = serves

    # an articulated clip on the card against the CPU's render of the same draws
    g = torch.Generator().manual_seed(0)
    draws = {"ident": person.sample_identity(g, 1), "pose": person.sample_pose(g, 1, FRAME_HW),
             "occ": person.occluder_draws(g, 1, FRAME_HW)}
    t0 = time.perf_counter()
    card = articulated_clip(CLIP_FRAMES, FRAME_HW, seed=0, features=True, device=dev, draws=draws)
    card_s = time.perf_counter() - t0
    cpu = articulated_clip(CLIP_FRAMES, FRAME_HW, seed=0, features=True, device="cpu", draws=draws)
    clip = {"u8_err": int(np.abs(card.frames.astype(np.int16) - cpu.frames).max()),
            "alpha_err": float(np.abs(card.alpha - cpu.alpha).max()),
            "box_err": float(np.abs(card.head_box - cpu.head_box).max()), "card_s": card_s,
            "alpha_mean": float(card.alpha.mean())}
    if not (clip["u8_err"] <= CLIP_U8_TOL and clip["alpha_err"] <= CLIP_ALPHA_TOL
            and 0.02 < clip["alpha_mean"] < 0.98):
        raise AssertionError(f"train_zoo: the card's articulated clip departs from the CPU's: "
                             f"{clip}")
    out["clip"] = clip
    out["wall_s"] = time.perf_counter() - t_phase
    return out


# the realbg phase: the photo-background trainers (train/realbg.py) at their
# widths, geometry and batch, a few steps each; fit over the mesh with a
# loss_fn; the quality gates (evaluate.py) on the committed pico and the
# flagship candidate
REALBG_STEPS = 4
REALBG_PHOTOS, REALBG_PHOTO_HW = 4, (1080, 1920)  # the reference's photographs' size
REALBG_CPU_BATCH = 2  # the card-vs-CPU step's batch (ZOO_CPU_BATCH; a part of no rows is empty)
REALBG_GATE_FRAMES = 8  # WARM (5) left out: 3 frames of IoU, 2 of flicker
REALBG_MESH_FIT = {"hw": (240, 320), "batch": 32, "steps": 3, "lr": 1.5e-4, "log_every": 1}
REALBG_MESH_LOSS_RTOL = 1e-6
# a job's card-vs-CPU step (f32, TF32 off): the loss within
# STEP_F32_LOSS_TOL and each leaf's gradient cosine at least
# REALBG_F32_LEAF_COS (the CPU tests' f32 bar against the reference); bf16:
# the loss within STEP_BF16_LOSS_TOL and the whole gradient's cosine
# STEP_BF16_COS.  Phase 51's leaf bars (relative L2 1e-3, bf16 cosine 0.9)
# are printed, not held: the trained MatteNet's leaves at 288x512 move by
# 1.7e-3 relative L2 on the CPU itself when the frames move by 1e-7, and
# the card's cuDNN sums read 6.4e-3 (PERF.md section 6)
REALBG_F32_LEAF_COS = 0.9999
# the committed pico on the synthetic gate: the reference's record
# (benchmarks/RESULTS.json "variants", 24 frames of its clip on its TPU); the
# port on the CPU read 0.9891 / 0.9924 / 0.00045 on 8 frames of its own
# draws.  IoU at least the record less IOU_SLACK, flicker at most the
# record plus GATE_FLICKER_TOL
REFERENCE_GATE = {"moving": 0.9892, "static": 0.9922, "flicker": 0.00046}
GATE_FLICKER_TOL = 0.01


def write_photos(directory: Path, n: int = REALBG_PHOTOS, hw=REALBG_PHOTO_HW) -> None:
    """``n`` seeded photographs (smooth colour fields with texture, numpy)
    as PNG and JPEG under ``directory``, at the reference's photographs'
    size."""
    from PIL import Image

    rng = np.random.default_rng(0)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for i in range(n):
        phase = rng.uniform(0, 6.283, 3)
        img = np.stack([127 + 90 * np.sin(xx / (97 + 31 * c) + yy / (61 + 17 * i) + phase[c])
                        for c in range(3)], -1)
        img += rng.normal(0, 18, (h, w, 3))
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            directory / f"photo{i}.{'png' if i % 2 else 'jpg'}")


def realbg_jobs(dev, photos) -> tuple[list, Path]:
    """``(jobs, the directory their trees are written to)``: the
    photo-background jobs (train/realbg.py), each ``{"label", "key",
    "start" (the tree it starts from), "run(on_step) -> tree" (the job
    through realbg.run, ``REALBG_STEPS`` steps a phase; its report in
    ``"report"``), "model(tree, dtype, device)", "batch()" (CPU tensors of
    the job's data at its geometry, REALBG_CPU_BATCH rows, from photos
    loaded on the CPU), "loss(model, *batch)"}``."""
    import dataclasses
    import tempfile

    from video_stream_segmenetation_tpu_torch.models.mattenet_hd import MatteNetHD
    from video_stream_segmenetation_tpu_torch.models.modnet import (
        MatteNet,
        init_mattenet_params,
    )
    from video_stream_segmenetation_tpu_torch.models.rvm import RecurrentMatteNet
    from video_stream_segmenetation_tpu_torch.models.u2net import SaliencyNet
    from video_stream_segmenetation_tpu_torch.train import realbg as RB
    from video_stream_segmenetation_tpu_torch.train import realdata as R
    from video_stream_segmenetation_tpu_torch.train import variants as PV
    from video_stream_segmenetation_tpu_torch.train.losses import (
        make_pipeline_loss,
        matting_loss,
    )

    out_dir = Path(tempfile.mkdtemp(prefix="realbg_trees_"))
    b = REALBG_CPU_BATCH

    def gen():
        return torch.Generator().manual_seed(3)

    def bank(hw, u8=True):
        return torch.as_tensor(R.load_background_bank(hw, photos, oversample=2.0, as_uint8=u8))

    def mixed(plan, hw, render_hw, classes=False):
        return lambda: RB.mixed_data_fn(bank(render_hw), plan, render_hw, classes)(gen(), b, hw)

    def runner(job: dict, name: str, pick: str):
        def run(on_step):
            job["report"], trees = RB.run(name, photos, out_dir, out_dir / f"{name}.json",
                                          RB.Options(steps=REALBG_STEPS), dev, on_step)
            return trees[pick]
        return run

    jobs = []
    for key in RB.JOBS:
        cfg = RB.JOBS[key]
        hw = cfg.hw
        if key == "realbg":
            job = {"start": init_mattenet_params(0, width=0.75),
                   "model": lambda t, dt, d: MatteNet(t, device=d, dtype=dt),
                   "batch": lambda hw=hw: R.make_real_bg_data_fn(
                       bank(hw, False).numpy(), device="cpu")(gen(), b, hw),
                   "loss": lambda m, fr, gt: matting_loss(m(fr), gt, fr),
                   "pick": f"{cfg.saves}_realbg"}
        elif key in ("flagship", "multiclass_pico"):
            job = {"start": RB.warm_tree(cfg.ckpt, float_hd=True),
                   "model": lambda t, dt, d: MatteNetHD(10, 4, "pico", dtype=dt, params=t,
                                                        device=d)}
            if key == "flagship":
                job["batch"] = lambda hw=hw: R.make_mixed_data_fn(R.make_real_bg_data_fn(
                    bank(hw).numpy(), person="articulated", device="cpu"))(gen(), b, hw)
                job["loss"] = lambda m, fr, gt: make_pipeline_loss(m)(fr, gt)
            else:  # the pre and polish phases' geometry
                job["batch"] = mixed(RB.CLASS_MIX, cfg.small_hw, cfg.small_hw, classes=True)
                job["loss"] = lambda m, fr, gt: PV.class_loss(m(fr)["alpha"], gt)
        elif key == "active":
            job = {"start": RB.warm_tree(cfg.ckpt),
                   "model": lambda t, dt, d: MatteNet(t, device=d, dtype=dt),
                   "batch": mixed(RB.THREE_WAY, hw, RB.RENDER_HW),
                   "loss": lambda m, fr, gt: make_pipeline_loss(m)(fr, gt)}
        elif key == "u2":
            job = {"start": RB.warm_tree(cfg.ckpt),
                   "model": lambda t, dt, d: SaliencyNet(t, device=d, dtype=dt),
                   "batch": mixed(RB.THREE_WAY, hw, RB.RENDER_HW),
                   "loss": lambda m, fr, gt: RB.u2_loss_fn(m)(fr, gt)}
        else:
            job = {"start": RB.warm_tree(cfg.ckpt),
                   "model": lambda t, dt, d: RecurrentMatteNet(t, device=d, dtype=dt),
                   "batch": lambda f=mixed(RB.TWO_WAY, hw, RB.RENDER_HW): (*f(),
                                                                          torch.tensor(5)),
                   "loss": lambda m, fr, gt, shift, u=cfg.unroll: PV.rvm_loss(m, fr, gt, shift,
                                                                              u)}
        phases = "" if not cfg.phases else f", its three phases {REALBG_STEPS} steps each"
        job.update(key=key, label=f"realbg {key} {hw[0]}x{hw[1]} batch {cfg.batch} lr "
                   f"{cfg.lr:g}{phases}")
        job["run"] = runner(job, key, job.pop("pick", cfg.saves))
        jobs.append(job)
    return jobs, out_dir


def phase_realbg(dev) -> dict:
    """The photo-background trainers on the card (:func:`realbg_jobs`, on
    REALBG_PHOTOS photographs the phase writes and deletes): losses and
    grad_norm finite, every leaf the loss reads moved, one step against the
    CPU (:func:`zoo_step_vs_cpu`, held as REALBG_F32_LEAF_COS says), ms a step and peak
    MiB; then fit over MESH_N virtual shards with make_pipeline_loss and
    with the U2 loss (:func:`dp_grad_gap`: the loss within
    REALBG_MESH_LOSS_RTOL and the least leaf cosine MESH_GRAD_COS of one
    device's; fit's REALBG_MESH_FIT losses against one device's within
    MESH_LOSS_RTOL); then the synthetic gate on the committed pico (held to
    REFERENCE_GATE) and on the flagship candidate, and the realistic gate
    on the committed pico over the photos, each gate's trunk and refine
    launches counted and the trunk held against its plain version."""
    import dataclasses
    import shutil
    import tempfile

    from video_stream_segmenetation_tpu_torch import bridge
    from video_stream_segmenetation_tpu_torch import evaluate as EV
    from video_stream_segmenetation_tpu_torch.models.mattenet_hd import MatteNetHD
    from video_stream_segmenetation_tpu_torch.parallel import make_mesh
    from video_stream_segmenetation_tpu_torch.train import realbg as RB
    from video_stream_segmenetation_tpu_torch.train.loop import fit
    from video_stream_segmenetation_tpu_torch.train.losses import make_pipeline_loss

    t_phase = time.perf_counter()
    photos = Path(tempfile.mkdtemp(prefix="realbg_photos_"))
    saved = (RB.JOBS, RB.MC_MIN_STEPS)
    out, trees_dir = {"jobs": []}, None
    try:
        t0 = time.perf_counter()
        write_photos(photos)
        out["photos_s"] = time.perf_counter() - t0
        # the active job's three phases and the K-class job's least steps cut
        RB.JOBS = {**RB.JOBS, "active": dataclasses.replace(
            RB.JOBS["active"], phases=tuple((lr, REALBG_STEPS) for lr, _ in
                                            RB.JOBS["active"].phases))}
        RB.MC_MIN_STEPS = (REALBG_STEPS, REALBG_STEPS)
        jobs, trees_dir = realbg_jobs(dev, photos)
        trained = {}
        for job in jobs:
            r = trainer_timed(job["run"])
            tree = r["tree"]
            if not (np.isfinite(r["loss"]).all() and np.isfinite(r["grad_norm"]).all()):
                raise AssertionError(f"{job['label']}: a loss or grad_norm is not finite: "
                                     f"{r['loss']} {r['grad_norm']}")
            t0 = time.perf_counter()
            held = zoo_step_vs_cpu(job, tree, dev)
            held["s"] = time.perf_counter() - t0
            # a leaf whose gradient is zero in bf16, the trainers' dtype (a
            # saturated gate: the trained RVM's first GRU), cannot move either
            start, flat = bridge.flatten(job["start"]), bridge.flatten(tree)
            unread = set(held["unread"]) | set(held["unread_bf16"])
            still = [k for k, v in start.items() if np.array_equal(v, flat[k]) and k not in unread]
            if still or not all(np.isfinite(v).all() for v in flat.values()):
                raise AssertionError(f"{job['label']}: leaves that did not move or are not "
                                     f"finite: {still}")
            b, f = held["bf16"], held["f32"]
            if not (b["loss_rel"] <= STEP_BF16_LOSS_TOL and b["tree_cos"] >= STEP_BF16_COS
                    and f["loss_rel"] <= STEP_F32_LOSS_TOL
                    and f["min_cos"] >= REALBG_F32_LEAF_COS):
                raise AssertionError(f"{job['label']}: the card's step departs from the "
                                     f"CPU's: {held}")
            trained[job["key"]] = tree
            report = {k: v for k, v in job["report"].items() if k != "history"}
            out["jobs"].append({"label": job["label"], "run": r, "held": held,
                                "leaves": len(flat), "report": report})
            torch.cuda.empty_cache()

        # fit over MESH_N virtual shards of the card with a loss_fn
        t_mesh = time.perf_counter()
        card = torch.device(dev)
        mesh = make_mesh(MESH_N, devices=[card] * MESH_N)
        fz = REALBG_MESH_FIT
        out["gaps"] = {loss: dp_grad_gap(mesh, card, fz["hw"], fz["batch"], loss=loss)
                       for loss in ("pipeline", "u2")}
        for loss, gap in out["gaps"].items():
            if not (gap["loss_rel"] <= REALBG_MESH_LOSS_RTOL
                    and gap["min_cos"] >= MESH_GRAD_COS):
                raise AssertionError(f"realbg mesh ({loss} loss): one step departs from one "
                                     f"device's: {gap}")
        hists = {}
        for name, m in (("one", None), ("mesh", mesh)):
            model = MatteNetHD(10, 4, "pico", dtype=torch.float32, device=card)
            t0 = time.perf_counter()
            _, hists[name] = fit(model, mesh=m, loss_fn=make_pipeline_loss(model), **fz)
            torch.cuda.synchronize()
            out[f"fit_{name}_s"] = time.perf_counter() - t0
        rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
               for a, b in zip(hists["mesh"], hists["one"])]
        if max(rel) > MESH_LOSS_RTOL or not all(np.isfinite([h["loss"] for h in hists["mesh"]])):
            raise AssertionError(f"realbg mesh fit: losses {hists} apart by {rel}")
        out["fit_rel"], out["fit_losses"] = rel, [h["loss"] for h in hists["mesh"]]
        out["mesh_s"] = time.perf_counter() - t_mesh

        # the gates: the committed pico and the flagship candidate
        counters = _counters()
        frames, _ = bridge.load_frames()
        gates = []

        def gate(label, kind, tree=None):
            for c in counters.values():
                c.launches = 0
            eng = EV.case_engine("fast_int8_pico", {}, tree, dev)
            t0 = time.perf_counter()
            if kind == "synthetic":
                gen = torch.Generator(device=eng.device).manual_seed(EV.CLIP_SEED)
                res = EV.eval_case(eng, REALBG_GATE_FRAMES, EV.clip_draws(
                    gen, eng.statics.frame_hw, REALBG_GATE_FRAMES))
                n = 2 * REALBG_GATE_FRAMES
            else:
                res = EV.realistic_case(eng, *EV.realistic_clips(
                    photos, eng.statics.frame_hw, REALBG_GATE_FRAMES, device=dev))
                n = 2 * REALBG_GATE_FRAMES
            torch.cuda.synchronize()
            res["s"] = time.perf_counter() - t0
            launches = {k: c.launches for k, c in counters.items()}
            want = {"trunk_int8": n, "refine_fused": n}
            if launches != {k: want.get(k, 0) for k in launches}:
                raise AssertionError(f"realbg gate {label}: launches {launches}, expected "
                                     f"{want}")
            res["trunk_err"] = trunk_vs_plain(eng.model, frames[:1], eng.statics.s2d_block)
            if res["trunk_err"] > TRUNK_TOL:
                raise AssertionError(f"realbg gate {label}: trunk vs plain "
                                     f"{res['trunk_err']} (tolerance {TRUNK_TOL})")
            vals = [v for m in res.values() if isinstance(m, dict) for v in m.values()] + [
                res[k] for k in ("iou_mean", "iou_min", "temporal_stability") if k in res]
            if not all(0.0 <= v <= 1.0 for v in vals):
                raise AssertionError(f"realbg gate {label}: {res}")
            gates.append((label, launches, res))
            return res

        res = gate("synthetic, committed pico", "synthetic")
        if not (res["moving"]["iou_mean"] >= REFERENCE_GATE["moving"] - IOU_SLACK
                and res["static"]["iou_mean"] >= REFERENCE_GATE["static"] - IOU_SLACK
                and res["static"]["flicker"] <= REFERENCE_GATE["flicker"] + GATE_FLICKER_TOL):
            raise AssertionError(f"realbg synthetic gate, committed pico: {res} (the "
                                 f"reference's record {REFERENCE_GATE})")
        gate("synthetic, this run's flagship candidate", "synthetic", trained["flagship"])
        gate("realistic, committed pico", "realistic")
        out["gates"] = gates
    finally:
        RB.JOBS, RB.MC_MIN_STEPS = saved
        shutil.rmtree(photos, ignore_errors=True)
        if trees_dir is not None:
            shutil.rmtree(trees_dir, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    return out


# the tools phase: the package's parity and tuning tools on the card, each
# against its own run on the CPU where the bar is the card's agreement
TOOLS_FRAMES = 8  # frames a clip (the committed frames cycled; each articulated clip)
TOOLS_ORACLE_FRAMES = 2  # parity_matting's per-pixel oracle frames, at --small's geometry
TOOLS_PHOTOS = 4
TOOL_FRAME_IOU = 0.99  # parity_check, card against CPU, every frame (the watch list's bar)
TOOL_IOU_SLACK = 0.02  # a mean IoU of the card against the CPU's (tests/test_torch_gates.py)
FIDELITY_REL = 1e-4  # face_parity port_fidelity max_rel (the reference's record: 1e-6 - 4e-6)
NMS_ABS = 1e-6  # face_parity blaze_nms rows (one f32 rounding)
DECODE_IOU = 0.9999  # face_parity decode_consistency, least box IoU (the record: 0.999999)
INT8_FLOAT_IOU = 0.99  # parity_matting int8_vs_float_pipeline at 720p (the record: 0.9991)
# parity_matting's oracle sections at --small's geometry: predicted, printed
# with the reading (the reference's record at 720p on its photographs:
# 0.9982 / 0.9942; at 96x128 the served masks are not the flagship's
# quality, and the guide's nearest taps against the oracle's bilinear
# resize part more pixels); the card is held to the CPU's reading
ORACLE_PREDICTION = 0.99


def tool_launches(name: str, launches: dict, trunk: int, refine: int) -> None:
    """A tool's card run launched the int8 trunk ``trunk`` times and the
    temporal refine (any form) ``refine`` times."""
    got = {"trunk": launches.get("trunk_int8", 0),
           "refine": sum(n for k, n in launches.items() if "refine" in k)}
    for kernel, want in (("trunk", trunk), ("refine", refine)):
        if got[kernel] != want:
            raise AssertionError(f"{name}: {kernel} launched {got[kernel]} times, expected "
                                 f"{want}; {launches}")


def phase_tools(dev) -> dict:
    """parity_check (the committed frames cycled to TOOLS_FRAMES, against
    the masks of its own CPU run; --synthetic on the card and on the CPU),
    face_parity's four sections, parity_matting (int8 against float at
    720p; the whole report at --small's geometry with TOOLS_ORACLE_FRAMES
    oracle frames, on the card and on the CPU), tune_adaptive_ema (two
    adapts at a moved gate and at the default) and diag_realistic_clips,
    on TOOLS_PHOTOS written photographs.  Each tool's launch counts are set
    to 0 before its card run and read after.  Returns ``{tool: (figures,
    launches, seconds)}`` and ``wall_s``."""
    import shutil
    import tempfile

    from video_stream_segmenetation_tpu_torch import bridge
    from video_stream_segmenetation_tpu_torch import diag_realistic_clips as DG
    from video_stream_segmenetation_tpu_torch import face_parity as FP
    from video_stream_segmenetation_tpu_torch import parity_check as PC
    from video_stream_segmenetation_tpu_torch import parity_matting as PM
    from video_stream_segmenetation_tpu_torch import tune_adaptive_ema as TA
    from video_stream_segmenetation_tpu_torch.runtime import config as cfg

    t_phase = time.perf_counter()
    counters = _counters()
    out = {}

    def run(name, fn):
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items() if c.launches}
        out[name] = (res, launches, time.perf_counter() - t0)
        return res, launches

    d = Path(tempfile.mkdtemp(prefix="vst_tools_"))
    try:
        # parity_check: the committed frames, the CPU's masks as the reference
        frames, gt = bridge.load_frames()
        idx = np.arange(TOOLS_FRAMES) % len(frames)
        clip = d / "clip.npz"
        np.savez(clip, frames=frames[idx], masks=gt[idx].astype(np.float32) / 255.0)
        cpu = PC.run(PC.parse_args(["--clip", str(clip), "--device", "cpu", "--save-masks",
                                    str(d / "cpu_masks.npz")]))
        card, launches = run("parity_check", lambda: PC.run(PC.parse_args(
            ["--clip", str(clip), "--ref", str(d / "cpu_masks.npz"), "--device", str(dev)])))
        out["parity_check_cpu_vs_truth"] = cpu
        if not (card["iou_min"] >= TOOL_FRAME_IOU and card["frames"] == TOOLS_FRAMES):
            raise AssertionError(f"parity_check on the card against its CPU masks: {card}")
        tool_launches("parity_check", launches, trunk=TOOLS_FRAMES, refine=TOOLS_FRAMES)
        cpu_s = PC.run(PC.parse_args(["--synthetic", "--frames", str(TOOLS_FRAMES),
                                      "--device", "cpu"]))
        card_s, launches = run("parity_check --synthetic", lambda: PC.run(PC.parse_args(
            ["--synthetic", "--frames", str(TOOLS_FRAMES), "--device", str(dev)])))
        out["parity_check_synthetic_cpu"] = cpu_s
        if not abs(card_s["iou_mean"] - cpu_s["iou_mean"]) <= TOOL_IOU_SLACK:
            raise AssertionError(f"parity_check --synthetic: card {card_s}, CPU {cpu_s}")
        tool_launches("parity_check --synthetic", launches, trunk=0, refine=TOOLS_FRAMES)

        # face_parity: the four sections on the card
        rep, launches = run("face_parity", lambda: FP.report(dev))
        fid = max(v["max_rel"] for outs in rep["port_fidelity"].values() for v in outs.values())
        dc, bn = rep["decode_consistency"], rep["blaze_nms"]
        if not (fid <= FIDELITY_REL and dc["best_anchor_agreement"] == 1.0
                and dc["box_iou_torch_vs_numpy_min"] >= DECODE_IOU
                and bn["selected_count_match"] and bn["max_abs_diff"] <= NMS_ABS):
            raise AssertionError(f"face_parity on the card: {rep}")
        # build_torch_fn and the face models run in PyTorch: no kernel of the port
        if launches:
            raise AssertionError(f"face_parity launched {launches}")

        # parity_matting: int8 against float at 720p; the report at --small
        photos = d / "photos"
        photos.mkdir()
        write_photos(photos, TOOLS_PHOTOS)
        i8f, launches = run("parity_matting int8_vs_float 720p", lambda: PM.int8_vs_float(
            photos, FRAME_HW, (288, 512), TOOLS_FRAMES, device=dev))
        if not i8f["iou_mean"] >= INT8_FLOAT_IOU:
            raise AssertionError(f"parity_matting int8 vs float at 720p: {i8f}")
        # the int8 engines a frame of the four clips, the float ones a frame
        n = 4 * TOOLS_FRAMES
        tool_launches("parity_matting int8_vs_float", launches, trunk=n, refine=2 * n)
        small = dict(small=True, n_frames=TOOLS_FRAMES, n_oracle=TOOLS_ORACLE_FRAMES)
        pm_cpu = PM.report(photos, device="cpu", **small)
        pm_card, launches = run("parity_matting --small", lambda: PM.report(photos, device=dev,
                                                                              **small))
        out["parity_matting_cpu"] = pm_cpu
        gaps = {k: abs(v["iou_mean"] - pm_cpu[k]["iou_mean"]) for k, v in pm_card.items()
                if isinstance(v, dict) and "iou_mean" in v}
        if not max(gaps.values()) <= TOOL_IOU_SLACK:
            raise AssertionError(f"parity_matting --small, card against CPU: {gaps}")
        # int8: the three clips and the face clip; float: the three clips, the
        # first again at ema_adapt 0, the three at ema 0, the face clip twice
        # (the model-only engines run no refine)
        tool_launches("parity_matting --small", launches, trunk=4 * TOOLS_FRAMES,
                      refine=13 * TOOLS_FRAMES)
        out["parity_matting_gaps"] = gaps

        # tune_adaptive_ema: two adapts at the moved gate and at the default
        argv = ["--photos", str(photos), "--frames", str(TOOLS_FRAMES), "--adapts", "0,1",
                "--device", str(dev)]
        moved, launches = run("tune_adaptive_ema", lambda: TA.main(
            argv + ["--t0", str(MOVED_GATE[0]), "--t1", str(MOVED_GATE[1])]))
        if (cfg.EMA_ADAPT_T0, cfg.EMA_ADAPT_T1) != (0.10, 0.40):
            raise AssertionError(f"tune_adaptive_ema: the gate {cfg.EMA_ADAPT_T0}, "
                                 f"{cfg.EMA_ADAPT_T1} after the sweep")
        # two adapts over the four clips, one int8 engine
        n = 2 * 4 * TOOLS_FRAMES
        tool_launches("tune_adaptive_ema", launches, trunk=n, refine=n)
        at_default = TA.main(argv)
        out["tune_default_gate"] = at_default
        a0 = [abs(moved["adapt=0.0"][k] - at_default["adapt=0.0"][k]) for k in ("iou_mean",
                                                                          "flicker")]
        a1 = [abs(moved["adapt=1.0"][k] - at_default["adapt=1.0"][k])
              for k in ("iou_mean", "temporal_stability", "flicker")]
        if not (max(a0) <= 1e-3 and max(a1) > 0):
            raise AssertionError(f"tune_adaptive_ema: adapt 0 moved by the gate {a0}, adapt 1 "
                                 f"not {a1}")

        # diag_realistic_clips
        diag, launches = run("diag_realistic_clips", lambda: DG.main(
            ["--photos", str(photos), "--frames", str(TOOLS_FRAMES), "--device", str(dev)]))
        vals = [v for r in diag.values() for v in r.values() if isinstance(v, float)]
        if not all(0.0 <= v <= 1.0 for v in vals):
            raise AssertionError(f"diag_realistic_clips: {diag}")
        # the float pipeline a frame of the four clips (the model-only engine runs none)
        tool_launches("diag_realistic_clips", launches, trunk=0, refine=4 * TOOLS_FRAMES)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    return out


def say_tools(tl: dict, smi: str) -> None:
    """One line a tool: its figures against their bars, its launches."""
    def fig(rep, keys=("iou_mean", "iou_min")):
        return ", ".join(f"{k} {rep[k]:.4f}" for k in keys)

    def tail(name):
        _, launches, s = tl[name]
        return f"; launches {launches}; {s:.1f} s; {smi}"

    card = tl["parity_check"][0]
    say(f"  parity_check (720p, the committed frames cycled to {TOOLS_FRAMES}, fast_int8_pico): "
        f"card against the CPU's masks {fig(card)} (every frame at least {TOOL_FRAME_IOU}); "
        f"the CPU against the ground truth {fig(tl['parity_check_cpu_vs_truth'])}"
        + tail("parity_check"))
    cs, cpu_s = tl["parity_check --synthetic"][0], tl["parity_check_synthetic_cpu"]
    say(f"  parity_check --synthetic (240x320, {TOOLS_FRAMES} frames, seeded active): card "
        f"{fig(cs)}, CPU {fig(cpu_s)} (the means within {TOOL_IOU_SLACK})"
        + tail("parity_check --synthetic"))
    rep = tl["face_parity"][0]
    fid = {f"{g}.{k}": f"{v['max_rel']:.2e}" for g, outs in rep["port_fidelity"].items()
           for k, v in outs.items()}
    say(f"  face_parity: port_fidelity max_rel {fid} (at most {FIDELITY_REL:g}); "
        f"decode_consistency {json.dumps(rep['decode_consistency'])} (anchors 1.0, least IoU "
        f"{DECODE_IOU}); blaze_nms {json.dumps(rep['blaze_nms'])} (count match, rows within "
        f"{NMS_ABS:g}); student_vs_reference {json.dumps(rep['student_vs_reference'])}"
        + tail("face_parity"))
    say(f"  parity_matting int8_vs_float_pipeline at 720p ({TOOLS_FRAMES} frames a clip, "
        f"{TOOLS_PHOTOS} written photos): {fig(tl['parity_matting int8_vs_float 720p'][0])} "
        f"(at least {INT8_FLOAT_IOU})" + tail("parity_matting int8_vs_float 720p"))
    pm, pm_cpu = tl["parity_matting --small"][0], tl["parity_matting_cpu"]
    fp = pm["engine_vs_oracle_face_path"]
    oracle = {k: pm[k]["iou_mean"] for k in ("engine_vs_reference_semantics_oracle",
                                             "engine_vs_oracle_face_path")}
    say(f"  parity_matting --small (240x320 / 96x128, {TOOLS_FRAMES} frames, "
        f"{TOOLS_ORACLE_FRAMES} oracle frames): card "
        + ", ".join(f"{k} {pm[k]['iou_mean']:.4f} (CPU {pm_cpu[k]['iou_mean']:.4f})"
                    for k in tl["parity_matting_gaps"])
        + f" (each within {TOOL_IOU_SLACK} of the CPU's); the oracle sections against the "
        f"prediction {ORACLE_PREDICTION}: "
        + ", ".join(f"{k} {'met' if v >= ORACLE_PREDICTION else 'missed'}"
                    for k, v in oracle.items())
        + f"; the face clip: prior fired on {fp['prior_fired_frames']} frames, affine applied "
        f"on {fp['affine_applied_frames']}" + tail("parity_matting --small"))
    moved, dflt = tl["tune_adaptive_ema"][0], tl["tune_default_gate"]
    say(f"  tune_adaptive_ema (720p, {TOOLS_FRAMES} frames a clip): at the gate {MOVED_GATE} "
        + "; ".join(f"{k} iou {v['iou_mean']:.4f} stab {v['temporal_stability']:.4f} flicker "
                    f"{v['flicker']:.5f}" for k, v in moved.items())
        + "; at the default gate "
        + "; ".join(f"{k} iou {v['iou_mean']:.4f} stab {v['temporal_stability']:.4f} flicker "
                    f"{v['flicker']:.5f}" for k, v in dflt.items())
        + " (adapt 0 the same at both gates, adapt 1 not)" + tail("tune_adaptive_ema"))
    diag = tl["diag_realistic_clips"][0]
    say(f"  diag_realistic_clips (720p, {TOOLS_FRAMES} frames a clip): "
        + "; ".join(f"{k} {json.dumps(v)}" for k, v in diag.items())
        + tail("diag_realistic_clips"))
    say(f"  tools: the phase {tl['wall_s']:.1f} s")


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
    steps = 19 + len(PHASES)
    say(f"[1/{steps} device] {name}, device_count={count}, nvidia-smi: {smi}, "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    info = _build.build()
    say(f"[2/{steps} build] {'built' if info['built'] else 'found'} {info['path']} in "
        f"{info['seconds']:.1f} s (nvcc {info['nvcc']}); kernels: "
        + "; ".join(f"{k}: {v['registers']} regs, {v['smem']} B smem, "
                    f"{v['spill_stores']}/{v['spill_loads']} B spill st/ld"
                    for k, v in info["kernels"].items()))

    say(f"[3/{steps} kernels] vs plain versions at S={S}, 720p")
    kernels = [*check_trunk(dev), check_alpha_head(dev), check_se(dev), check_refine(dev),
               check_decoder(dev), check_conv(dev), check_u1_trunk(dev),
               *check_composite(dev), check_refine_plane(dev), check_fused_refine(dev),
               check_refine_fast(dev), check_stochastic_round(dev)]
    say("  the refine kernel's debug variants (bench-only: 'no_morph' skips stages 5 and 7, "
        "'no_bilateral' stage 8) vs their plain versions with the same tokens:")
    debug_errs = check_refine_debug(dev)
    say(f"  the refine kernel's forms at a moved EMA gate (runtime/config.py's "
        f"EMA_ADAPT_T0/T1 = {MOVED_GATE}, the default (0.1, 0.4)) vs their plain versions "
        "at the same gate:")
    gate_errs = check_refine_gate(dev)
    for k in kernels:
        k["max_abs_err"] = max(k["max_abs_err"], debug_errs.get(k["name"], 0.0),
                               gate_errs.get(k["name"], 0.0))
    torch.cuda.empty_cache()

    for k in kernels:
        k["launches"] = 0
    by_name = {k["name"]: k for k in kernels}
    phase_iou = {}
    for i, (label, preset_name, overrides, trained, per_step, min_iou,
            trunk_entry) in enumerate(PHASES):
        say(f"[{4 + i}/{steps} serve] Engine({S}, {label}), {SERVE_STEPS} steps, "
            + {True: "trained weights, committed frames",
               "seeded": "the seed-0 matting tree, trained face models, committed frames",
               False: "seeded weights"}[trained])
        res = serve("cuda", S, SERVE_STEPS, preset_name, overrides, trained, min_iou)
        if "fused_refine" in res:
            fr = res.pop("fused_refine")
            shape = fr.pop("shape")
            if fr["name"] not in by_name:
                fr["launches"] = 0
                kernels.append(fr)
                by_name[fr["name"]] = fr
            say(f"  fused_refine on the s2d exact-warp route, the last step's inputs "
                f"{shape}: max_abs_err {fr['max_abs_err']:.3e} (tolerance "
                f"{REFINED_F32_TOL:g}), {fr['ms']:.3f} ms, plain {fr['plain_ms']:.3f} ms, "
                f"bound {fr['bound_ms']:.4f} ms ({fr['bound_by']})")
        entries = trunk_entry if isinstance(trunk_entry, dict) else {"trunk_int8": trunk_entry}
        for counter, n in res["launches"].items():
            want = per_step.get(counter, 0) * SERVE_STEPS
            if n != want:
                raise AssertionError(f"{label}: {counter} launched {n} times in "
                                     f"{SERVE_STEPS} steps, expected {want}")
        add_launches(by_name, res["launches"], entries)
        med = statistics.median(res["times_ms"])
        iou_name = "foreground IoU" if "simplex_err" in res else "alpha IoU"
        quality = (f"{iou_name} vs ground truth {res['iou']:.4f}"
                   + (f" (least allowed {min_iou:.4f})" if min_iou is not None else "")
                   + (f", class_alpha sums to 1 within {res['simplex_err']:.2e}"
                      if "simplex_err" in res else "")
                   + (f", map means {[round(v, 4) for v in res['class_means']]} "
                      f"(the reference's {res['ref_means']}, tolerance "
                      f"{CLASS_MEAN_TOL:g})" if "class_means" in res else "")
                   + f", face_applied on "
                   f"{res['applied']} streams, the prior on {res['prior']}, mean det_score "
                   f"{res['det_score']:.4f}"
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
    add_launches(by_name, res["launches"])
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
        add_launches(by_name, res["launches"])
    say(f"  routes: prev_alpha max_abs_err {rb['prev_err']:.3e} (tolerance "
        f"{ROUTE_PREV_TOL:g}), refined alpha {rb['alpha_err']:.3e} (tolerance "
        f"{ROUTE_ALPHA_TOL:g}), IoU {rb['a']['iou']:.4f} vs {rb['b']['iou']:.4f} (tolerance "
        f"{ROUTE_IOU_TOL:g}); median round {statistics.median(rb['a']['latencies_ms']):.2f} "
        f"ms fused (dispatch to collect), {statistics.median(rb['b']['periods_ms']):.2f} ms "
        f"pipelined (three ticks)")
    hold(by_name, "routes", rb["held"])
    del rb
    torch.cuda.empty_cache()

    say(f"[{k + 8}/{steps} refface round] StreamScheduler(Engine({S}, fast_int8_pico_refface), "
        "group_sizes=[24, 24, 16], fused_rounds=True), face_min_interval_s=0: 2 rounds and one "
        f"under set_sync_debug_mode('error'); the face models' forwards on K={FACE_K} streams")
    rr = phase_refface_round("cuda")
    add_launches(by_name, rr["launches"])
    say(f"  refface round: launches {rr['launches']}; median round "
        f"{statistics.median(rr['latencies_ms']):.2f} ms dispatch to collect; the checked "
        f"round made no host synchronisation: "
        + ", ".join(f"{key} {v:.1f} ms" for key, v in rr["parts_ms"].items())
        + f"; alpha IoU {rr['iou']:.4f}; peak device memory {rr['peak_mib']:.0f} MiB; {smi}")
    say(f"  face models on K={FACE_K} streams (CUDA events, mean of 10, pinned precision): "
        + ", ".join(f"{key} {v:.3f} ms" for key, v in rr["times_ms"].items())
        + "; MediaPipe graphs on the card vs the CPU (max abs, tolerance rtol "
        f"{FACE_GRAPH_RTOL:g} atol {FACE_GRAPH_ATOL:g}): "
        + ", ".join(f"{key} {v:.2e}" for key, v in rr["graph_err"].items()))
    del rr
    torch.cuda.empty_cache()

    say(f"[{k + 9}/{steps} mesh] Engine({S}, fast_int8_pico, mesh=make_mesh({MESH_N}, "
        f"devices=[cuda:0] * {MESH_N})) against Engine({S}), trained weights, committed "
        f"frames, face_min_interval_s=0: {MESH_STEPS} steps (process, then "
        f"dispatch/collect); StreamScheduler(group_sizes={list(MESH_SIZES)}, fused_rounds="
        f"True) over both, {MESH_ROUNDS} rounds and one more mesh round under "
        f"set_sync_debug_mode('error'); fit(mesh=...) of the pico at "
        f"{MESH_FIT['hw'][0]}x{MESH_FIT['hw'][1]} batch {MESH_FIT['batch']} f32, "
        f"{MESH_FIT['steps']} steps, against one device; graft_entry.dryrun_multichip("
        f"{MESH_N})")
    ms = phase_mesh("cuda")
    add_launches(by_name, ms["launches"])
    say_mesh(ms, smi, count)
    del ms
    torch.cuda.empty_cache()

    say(f"[{k + 10}/{steps} rollout] the step rollout on Engine({S}, fast_int8_pico) and the "
        f"round rollout on the production rotation ({list(ROTATION)}, {FAST_ROUTE}), trained "
        "weights, committed frames")
    ro = phase_rollout("cuda")
    add_launches(by_name, ro["launches"])
    sp, rp = ro["step_parity"], ro["round_parity"]
    say(f"  rollout: a chain of {ROLL_PARITY_N} steps vs {ROLL_PARITY_N} sequential make_step "
        f"calls on the same tagged frames: state, frame buffer and alpha buffer max_abs_err "
        f"{sp['state']:.3e} / {sp['frame']:.3e} / {sp['alpha']:.3e} (tolerance 0); a chain "
        f"of {ROUND_N2} rounds under set_sync_debug_mode('error') vs {ROUND_N2} sequential "
        f"round steps: state, face clock, frame and alpha buffers {rp['state']:.3e} / "
        f"{rp['face_last']:.3e} / {rp['frame']:.3e} / {rp['alpha']:.3e} (tolerance 0); "
        f"launches {ro['launches']}")
    for acc, r in ro["step_slopes"].items():
        say(f"  step rollout slope ({acc}, xor; n {ROLL_N1} -> {ROLL_N2}, median of "
            f"{ROLL_REPS} paired reps): host clock {r['host_ms']['slope']:.3f} ms a step "
            f"(fixed {r['host_ms']['fixed']:.2f} ms; reps "
            f"{[round(v, 3) for v in r['host_ms']['slopes']]}), CUDA events "
            f"{r['event_ms']['slope']:.3f} ms a step (fixed {r['event_ms']['fixed']:.2f} ms; "
            f"reps {[round(v, 3) for v in r['event_ms']['slopes']]}); {smi}")
    r = ro["round_slopes"]
    say(f"  round rollout slope ({sum(ROTATION)} streams in {list(ROTATION)}, buffer, xor; "
        f"n {ROUND_N1} -> {ROUND_N2}, median of {ROUND_REPS} paired reps): host clock "
        f"{r['host_ms']['slope']:.3f} ms a round (fixed {r['host_ms']['fixed']:.2f} ms; reps "
        f"{[round(v, 3) for v in r['host_ms']['slopes']]}), CUDA events "
        f"{r['event_ms']['slope']:.3f} ms a round (reps "
        f"{[round(v, 3) for v in r['event_ms']['slopes']]}); {smi}")
    say(f"  Engine.process at S={S}, host clock synchronized, median of {SERVE_STEPS}: "
        f"{statistics.median(ro['process_ms']):.2f} ms "
        f"({[round(t, 1) for t in ro['process_ms']]}); the rollout's slope leaves out the "
        f"frames' copy to the card and the per-call costs")
    del ro
    torch.cuda.empty_cache()

    say(f"[{k + 11}/{steps} snapshot] Engine({S}, fast_int8_pico) saved after 3 steps "
        f"(utils/checkpoint.py::save_engine), restored into a fresh engine, both stepped "
        f"{SNAPSHOT_STEPS} times")
    sn = phase_snapshot("cuda")
    add_launches(by_name, sn["launches"])
    say(f"  snapshot: {sn['bytes'] / 2**20:.1f} MiB on disk; the restored engine's state and "
        f"its next {SNAPSHOT_STEPS} steps' frame, alpha, det_score and face_applied equal the "
        f"uninterrupted "
        f"engine's bit for bit (face applied on {sn['applied']} streams at the last step); "
        f"launches {sn['launches']}")
    torch.cuda.empty_cache()

    say(f"[{k + 12}/{steps} train] the pico MatteNetHD (c0 128, c2 128, c3 192) on "
        f"the card: fit {TRAIN_STEPS} steps at 240x320 batch 32 lr 5e-4, then {FT_STEPS} at "
        "720x1280 batch 8 lr 5e-4/3 seed 1; one step against the CPU; the trained tree "
        "stochastically rounded, quantized and served one step of Engine(8, fast_int8_pico, "
        "face_path=False)")
    counters = _counters()
    tr = phase_train(dev, counters)
    add_launches(by_name, tr["launches"])
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

    say(f"[{k + 13}/{steps} train_zoo] every trainer of train/ on the card at its full widths "
        f"and the reference's geometry and batch ({ZOO_FACE_STEPS} steps for the face models, "
        f"{ZOO_STEPS} for the others, then {ZOO_FT_STEPS} of fine-tuning where the reference "
        f"fine-tunes); one step against the CPU (batch {ZOO_CPU_BATCH}); each trained tree "
        f"served {ZOO_SERVE_STEPS} steps of Engine({ZOO_SERVE_S}, its preset) on the committed "
        f"frames; an articulated clip of {CLIP_FRAMES} frames at 720p on the card vs the CPU")
    zoo = phase_train_zoo(dev)
    for job in zoo["jobs"]:
        for label, r in job["runs"]:
            say(f"  train_zoo {job['label']}{' ' + label if label else ''}: median step "
                f"{statistics.median(r['ms'][1:]):.2f} ms (CUDA events between steps' ends, "
                f"median of {len(r['ms']) - 1}), {r['wall_s']:.1f} s, peak device memory "
                f"{r['peak_mib']:.0f} MiB; losses {[round(float(v), 4) for v in r['loss']]}; "
                f"{smi}")
        h = job["held"]
        say(f"  train_zoo {job['label']}: {job['leaves']} leaves, every one the loss reads "
            f"moved ({job['stats']} BatchNorm statistics; unread {h['unread']}); card vs CPU "
            f"step: f32 loss relative {h['f32']['loss_rel']:.2e} "
            f"(tolerance {STEP_F32_LOSS_TOL:g}), largest gradient relative L2 "
            f"{h['f32']['max_rel_l2']:.2e} (tolerance {STEP_F32_GRAD_TOL:g}); bf16 loss relative "
            f"{h['bf16']['loss_rel']:.2e} (tolerance {STEP_BF16_LOSS_TOL:g}), least gradient "
            f"cosine {h['bf16']['min_cos']:.5f} (least bar {h['bf16']['min_bar']:.5f}, margin "
            f"{h['bf16']['least_margin']:.5f}), the whole gradient's {h['bf16']['tree_cos']:.5f} "
            f"(at least {STEP_BF16_COS}); {h['s']:.1f} s")
    for preset_name, res in zoo["serves"]:
        say(f"  train_zoo serve {preset_name}, this run's trees: median step "
            f"{statistics.median(res['times_ms']):.2f} ms, launches {res['launches']}, IoU vs "
            f"ground truth {res['iou']:.4f}"
            + (f", class_alpha sums to 1 within {res['simplex_err']:.2e}"
               if "simplex_err" in res else "")
            + (f", trunk vs plain on 2 streams {res['trunk_err']:.3e} (tolerance {TRUNK_TOL:g})"
               if "trunk_err" in res else "")
            + f", face applied on {res['applied']} streams, mean det_score "
            f"{res['det_score']:.4f}, passthrough steps {res['passthrough']}; {res['s']:.1f} s")
        trunk = "trunk_int8_k4_pico" if preset_name == "multiclass_fast_pico" else "trunk_int8"
        add_launches(by_name, res["launches"], {"trunk_int8": trunk})
        if "trunk_err" in res:
            by_name[trunk]["max_abs_err"] = max(by_name[trunk]["max_abs_err"], res["trunk_err"])
    c = zoo["clip"]
    say(f"  train_zoo articulated_clip({CLIP_FRAMES}, 720p, features=True): card vs CPU from "
        f"the same draws, u8 frames within {c['u8_err']} (tolerance {CLIP_U8_TOL}), alpha "
        f"{c['alpha_err']:.2e} (tolerance {CLIP_ALPHA_TOL:g}), head_box {c['box_err']:.2e} px; "
        f"{c['card_s']:.2f} s on the card; the phase {zoo['wall_s']:.1f} s")
    del zoo
    torch.cuda.empty_cache()

    say(f"[{k + 14}/{steps} realbg] the photo-background trainers of train/realbg.py on the "
        f"card at their widths, geometry and batch, {REALBG_STEPS} steps a phase, on "
        f"{REALBG_PHOTOS} photographs written at {REALBG_PHOTO_HW[1]}x{REALBG_PHOTO_HW[0]}; "
        f"one step each against the CPU (batch {REALBG_CPU_BATCH}); fit over make_mesh("
        f"{MESH_N}, devices=[cuda:0] * {MESH_N}) with make_pipeline_loss and the U2 loss; the "
        f"synthetic gate ({REALBG_GATE_FRAMES} frames a clip) on the committed pico and this "
        f"run's flagship candidate, the realistic gate on the committed pico")
    rb = phase_realbg(dev)

    def names(leaves):
        return f"{len(leaves)} leaves {leaves[:4]}{'...' if len(leaves) > 4 else ''}"

    for job in rb["jobs"]:
        r, h = job["run"], job["held"]
        say(f"  {job['label']}: median step {statistics.median(r['ms'][1:]):.2f} ms (CUDA "
            f"events between steps' ends, median of {len(r['ms']) - 1}; first phase's first "
            f"step left out), {r['wall_s']:.1f} s with its evaluations, peak device memory "
            f"{r['peak_mib']:.0f} MiB; losses {[round(float(v), 4) for v in r['loss']]}; "
            f"grad_norm {[round(float(v), 3) for v in r['grad_norm']]}; {smi}")
        say(f"  {job['label']}: {job['leaves']} leaves, every one the loss reads moved "
            f"({names(h['unread'])} unread; {names(h['unread_bf16'])} with a zero gradient in "
            f"bf16); card vs "
            f"CPU step: f32 loss relative "
            f"{h['f32']['loss_rel']:.2e} (tolerance {STEP_F32_LOSS_TOL:g}), least leaf "
            f"gradient cosine 1 - {1 - h['f32']['min_cos']:.2e} (at least "
            f"{REALBG_F32_LEAF_COS}), largest relative L2 {h['f32']['max_rel_l2']:.2e} (phase "
            f"51's {STEP_F32_GRAD_TOL:g}, not held); bf16 loss relative "
            f"{h['bf16']['loss_rel']:.2e} (tolerance {STEP_BF16_LOSS_TOL:g}), the whole "
            f"gradient's cosine {h['bf16']['tree_cos']:.5f} (at least {STEP_BF16_COS}), least "
            f"leaf cosine {h['bf16']['min_cos']:.5f} (phase 51's least bar "
            f"{h['bf16']['min_bar']:.5f}, margin {h['bf16']['least_margin']:.5f}, not held); "
            f"{h['s']:.1f} s; report {json.dumps(job['report'])}")
    for loss, gap in rb["gaps"].items():
        say(f"  realbg mesh, {loss} loss, batch {REALBG_MESH_FIT['batch']} at "
            f"{REALBG_MESH_FIT['hw'][0]}x{REALBG_MESH_FIT['hw'][1]} f32: one step's loss "
            f"relative {gap['loss_rel']:.2e} (tolerance {REALBG_MESH_LOSS_RTOL:g}), summed "
            f"gradients' least leaf cosine 1 - {1 - gap['min_cos']:.2e} at {gap['leaf']} (at "
            f"least 1 - {1 - MESH_GRAD_COS:.0e})")
    say(f"  realbg mesh fit(mesh, loss_fn=make_pipeline_loss(model)), pico f32: losses "
        f"{[round(v, 6) for v in rb['fit_losses']]}, relative to one device's "
        f"{[f'{v:.2e}' for v in rb['fit_rel']]} (tolerance {MESH_LOSS_RTOL:g}); "
        f"{rb['fit_mesh_s']:.1f} s on the mesh, {rb['fit_one_s']:.1f} s on one device")
    for label, launches, res in rb["gates"]:
        add_launches(by_name, launches)
        by_name["trunk_int8"]["max_abs_err"] = max(by_name["trunk_int8"]["max_abs_err"],
                                                   res["trunk_err"])
        say(f"  realbg gate {label}: " + json.dumps({k: v for k, v in res.items()
                                                     if k not in ("s", "trunk_err")})
            + f"; launches {launches}; trunk vs plain {res['trunk_err']:.3e} (tolerance "
            f"{TRUNK_TOL:g}); {res['s']:.1f} s"
            + (f" (the reference's record {REFERENCE_GATE}, slack {IOU_SLACK}, flicker "
               f"{GATE_FLICKER_TOL})" if label.endswith("committed pico")
               and label.startswith("synthetic") else ""))
    say(f"  realbg: the phase {rb['wall_s']:.1f} s (the photos written in "
        f"{rb['photos_s']:.1f} s, the jobs "
        f"{sum(j['run']['wall_s'] + j['held']['s'] for j in rb['jobs']):.1f} s with their CPU "
        f"steps, the mesh {rb['mesh_s']:.1f} s, the gates "
        f"{sum(res['s'] for _, _, res in rb['gates']):.1f} s)")
    del rb
    torch.cuda.empty_cache()

    say(f"[{k + 15}/{steps} tools] the parity and tuning tools on the card: parity_check, "
        f"face_parity, parity_matting, tune_adaptive_ema, diag_realistic_clips "
        f"({TOOLS_FRAMES} frames a clip, {TOOLS_PHOTOS} photographs written at "
        f"{REALBG_PHOTO_HW[1]}x{REALBG_PHOTO_HW[0]}), against their CPU runs")
    tl = phase_tools(dev)
    for tool in ("parity_check", "parity_check --synthetic", "face_parity",
                 "parity_matting int8_vs_float 720p", "parity_matting --small",
                 "tune_adaptive_ema", "diag_realistic_clips"):
        add_launches(by_name, tl[tool][1])
    say_tools(tl, smi)
    del tl
    torch.cuda.empty_cache()
    say("  the trunk's head and SE entry-point calls on the main path (its trunk calls times "
        "TRUNK_PARTS): " + ", ".join(f"{part} {by_name[part]['launches']}"
                                     for part in _part_counters()))
    idle = [k["name"] for k in kernels if not k["launches"]]
    if idle:
        raise AssertionError(f"launched no time on the main path: {idle}")
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms")
    say(json.dumps({"kernels": [{key: k[key] for key in order} for k in kernels]}))
    say(smi)
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # skip interpreter teardown: nothing may print or crash after the last line
    os._exit(rc)
