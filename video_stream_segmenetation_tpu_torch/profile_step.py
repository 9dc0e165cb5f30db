"""Where the serving step's time goes on the card.

    python3 -m video_stream_segmenetation_tpu_torch.profile_step [--streams 64]
        [--config pico_noface|pico|micro|mc_pico|mc|full|lite|active|fast|multiclass|
                  nano|femto|blaze|branch|rvm|u2|train ...]

For each configuration (default: all sixteen) it builds Engine(S, preset):
``pico_noface`` is fast_int8_pico with the face path off and seeded
weights, ``pico``, ``micro``, ``mc_pico``, ``mc``, ``full``, ``lite``,
``active``, ``fast``, ``multiclass``, ``nano``, ``femto``, ``blaze``,
``branch``, ``rvm`` and ``u2`` are fast_int8_pico, fast_int8_micro,
multiclass_fast_pico, multiclass_fast, fast_int8, fast_int8_lite, active,
fast, multiclass, fast_int8_nano, fast_int8_femto, blaze_tracking, branch,
rvm and u2 as their presets stand
with the committed trained weights and frames (branch with its even
streams' affine primed, as chip_smoke.py's phase).  It warms the engine
up, then
  * times each stage of the step with CUDA events, calling the step's own
    functions on the engine's tensors (frames host->device, s2d pack, stem,
    the trunk -- for micro its convolutions and its decoder levels plus
    head apart; the kernels of micro's decoder and of the pico/nano, full
    and light trunks one by one by torch.profiler --,
    upsample, guide, face subpath, refine kernel, packed composite,
    unpack; for the multi-class presets: the K=4 trunk, the per-class
    upsample and softmax, the simplex EMA, the per-class composite and its
    blurred guide; for active: the f32 conversion and gather resize, the
    float MatteNet, the guide, the face subpath on the frames, the refine
    kernel, the plain composite, and the composite kernel beside it; for
    fast: the plan-A MatteNetHD on the frames, the nearest u8 guide, then
    as active; for multiclass: the per-channel resize, the K=4 MatteNet,
    the simplex EMA, the per-class composite and its blur apart; for
    the natural layout's other pipelines: their model (MatteNet, the
    RecurrentMatteNet on the engine's state, the SaliencyNet), the
    translation subpath (blaze_tracking), and on the unfused chain the
    warp and blend, the temporal filter, the bilateral and the
    threshold/gamma refine apart), and
  * profiles whole ``Engine.process`` calls with torch.profiler: device time
    by kernel, copies apart from kernels, and the share of the wall time in
    which no kernel runs.
``train`` (not in the default set) does the same for a training step of
the pico MatteNetHD at the train phase's two geometries (profile_train).
Needs a card; prints the card's name and power limit beside the numbers.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

CONFIGS = {
    "pico_noface": ("fast_int8_pico", {"face_path": False}, False),
    "pico": ("fast_int8_pico", {}, True),
    "micro": ("fast_int8_micro", {}, True),
    "mc_pico": ("multiclass_fast_pico", {}, True),
    "mc": ("multiclass_fast", {}, True),
    "full": ("fast_int8", {}, True),
    "lite": ("fast_int8_lite", {}, True),
    "active": ("active", {}, True),
    "fast": ("fast", {}, True),
    "multiclass": ("multiclass", {}, True),
    "nano": ("fast_int8_nano", {}, True),
    "femto": ("fast_int8_femto", {}, True),
    "blaze": ("blaze_tracking", {}, True),
    "branch": ("branch", {}, True),
    "rvm": ("rvm", {}, True),
    "u2": ("u2", {}, True),
}
# branch: the even streams start with this affine (chip_smoke.py's
# PRIMED_AFFINE), so that its max blend runs
PRIMED_AFFINE = (1.0, 0.0, 2.0, 0.0, 1.0, -2.0)
# a stage timed apart that another stage's time already holds, and one
# that the configuration could run instead of another (neither is summed)
INSIDE = "  (inside the composite) "
INSTEAD = "  (instead of the plain composite) "


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


def _kernel_ms(fn):
    """(kernel name, device ms) of each kernel one call of ``fn`` launches,
    in launch order (torch.profiler)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return [(e.name, e.time_range.elapsed_us() / 1e3)
            for e in sorted(evs, key=lambda e: e.time_range.start)]


def _trunk_stages(model, x0, stages):
    """Time the served trunk.  Micro's is timed as the two functions
    ``micro_trunk_alpha`` runs (its convolutions, then its decoder levels
    and head), and the second's kernels are listed one by one; so are the
    pico/nano (its 11 launches), full and light trunks' kernels.  Returns
    (logits, that list)."""
    from video_stream_segmenetation_tpu_torch.kernels import trunk_int8 as TK

    if model.decoder in ("full", "light"):
        label = {"full": "full trunk (plan B): convs, SEs, split 3x3 decoder, head",
                 "light": "light trunk (plan C): convs, SEs, decoder levels, head"}
        stages[label[model.decoder]], logits = _event_ms(lambda: model.trunk_logits(x0))
        return logits, _kernel_ms(lambda: model.trunk_logits(x0))
    if model.decoder != "micro":
        head = f", K={model.num_classes} head" if model.num_classes > 1 else ""
        stages[f"{model.decoder} trunk kernel (11 launches{head})"], logits = _event_ms(
            lambda: model.trunk_logits(x0))
        return logits, _kernel_ms(lambda: model.trunk_logits(x0))
    tp = model.trunk
    stages["micro_encoder: d2dn, d2b block, d3dn, d3b block, ctx, SE"], (d2, ctx) = \
        _event_ms(lambda: TK.micro_encoder(x0, tp))

    def decoder():
        return TK.micro_decoder(x0, d2, ctx, tp)

    stages["micro_decoder: u2 and u1 decoder_int8 levels, alpha head"], logits = \
        _event_ms(decoder)
    return logits, _kernel_ms(decoder)


def profile(config: str, s: int, steps: int, smi: str) -> None:
    from video_stream_segmenetation_tpu_torch import bridge
    from video_stream_segmenetation_tpu_torch.runtime.precision import pinned
    from video_stream_segmenetation_tpu_torch.runtime.presets import preset
    from video_stream_segmenetation_tpu_torch.service.engine import Engine

    name, overrides, trained = CONFIGS[config]
    st = preset(name, **overrides)
    fh, fw = st.frame_hw
    if trained:
        eng = Engine(s, st, **bridge.trained_weights(st))
        clip, _ = bridge.load_frames()
        frames = np.ascontiguousarray(clip[np.arange(s) % 2])
    else:
        eng = Engine(s, st, seed=0)
        frames = np.random.default_rng(0).integers(0, 256, (s, fh, fw, 3), dtype=np.uint8)
    eng.admit_all()
    if name == "branch":
        even = torch.as_tensor(np.arange(s) % 2 == 0, device=eng.device)
        eng.state.affine[even] = torch.tensor(PRIMED_AFFINE, device=eng.device)
        eng.state.has_affine[even] = True
    for _ in range(2):
        eng.process(frames)

    dev = eng.device
    out_dtype = torch.bfloat16 if st.refined_dtype == "bf16" else torch.float32
    stages = {}
    trunk_kernels = []
    with pinned():  # as the engine's step runs
        stages["frames host->device"], ft = _event_ms(
            lambda: torch.as_tensor(frames, device=dev))
        if st.frame_layout == "natural" and st.num_classes > 1:
            _natural_multiclass_stages(eng, ft, stages)
        elif st.frame_layout == "natural":
            _natural_stages(eng, ft, stages)
        else:
            trunk_kernels = _packed_stages(eng, ft, stages, out_dtype)
    total = sum(v for k, v in stages.items() if not k.startswith((INSIDE, INSTEAD)))
    print(f"[{config}] {name} {overrides or ''} stage times, S={s}, CUDA events, "
          f"mean of 5 ({smi}):", flush=True)
    for k, v in stages.items():
        print(f"  {k:56s} {v:8.3f} ms  {100 * v / total:5.1f} %")
    print(f"  {'sum':56s} {total:8.3f} ms")
    what = "micro_decoder" if getattr(eng.model, "decoder", None) == "micro" else "trunk"
    for i, (kernel, ms) in enumerate(trunk_kernels):
        print(f"    {what} launch {i + 1}: {kernel[:40]:40s} {ms:8.3f} ms "
              "(torch.profiler, one call)")
    _profile_steps(lambda: eng.process(frames), steps, config)
    del eng
    torch.cuda.empty_cache()


def _packed_stages(eng, ft, stages, out_dtype):
    """The s2d configurations' step: pack, stem, trunk, then the
    multi-class or the single-class tail.  Returns the trunk's kernels."""
    from video_stream_segmenetation_tpu_torch.ops.layout import space_to_depth

    st = eng.statics
    blk = st.s2d_block
    stages["s2d pack"], fp = _event_ms(lambda: space_to_depth(ft, blk).contiguous())
    stages["stem (bf16 patch matmul, requant)"], x0 = _event_ms(lambda: eng.model.stem(fp))
    logits, trunk_kernels = _trunk_stages(eng.model, x0, stages)
    if st.num_classes > 1:
        _multiclass_stages(eng, logits, fp, stages)
    else:
        _refine_stages(eng, logits, fp, stages, out_dtype)
    return trunk_kernels


def _natural_stages(eng, ft, stages):
    """The natural layout's step after the frames' copy: f32 and the
    gather resize, the model (MatteNet, the RecurrentMatteNet on the
    engine's state, the SaliencyNet), the guide, the face subpath on the
    frames (landmarks, or blaze_tracking's translation subpath), then the
    refine kernel (and active's composite kernel beside the plain
    composite, which use_fused_composite=True would run instead) or, on
    the unfused chain, its stages apart, and the plain composite."""
    from video_stream_segmenetation_tpu_torch.ops.resize import resize_frames_u8, resize_nearest

    st = eng.statics
    s = ft.shape[0]
    mh, mw = st.mask_hw
    dev = eng.device
    if st.matting_input == "native":  # fast: plan A on the u8 frames, the nearest guide
        stages[f"MatteNetHD plan A (bf16, {st.s2d_block}x{st.s2d_block} stem on the frames)"], \
            out = _event_ms(lambda: eng.model(ft))
        stages["guide: nearest u8 taps, planar"], guide = _event_ms(
            lambda: resize_nearest(ft, (mh, mw), "half_pixel").permute(0, 3, 1, 2).contiguous())
        _face_refine_composite(eng, ft, out["alpha"].to(torch.float32).contiguous(), guide,
                               stages)
        return
    stages["f32 + asymmetric gather resize to the mask"], small = _event_ms(
        lambda: resize_frames_u8(ft, (mh, mw), "asymmetric"))
    if st.matting_arch == "recurrent":
        stages["RecurrentMatteNet (bf16; ConvGRU state)"], out = _event_ms(
            lambda: eng.model(small, eng.state.rec))
    else:
        label = {"saliency": f"SaliencyNet (bf16, {mh}x{mw})"}.get(st.matting_arch,
                                                                  "MatteNet (bf16)")
        stages[label], out = _event_ms(lambda: eng.model(small))
    alpha = out["alpha"].to(torch.float32).contiguous()
    stages["guide floor(small*255+0.5), planar u8"], guide = _event_ms(
        lambda: torch.floor(small * 255.0 + 0.5).to(torch.uint8).permute(0, 3, 1, 2)
        .contiguous())
    _face_refine_composite(eng, ft, alpha, guide, stages)


def _face_refine_composite(eng, ft, alpha, guide, stages):
    """The natural single-class step after the model and the guide."""
    from video_stream_segmenetation_tpu_torch.kernels.composite_fused import fused_composite
    from video_stream_segmenetation_tpu_torch.kernels.refine_fused import fused_temporal_refine
    from video_stream_segmenetation_tpu_torch.ops.composite import natural_composite
    from video_stream_segmenetation_tpu_torch.runtime import pipeline as P

    st = eng.statics
    s = ft.shape[0]
    mh, mw = st.mask_hw
    dev = eng.device
    gate = torch.ones((s,), dtype=torch.bool, device=dev)
    fidx = torch.zeros((s,), dtype=torch.int32, device=dev)
    route = P.refine_routing(st)
    prior = torch.zeros((s, 4) if route["analytic_prior"] else (s, mh, mw), device=dev)
    has_prior = torch.zeros((s,), dtype=torch.bool, device=dev)
    if st.face_path and st.face_tracking == "translation":
        stages[f"translation subpath ({st.fd_size} resize of all {s} frames, detector)"], _ = \
            _event_ms(lambda: P.face_translation_subpath(eng.face_models.face, ft, eng.state,
                                                         st, gate))
    elif st.face_path:
        stages[f"face subpath on the frames (K={-(-s // st.lmk_interval)} of {s} streams)"], \
            face = _event_ms(lambda: P.face_subpath_compact(
                eng.face_models, ft, fidx, gate, st,
                "params" if route["analytic_prior"] else "plane"))
        prior, has_prior = face[0].contiguous(), face[1]
    if route["use_fused_tr"]:
        stages["refine kernel (+index prep)"], (_, a) = _event_ms(lambda: fused_temporal_refine(
            alpha, eng.state.prev_alpha, eng.state.affine, eng.state.has_affine,
            eng.state.initialized, st.warp_blend_weight, guide, prior, has_prior, eng.knobs,
            out_dtype=torch.float32))
    else:
        a = _chain_stages(eng, alpha, guide, prior, has_prior, stages)
    bg = (torch.tensor(st.bg_color, device=dev) if st.background == "color"
          else eng.backgrounds)
    stages["plain composite (bf16-pass upsample, f32 blend)"], _ = _event_ms(
        lambda: natural_composite(ft, a, bg))
    if st.background == "image":
        stages[f"{INSTEAD}composite kernel"], _ = _event_ms(
            lambda: fused_composite(ft, a, eng.backgrounds))


def _natural_multiclass_stages(eng, ft, stages):
    """The natural multi-class step after the frames' copy: f32 and the
    per-channel resize, the K-class MatteNet, the simplex EMA and renorm,
    the per-class composite at 720p, and its blurred frames apart."""
    from video_stream_segmenetation_tpu_torch.ops.blur import gaussian_blur_auto
    from video_stream_segmenetation_tpu_torch.ops.composite import multiclass_composite
    from video_stream_segmenetation_tpu_torch.runtime import pipeline as P

    st = eng.statics
    stages["f32 + per-channel f32 resize to the mask (products)"], small = _event_ms(
        lambda: P.planar_resize_f32(ft.to(torch.float32) / 255.0, st.mask_hw))
    stages[f"MatteNet, K={st.num_classes} (bf16)"], out = _event_ms(lambda: eng.model(small))
    stages["simplex EMA + renorm"], blended = _event_ms(lambda: P.simplex_ema(
        out["alpha"].to(torch.float32), eng.state.rec[0], eng.knobs, eng.state.initialized))
    f32 = ft.to(torch.float32) / 255.0
    sigma = float(next(e["blur"] for e in st.class_effects if "blur" in e))
    stages[f"{INSIDE}blur of the f32 frames at sigma {sigma:g}"], _ = _event_ms(
        lambda: gaussian_blur_auto(f32, sigma))
    stages["per-class composite (f32 frames, upsample, effects, u8)"], _ = _event_ms(
        lambda: multiclass_composite(f32, blended, st.class_effects, out_u8=True))


def _chain_stages(eng, alpha, guide, prior, has_prior, stages):
    """The unfused refine chain's stages apart (runtime/pipeline.py's
    warp_blend, temporal_filter and refine_chain's parts); returns the
    refined alpha."""
    from video_stream_segmenetation_tpu_torch.ops.bilateral import joint_bilateral3x3
    from video_stream_segmenetation_tpu_torch.ops.morphology import (
        morphological_closing_in_prior,
        morphological_opening,
    )
    from video_stream_segmenetation_tpu_torch.ops.refine import refine_alpha
    from video_stream_segmenetation_tpu_torch.runtime import pipeline as P

    st, state, knobs = eng.statics, eng.state, eng.knobs
    stages[f"warp ({st.warp_impl}) + blend ({st.warp_blend_mode})"], base = _event_ms(
        lambda: P.warp_blend(state, alpha, st))
    stages[f"temporal filter ({st.temporal_filter})"], (_, a) = _event_ms(
        lambda: P.temporal_filter(state, base, knobs, st))
    if st.morphology:
        stages["opening + closing in the prior"], a = _event_ms(
            lambda: morphological_closing_in_prior(morphological_opening(a), prior, has_prior))
    stages["joint bilateral (per-stream toggle)"], a = _event_ms(lambda: torch.where(
        knobs.use_bilateral[:, None, None],
        joint_bilateral3x3(a, guide, knobs.sigma_spatial, knobs.sigma_range), a))
    stages["threshold/gamma refine"], a = _event_ms(lambda: refine_alpha(
        a, knobs.noise_cutoff, knobs.high_threshold, knobs.gamma, prior, has_prior))
    return a


def _multiclass_stages(eng, logits, fp, stages):
    """The multi-class step after the trunk: upsample and softmax, the
    simplex EMA and renorm (the step's own code, timed whole), the
    per-class composite, and its blurred guide apart."""
    from video_stream_segmenetation_tpu_torch.ops.blur import gaussian_blur_planar_mxu
    from video_stream_segmenetation_tpu_torch.ops.layout import (
        depth_to_space,
        guide_from_s2d,
        multiclass_composite_s2d,
    )
    from video_stream_segmenetation_tpu_torch.runtime.pipeline import simplex_ema

    st = eng.statics
    fh, fw = st.frame_hw
    mh, mw = st.mask_hw
    blk = st.s2d_block
    uf = eng.model.head_upsample
    stages[f"x{uf} per-class upsample, softmax"], ca = _event_ms(
        lambda: eng.model.upsample(logits))
    stages["simplex EMA + renorm"], blended = _event_ms(
        lambda: simplex_ema(ca, eng.state.rec[0], eng.knobs, eng.state.initialized))
    effects = st.class_effects
    sigma = max(float(next(e["blur"] for e in effects if "blur" in e)) * mh / fh, 0.5)
    stages[f"{INSIDE}guide + blur at sigma {sigma:.2f}"], _ = _event_ms(
        lambda: gaussian_blur_planar_mxu(guide_from_s2d(fp, (fh, fw), (mh, mw), blk)
                                         .float() / 255.0, sigma))
    stages["per-class packed composite (plain PyTorch)"], out = _event_ms(
        lambda: multiclass_composite_s2d(fp, blended, effects, (fh, fw), blk))
    stages["unpack (depth_to_space)"], _ = _event_ms(lambda: depth_to_space(out, blk))


def _refine_stages(eng, logits, fp, stages, out_dtype):
    """The single-class step after the trunk."""
    from video_stream_segmenetation_tpu_torch.kernels.refine_fused import fused_temporal_refine
    from video_stream_segmenetation_tpu_torch.ops.layout import (
        alpha_composite_s2d,
        depth_to_space,
        guide_from_s2d,
    )
    from video_stream_segmenetation_tpu_torch.runtime.pipeline import face_subpath_compact

    st = eng.statics
    s = fp.shape[0]
    fh, fw = st.frame_hw
    mh, mw = st.mask_hw
    blk = st.s2d_block
    dev = eng.device
    stages["x4 upsample, sigmoid"], alpha = _event_ms(lambda: eng.model.upsample(logits))
    alpha = alpha.contiguous()
    stages["planar guide"], guide = _event_ms(
        lambda: guide_from_s2d(fp, (fh, fw), (mh, mw), blk).contiguous())
    if st.face_path:
        gate = torch.ones((s,), dtype=torch.bool, device=dev)
        fidx = torch.zeros((s,), dtype=torch.int32, device=dev)
        stages[f"face subpath (K={-(-s // st.lmk_interval)} of {s} streams)"], face = \
            _event_ms(lambda: face_subpath_compact(eng.face_models, guide, fidx, gate, st))
        prior, has_prior = face[0].contiguous(), face[1]
    else:
        prior = torch.zeros((s, 4), device=dev)
        has_prior = torch.zeros((s,), dtype=torch.bool, device=dev)
    stages["refine kernel (+index prep)"], (_, a) = _event_ms(lambda: fused_temporal_refine(
        alpha, eng.state.prev_alpha, eng.state.affine, eng.state.has_affine,
        eng.state.initialized, st.warp_blend_weight, guide, prior, has_prior, eng.knobs,
        out_dtype=out_dtype))
    stages["packed composite"], out = _event_ms(
        lambda: alpha_composite_s2d(fp, a, eng.backgrounds, (fh, fw), blk))
    stages["unpack (depth_to_space)"], _ = _event_ms(lambda: depth_to_space(out, blk))


def _profile_steps(step, steps, config, what="Engine.process"):
    """torch.profiler over ``steps`` calls of ``step()``: wall, device time
    in kernels and in copies, device operations a step, idle share."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ka = prof.key_averages()
    busy = {"kernels": 0.0, "memcpy/memset": 0.0}
    launches = 0
    for e in ka:
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", 0)
        busy["memcpy/memset" if e.key.startswith(("Memcpy", "Memset")) else "kernels"] += us
        launches += e.count
    print(f"[{config}] profiled {steps} {what} calls: wall {wall_ms / steps:.2f} ms "
          "a step; " + ", ".join(f"{k} {v / 1e3 / steps:.2f} ms a step"
                                 for k, v in busy.items())
          + f"; {launches / steps:.0f} device operations a step; SMs idle (no kernel "
          f"running) {100 - 100 * busy['kernels'] / 1e3 / wall_ms:.1f} % of the wall time",
          flush=True)
    print(ka.table(sort_by="self_device_time_total", row_limit=14, max_name_column_width=60),
          flush=True)


# the train phase's two geometries (train/flagship.py): pretraining and the
# serving-resolution fine-tune, (frame hw, batch)
TRAIN_GEOMETRIES = (((240, 320), 32), ((720, 1280), 8))


def profile_train(steps: int, smi: str) -> None:
    """Where a training step of the pico MatteNetHD (bf16, full widths)
    goes, at each of :data:`TRAIN_GEOMETRIES`: CUDA-event times of the
    synthetic batch, the forward and loss, the forward, loss and backward,
    the optimizer's update, the whole step; then torch.profiler over whole
    steps (batch included)."""
    from video_stream_segmenetation_tpu_torch.models.mattenet_hd import MatteNetHD
    from video_stream_segmenetation_tpu_torch.runtime.precision import pinned
    from video_stream_segmenetation_tpu_torch.train.loop import synthetic_matting_batch
    from video_stream_segmenetation_tpu_torch.train.losses import matting_loss
    from video_stream_segmenetation_tpu_torch.train.step import (
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    dev = torch.device("cuda", 0)
    model = MatteNetHD(device=dev)
    tx = make_optimizer(5e-4)
    state, _ = init_train_state(model, tx)
    train_step = make_train_step(model, tx)
    params = list(state.params.values())
    for hw, batch in TRAIN_GEOMETRIES:
        gen = torch.Generator(device=dev).manual_seed(0)
        label = f"train {hw[0]}x{hw[1]} b{batch}"
        with pinned():  # as fit runs
            for _ in range(3):
                state, _ = train_step(state, *synthetic_matting_batch(gen, batch, hw))
            frames, gt = synthetic_matting_batch(gen, batch, hw)

            def loss():
                return matting_loss(model(frames), gt, frames)[0]

            def grads():
                return torch.autograd.grad(loss(), params)

            g = dict(zip(state.params, grads()))
            scratch = tx.init(state.params)
            stages = {"synthetic batch": _event_ms(
                          lambda: synthetic_matting_batch(gen, batch, hw))[0],
                      "forward + loss": _event_ms(loss)[0],
                      "forward + loss + backward": _event_ms(grads)[0],
                      "optimizer update": _event_ms(
                          lambda: tx.update(g, scratch, state.params))[0],
                      "whole step (train_step)": _event_ms(
                          lambda: train_step(state, frames, gt))[0]}
            print(f"[{label}] pico MatteNetHD bf16, CUDA events, mean of 5 ({smi}):",
                  flush=True)
            for k, v in stages.items():
                print(f"  {k:56s} {v:8.3f} ms")

            def whole():
                nonlocal state
                state, _ = train_step(state, *synthetic_matting_batch(gen, batch, hw))

            _profile_steps(whole, steps, label, "batch + train_step")
    del model, state
    torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--config", nargs="*", default=list(CONFIGS),
                    choices=[*CONFIGS, "train"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    for config in args.config:
        if config == "train":
            profile_train(args.steps, smi)
        else:
            profile(config, args.streams, args.steps, smi)


if __name__ == "__main__":
    main()
