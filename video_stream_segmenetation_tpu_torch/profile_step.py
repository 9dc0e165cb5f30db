"""Where the serving step's time goes on the card.

    python3 -m video_stream_segmenetation_tpu_torch.profile_step [--streams 64]
        [--config pico_noface|pico|micro|mc_pico|mc|full|lite|active|fast|multiclass|
                  nano|femto|blaze|branch|rvm|u2|refface|pico_int8face|
                  pico_uncompacted|pico_translation|fast_s2d|pico_exact|full_bf16|
                  mc_pico_bf16|active_asymmetric|train ...]

For each configuration (default: all twenty-five) it builds Engine(S, preset):
``pico_noface`` is fast_int8_pico with the face path off and seeded
weights, ``pico``, ``micro``, ``mc_pico``, ``mc``, ``full``, ``lite``,
``active``, ``fast``, ``multiclass``, ``nano``, ``femto``, ``blaze``,
``branch``, ``rvm`` and ``u2`` are fast_int8_pico, fast_int8_micro,
multiclass_fast_pico, multiclass_fast, fast_int8, fast_int8_lite, active,
fast, multiclass, fast_int8_nano, fast_int8_femto, blaze_tracking, branch,
rvm and u2 as their presets stand, ``refface`` is fast_int8_pico_refface
(the MediaPipe face graphs), ``pico_int8face``, ``pico_uncompacted`` and
``pico_translation`` fast_int8_pico with face_precision='int8',
face_compact=False and face_tracking='translation', ``fast_s2d`` fast
with frame_layout='s2d' (the float plan A over packed frames),
``pico_exact`` fast_int8_pico with warp_impl='exact',
upsample_precision='exact' and upsample_method='align_corners',
``full_bf16`` and ``mc_pico_bf16`` fast_int8 and multiclass_fast_pico with
matting_precision='bf16' (the float plan B and K=4 pico over packed frames,
on the seed-0 tree and the trained face models: no committed float
export), ``active_asymmetric`` active with upsample_method='asymmetric'
and use_fused_composite=True, with the committed trained weights and
frames (branch with its even streams' affine primed, as chip_smoke.py's
phase).  It warms the engine up, then
  * times each stage of the step with CUDA events, calling the step's own
    functions on the engine's tensors (frames host->device, s2d pack, stem,
    the trunk -- for micro its convolutions and its decoder levels plus
    head apart; the kernels of micro's decoder and of the pico/nano, full
    and light trunks one by one by torch.profiler --,
    upsample, guide, face subpath (the compacted one, or on all the
    streams without compaction, or the translation subpath), refine
    kernel, packed composite,
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
The float MatteNetHD's stem over packed frames (the patch product) is timed
apart from its layers after the stem.
``train`` (not in the default set) does the same for a training step of
the pico MatteNetHD at the train phase's two geometries (profile_train).
Needs a card; prints the card's name and power limit beside the numbers.

    python3 -m video_stream_segmenetation_tpu_torch.profile_step --ablate
        [--preset fast_int8_pico ...] [--streams 64] [--n1 2] [--n2 10] [--reps 5]

``--ablate`` (the reference's tools/bench_step_ablate.py, bench_face_ablate.py
and bench_rollout_ablate.py in one): for each preset (trained weights,
committed frames) one engine a variant of ABLATIONS (``debug_stage`` tokens,
and the face path off), each timed by the step rollout's slope
(runtime/rollout.py::time_rollout: paired chains of n1 and n2 steps, the
variants interleaved within each rep, the median of the reps; host clock
and CUDA events), then the harness's own terms on the full step ('reduce'
against 'buffer', 'weights' and no perturbation against 'xor'), and the
differences that attribute a stage (ATTRIBUTION).  The rollout's frames are
on the card already: the slope leaves out the frames' copy.
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
    "refface": ("fast_int8_pico_refface", {}, True),
    "pico_int8face": ("fast_int8_pico", {"face_precision": "int8"}, True),
    "pico_uncompacted": ("fast_int8_pico", {"face_compact": False}, True),
    "pico_translation": ("fast_int8_pico", {"face_tracking": "translation"}, True),
    "fast_s2d": ("fast", {"frame_layout": "s2d", "s2d_block": 5}, True),
    "pico_exact": ("fast_int8_pico", {"warp_impl": "exact", "upsample_precision": "exact",
                                      "upsample_method": "align_corners"}, True),
    "full_bf16": ("fast_int8", {"matting_precision": "bf16"}, "seeded"),
    "mc_pico_bf16": ("multiclass_fast_pico", {"matting_precision": "bf16"}, "seeded"),
    "active_asymmetric": ("active", {"upsample_method": "asymmetric",
                                     "use_fused_composite": True}, True),
}
# branch: the even streams start with this affine (chip_smoke.py's
# PRIMED_AFFINE), so that its max blend runs
PRIMED_AFFINE = (1.0, 0.0, 2.0, 0.0, 1.0, -2.0)
# a stage timed apart that another stage's time already holds, and one
# that the configuration could run instead of another (neither is summed)
INSIDE = "  (inside the composite) "
INSTEAD = "  (instead of the plain composite) "


def _event_ms(fn, iters=5):
    """(CUDA-event ms a call, mean of ``iters`` after a warm-up, the last
    call's result): utils/profiling.py::event_ms."""
    from video_stream_segmenetation_tpu_torch.utils.profiling import event_ms

    return event_ms(fn, iters)


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
    pico/nano (its 9 launches, 10 kernels: the SE's are two), full and light
    trunks' kernels.  Returns (logits, that list)."""
    from video_stream_segmenetation_tpu_torch.kernels import trunk_int8 as TK

    if model.decoder in ("full", "light"):
        label = {"full": "full trunk (plan B): convs, SEs, split 3x3 decoder, head",
                 "light": "light trunk (plan C): convs, SEs, decoder levels, head"}
        stages[label[model.decoder]], logits = _event_ms(lambda: model.trunk_logits(x0))
        return logits, _kernel_ms(lambda: model.trunk_logits(x0))
    if model.decoder != "micro":
        head = f", K={model.num_classes} head" if model.num_classes > 1 else ""
        stages[f"{model.decoder} trunk kernel (9 launches{head})"], logits = _event_ms(
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
        weights = (bridge.trained_weights(st) if trained is True
                   else {"face_params": bridge.face_weights(st)})
        eng = Engine(s, st, **weights, seed=0)
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
    if st.matting_precision == "bf16":  # the float MatteNetHD: no trunk kernel
        model = eng.model
        plan = "plan A" if model.plan_a else f"{model.decoder} plan"
        tail = "softmax" if model.num_classes > 1 else "sigmoid"
        stages[f"float stem (bf16 patch product, {blk * blk * 3} lanes, BN, relu6)"], x0 = \
            _event_ms(lambda: model.stem(fp))
        stages[f"float MatteNetHD {plan} after the stem (bf16; f32 upsample, {tail})"], out = \
            _event_ms(lambda: model.from_stem(x0))
        logits, maps, trunk_kernels = None, out["alpha"].to(torch.float32).contiguous(), []
    else:
        stages["stem (bf16 patch matmul, requant)"], x0 = _event_ms(lambda: eng.model.stem(fp))
        logits, trunk_kernels = _trunk_stages(eng.model, x0, stages)
        maps = None
    if st.num_classes > 1:
        _multiclass_stages(eng, logits, maps, fp, stages)
    else:
        _refine_stages(eng, logits, maps, fp, stages, out_dtype)
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
    method = st.upsample_method
    stages["plain composite (bf16-pass upsample, f32 blend)"], _ = _event_ms(
        lambda: natural_composite(ft, a, bg, method=method))
    if st.background == "image":
        stages[f"{INSTEAD}composite kernel ({method})"], _ = _event_ms(
            lambda: fused_composite(ft, a, eng.backgrounds, method=method))


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


def _multiclass_stages(eng, logits, maps, fp, stages):
    """The multi-class step after the trunk: upsample and softmax (the
    float model's ``maps`` come with them), the simplex EMA and renorm (the
    step's own code, timed whole), the per-class composite, and its blurred
    guide apart."""
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
    if maps is None:
        stages[f"x{uf} per-class upsample, softmax"], ca = _event_ms(
            lambda: eng.model.upsample(logits))
    else:
        ca = maps
    stages["simplex EMA + renorm"], blended = _event_ms(
        lambda: simplex_ema(ca, eng.state.rec[0], eng.knobs, eng.state.initialized))
    effects = st.class_effects
    sigma = max(float(next(e["blur"] for e in effects if "blur" in e)) * mh / fh, 0.5)
    stages[f"{INSIDE}guide + blur at sigma {sigma:.2f}"], _ = _event_ms(
        lambda: gaussian_blur_planar_mxu(guide_from_s2d(fp, (fh, fw), (mh, mw), blk)
                                         .float() / 255.0, sigma))
    stages["per-class packed composite (plain PyTorch)"], out = _event_ms(
        lambda: multiclass_composite_s2d(fp, blended, effects, (fh, fw), blk,
                                         method=st.upsample_method))
    stages["unpack (depth_to_space)"], _ = _event_ms(lambda: depth_to_space(out, blk))


def _refine_stages(eng, logits, maps, fp, stages, out_dtype):
    """The single-class step after the trunk (the float model's ``maps``
    come upsampled): the refine by its route (the fused temporal refine,
    or the eager warp, blend and EMA, then fused_refine), the packed
    composite at the statics' method and precision."""
    from video_stream_segmenetation_tpu_torch.kernels.refine_fused import (
        fused_refine,
        fused_temporal_refine,
    )
    from video_stream_segmenetation_tpu_torch.ops.layout import (
        alpha_composite_s2d,
        depth_to_space,
        guide_from_s2d,
    )
    from video_stream_segmenetation_tpu_torch.runtime import pipeline as P

    st = eng.statics
    s = fp.shape[0]
    fh, fw = st.frame_hw
    mh, mw = st.mask_hw
    blk = st.s2d_block
    dev = eng.device
    if maps is None:
        stages["x4 upsample, sigmoid"], alpha = _event_ms(lambda: eng.model.upsample(logits))
        alpha = alpha.contiguous()
    else:
        alpha = maps
    route = P.refine_routing(st)
    form = "params" if route["analytic_prior"] else "plane"
    stages["planar guide"], guide = _event_ms(
        lambda: guide_from_s2d(fp, (fh, fw), (mh, mw), blk).contiguous())
    gate = torch.ones((s,), dtype=torch.bool, device=dev)
    fstat = P.face_statics(st)
    models = {"reference": "MediaPipe graphs", "fast": st.face_precision}[st.face_models]
    if st.face_path and st.face_tracking == "translation":
        stages[f"translation subpath ({st.fd_size} resize of all {s} guides, detector)"], _ = \
            _event_ms(lambda: P.face_translation_subpath(
                eng.face_models.face, P.face_image(guide, planar=True), eng.state, fstat, gate))
        prior = torch.zeros((s, 4), device=dev)
        has_prior = torch.zeros((s,), dtype=torch.bool, device=dev)
    elif st.face_path and not st.face_compact:
        stages[f"face subpath on all {s} streams ({models})"], face = _event_ms(
            lambda: P.face_subpath(eng.face_models, P.face_f32(guide, planar=True), gate,
                                   fstat))
        prior, has_prior = face[0].contiguous(), face[1]
    elif st.face_path:
        fidx = torch.zeros((s,), dtype=torch.int32, device=dev)
        # the face source: the guide, or with face_input='frames' the packed
        # frames (the gathered streams unpacked)
        src = (dict(src=guide) if st.face_input == "guide"
               else dict(src=fp, src_planar=False, s2d_block=blk))
        stages[f"face subpath (K={-(-s // st.lmk_interval)} of {s} streams, {models})"], \
            face = _event_ms(lambda: P.face_subpath_compact(
                eng.face_models, frame_idx=fidx, face_gate=gate, statics=st, prior_form=form,
                **src))
        prior, has_prior = face[0].contiguous(), face[1]
    else:
        prior = torch.zeros((s, 4) if form == "params" else (s, mh, mw), device=dev)
        has_prior = torch.zeros((s,), dtype=torch.bool, device=dev)
    if route["use_fused_tr"]:
        stages["refine kernel (+index prep)"], (_, a) = _event_ms(lambda: fused_temporal_refine(
            alpha, eng.state.prev_alpha, eng.state.affine, eng.state.has_affine,
            eng.state.initialized, st.warp_blend_weight, guide, prior, has_prior, eng.knobs,
            out_dtype=out_dtype))
    else:
        stages[f"warp ({st.warp_impl}) + blend, EMA (eager)"], (_, a) = _event_ms(
            lambda: P.temporal_filter(eng.state, P.warp_blend(eng.state, alpha, st), eng.knobs,
                                      st))
        a = a.contiguous()
        stages["fused_refine kernel"], a = _event_ms(
            lambda: fused_refine(a, guide, prior, has_prior, eng.knobs))
    stages[f"packed composite ({st.upsample_method}, {st.upsample_precision})"], out = \
        _event_ms(lambda: alpha_composite_s2d(fp, a, eng.backgrounds, (fh, fw), blk,
                                              method=st.upsample_method,
                                              precision=st.upsample_precision))
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


# the --ablate variants: (label, statics overrides)
ABLATIONS = (
    ("full", {}),
    ("model_only", {"debug_stage": "model_only"}),
    ("no_composite", {"debug_stage": "no_composite"}),
    ("model_only,no_composite", {"debug_stage": "model_only,no_composite"}),
    ("no_morph", {"debug_stage": "no_morph"}),
    ("no_bilateral", {"debug_stage": "no_bilateral"}),
    ("no_guide", {"debug_stage": "no_guide"}),
    ("fd_only", {"debug_stage": "fd_only"}),
    ("fd_only,fd_stub", {"debug_stage": "fd_only,fd_stub"}),
    ("no_lmk", {"debug_stage": "no_lmk"}),
    ("face_path=False", {"face_path": False}),
)
# (stage, the variant with it, the variant without it)
ATTRIBUTION = (
    ("refine (warp, EMA, morphology, bilateral, threshold)", "full", "model_only"),
    ("composite", "model_only", "model_only,no_composite"),
    ("composite, with the refine's output", "full", "no_composite"),
    ("morphology (stages 5 + 7, in the kernel)", "full", "no_morph"),
    ("bilateral (stage 8, in the kernel)", "full", "no_bilateral"),
    ("guide (built for the kernel)", "full", "no_guide"),
    ("face path", "full", "face_path=False"),
    ("FaceFinder forward", "fd_only", "fd_only,fd_stub"),
    ("prior after the detector", "no_lmk", "fd_only"),
    ("landmarks (ROI, LandmarkNet, Procrustes)", "full", "no_lmk"),
    ("model, guide, face path, state (the rest)", "model_only,no_composite", None),
)
# the harness's own terms on the full step: (label, acc_mode, perturb)
HARNESS = (("buffer, xor", "buffer", "xor"), ("reduce, xor", "reduce", "xor"),
           ("buffer, weights", "buffer", "weights"), ("buffer, no perturbation", "buffer",
                                                      False))


def ablate(name: str, s: int, n1: int, n2: int, reps: int, smi: str,
           device="cuda") -> dict:
    """Step-rollout slopes of ``name``'s ablation variants and harness terms
    at S = ``s``, trained weights, committed frames; prints them and the
    attribution.  Returns ``{label: time_rollout's result}`` (on the CPU,
    a rehearsal, the host clock alone)."""
    from video_stream_segmenetation_tpu_torch import bridge
    from video_stream_segmenetation_tpu_torch.runtime.presets import preset
    from video_stream_segmenetation_tpu_torch.runtime.rollout import (
        make_step_rollout,
        perturbed_models,
        time_rollout,
    )
    from video_stream_segmenetation_tpu_torch.service.engine import Engine

    clip, _ = bridge.load_frames()
    frames = np.ascontiguousarray(clip[np.arange(s) % 2])
    weights = bridge.trained_weights(preset(name))
    rolls, args = {}, {}
    for label, over in ABLATIONS:
        eng = Engine(s, preset(name, **over), **weights, seed=0, device=device)
        eng.face_min_interval_s = 0.0
        eng.admit_all()
        eng.process(frames)
        gate = torch.ones((s,), dtype=torch.bool, device=eng.device)
        args[label] = (eng.state, eng._ingest(frames)[1][0], eng.backgrounds, eng.knobs, gate)
        if label == "full":
            for h_label, acc, perturb in HARNESS:
                pm = perturbed_models(eng) if perturb == "weights" else None
                rolls[h_label] = make_step_rollout(eng.model, eng.statics, eng.face_models,
                                                   acc, perturb, pm)
                args[h_label] = args[label]
            rolls[label] = rolls["buffer, xor"]
        else:
            rolls[label] = make_step_rollout(eng.model, eng.statics, eng.face_models)
    # the variants interleaved within each rep, each with its engine's arguments
    order = [label for label, _ in ABLATIONS] + [h for h, _, _ in HARNESS[1:]]
    results = time_rollout([rolls[k] for k in order], [args[k] for k in order], n1, n2, reps,
                           device=device)
    res = dict(zip(order, results))
    res["buffer, xor"] = res["full"]

    def slope(k, clock):
        r = res[k][clock]
        return None if r is None else r["slope"]

    def fmt(v):
        return "not measured" if v is None else f"{v:8.3f}"

    def diff(a, b, clock):
        va, vb = slope(a, clock), (slope(b, clock) if b else 0.0)
        return None if va is None or vb is None else va - vb

    print(f"[ablate {name}] S={s}, step rollout slope (n1={n1}, n2={n2}, median of {reps} "
          f"paired reps, variants interleaved; 'buffer', 'xor' unless named), ms a step, "
          f"host clock / CUDA events ({smi}):", flush=True)
    for k in order:
        fixed = res[k]["host_ms"]["fixed"]
        print(f"  {k:34s} {fmt(slope(k, 'host_ms'))} / {fmt(slope(k, 'event_ms'))}   "
              f"(fixed term, host: {fixed:.2f} ms)", flush=True)
    print(f"[ablate {name}] attribution, ms a step (host / events):", flush=True)
    for stage, a, b in ATTRIBUTION:
        what = f"{a} - {b}" if b else a
        print(f"  {stage:52s} {fmt(diff(a, b, 'host_ms'))} / {fmt(diff(a, b, 'event_ms'))}"
              f"   ({what})", flush=True)
    for stage, a, b in (("buffer - reduce (the output's store)", "buffer, xor", "reduce, xor"),
                        ("xor - weights (the tagged frames)", "buffer, xor",
                         "buffer, weights"),
                        ("weights - no perturbation", "buffer, weights",
                         "buffer, no perturbation")):
        print(f"  {stage:52s} {fmt(diff(a, b, 'host_ms'))} / {fmt(diff(a, b, 'event_ms'))}",
              flush=True)
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--config", nargs="*", default=list(CONFIGS),
                    choices=[*CONFIGS, "train"])
    ap.add_argument("--ablate", action="store_true",
                    help="time the debug_stage variants by the step rollout's slope")
    ap.add_argument("--preset", nargs="*", default=["fast_int8_pico"])
    ap.add_argument("--n1", type=int, default=2)
    ap.add_argument("--n2", type=int, default=10)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    if args.ablate:
        for name in args.preset:
            ablate(name, args.streams, args.n1, args.n2, args.reps, smi)
            torch.cuda.empty_cache()
        return
    for config in args.config:
        if config == "train":
            profile_train(args.steps, smi)
        else:
            profile(config, args.streams, args.steps, smi)


if __name__ == "__main__":
    main()
