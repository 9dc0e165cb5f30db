"""Serving rollouts: the production step or round run n times in one chain,
for step and round times that per-call costs do not move (port of
``runtime/rollout.py``).

A median of a few host-clock calls of ``Engine.process`` moves by more than
a kernel saves: each call carries its own fixed costs (the frames' copy to
the card, the engine's bookkeeping, the synchronisation that ends it).  A
chain of n steps, timed at two lengths, gives the step's time as the slope
``(t(n2) - t(n1)) / (n2 - n1)``, in which every per-chain cost cancels
(:func:`time_rollout`).

* :func:`make_step_rollout` chains the production step
  (runtime/pipeline.py::make_step), :func:`make_round_rollout` the
  production rotation round (``make_round_step``: every group's range step
  over the full state, rows written in place, the face clock on the card),
  ``now`` advancing by ``tick_dt`` a round as it does in serving.
* Iteration 0 runs on the given frames; iterations 1..n-1 on the frames
  with a 1-bit tag ``i & 1`` XORed into every u8 array (``perturb='xor'``),
  or on the models built once from the trees with ``(i & 1) * 1e-7`` added
  to every float leaf (``'weights'``; the two sets alternate by parity), so
  that no iteration repeats the one before; ``False`` is a diagnostic of the
  harness, not a step time.
* Every iteration's ``frame`` and ``alpha`` are added into carried buffers
  of their own dtype (``acc_mode='buffer'``: a u8 frame wraps modulo 256, a
  bf16 alpha rounds in bf16, as the reference's do), or into per-stream
  sums (``'reduce'``: the frame's in int32, wrapping as the reference's,
  the alpha's in its dtype).

How it departs from the reference.  The reference puts the chain inside
one compiled program (``lax.fori_loop``).  The port's Engine issues every
step from the host, and its serving loop pays that issue (PERF.md §5: no
kernel runs for much of a step); so the chain here is a Python loop that
runs each step exactly as the Engine runs it, under
runtime/precision.py::pinned, with no host synchronisation between steps,
and the slope includes the host's issue of the step.  It is not captured
as a CUDA graph: that would time a loop nobody serves.  When the Engine
replays its rounds as graphs, the rollout calls the same replay.

What the slope leaves out: the frames are on the device already, so the
frames' host -> device copy (21-34 ms of a host-clock S=64 step) is not in
it, and the round rollout leaves out the pool's pack and the ingest as
well; a benchmark prices those terms apart.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from video_stream_segmenetation_tpu_torch.runtime.pipeline import make_round_step, make_step
from video_stream_segmenetation_tpu_torch.runtime.precision import pinned
from video_stream_segmenetation_tpu_torch.utils.profiling import check_device, wait

# the leaves of the int8 serving dict that the port keeps in f32 and the
# reference holds, and serves, in bf16 (models/quantized.py: the stem's
# patch weights): 'weights' perturbs them in bf16, as the reference does
SERVED_BF16 = ("stem_w",)
WEIGHT_EPS = 1e-7


def _perturb(frames, i: int):
    """``frames`` (a tensor, or a ``(packed, lanes)`` tuple) with the tag
    ``i & 1`` XORed into every u8 array and added to any other."""
    tag = i & 1

    def one(f):
        if f.dtype == torch.uint8:
            return torch.bitwise_xor(f, tag)
        return f + tag

    if isinstance(frames, tuple):
        return tuple(one(f) for f in frames)
    return one(frames)


def _perturb_params(tree, i: int, served_bf16=SERVED_BF16):
    """A numpy tree with ``(i & 1) * 1e-7``, cast to each floating leaf's
    dtype, added to that leaf (the top-level ``served_bf16`` leaves rounded
    in bf16: ``bf16(p) + bf16(eps)``); integer leaves as they are."""
    eps = np.float32(i & 1) * np.float32(WEIGHT_EPS)

    def one(p, bf16=False):
        if isinstance(p, dict):
            return {k: one(v) for k, v in p.items()}
        p = np.asarray(p)
        if not np.issubdtype(p.dtype, np.floating):
            return p
        if bf16:
            t = torch.from_numpy(p).to(torch.bfloat16) + torch.tensor(eps, dtype=torch.bfloat16)
            return t.to(torch.float32).numpy().astype(p.dtype)
        return p + eps.astype(p.dtype)

    return {k: one(v, k in served_bf16) for k, v in tree.items()}


def engine_models(engine):
    """``(model, statics, face_models)`` of a one-device Engine, what the
    rollouts chain.  The rollouts run on one device: an ``Engine(mesh=...)``
    is refused."""
    if getattr(engine, "mesh", None) is not None:
        raise NotImplementedError("the rollouts chain one device's step; an Engine(mesh=...) "
                                  "steps a shard a device: time it through its own calls")
    return engine.model, engine.statics, engine.face_models


def perturbed_models(engine):
    """``(model, face_models)``: the engine's models rebuilt by its own
    builders from its trees perturbed at an odd iteration (the 'weights'
    set of the odd iterations); a one-device engine only
    (:func:`engine_models`)."""
    engine_models(engine)
    faces = engine.params
    face_trees = None
    if faces["face"] is not None:
        face_trees = {k: _perturb_params(faces[k], 1, ()) for k in ("face", "lmk")}
    return engine.build_models(_perturb_params(engine.matte_params, 1), face_trees)


def _acc_init(out, mode):
    if mode == "reduce":
        f, a = out["frame"], out["alpha"]
        return (torch.sum(f.to(torch.int32), dim=tuple(range(1, f.dim()))).to(torch.int32),
                torch.sum(a, dim=tuple(range(1, a.dim()))).to(a.dtype))
    return out["frame"], out["alpha"]


def _acc_add(acc, out, mode):
    a, b = _acc_init(out, mode)
    return acc[0] + a, acc[1] + b


def _modes(acc_mode, perturb, perturbed):
    if acc_mode not in ("buffer", "reduce"):
        raise ValueError(f"acc_mode {acc_mode!r}: 'buffer' or 'reduce'")
    if perturb is True:
        perturb = "xor"
    if perturb not in ("xor", "weights", False):
        raise ValueError(f"perturb {perturb!r}: 'xor', 'weights' or False")
    if perturb == "weights" and perturbed is None:
        raise ValueError("perturb='weights' needs the odd iterations' models (perturbed="
                         "perturbed_models(engine))")
    return perturb


def make_step_rollout(model, statics, face_models=None, acc_mode: str = "buffer",
                      perturb="xor", perturbed=None):
    """``roll(state, frames, bgs, knobs, gate, n) -> (new_state, acc_frame,
    acc_alpha)``: the production batch step (``make_step(model, statics,
    face_models)``) chained ``n`` (>= 1) times, each step on the state the
    one before returned (module docstring).  ``perturbed``: the odd
    iterations' ``(model, face_models)`` for ``perturb='weights'``
    (:func:`perturbed_models`).  ``state`` is not written in place."""
    perturb = _modes(acc_mode, perturb, perturbed)
    steps = [make_step(model, statics, face_models)]
    if perturb == "weights":
        steps.append(make_step(perturbed[0], statics, perturbed[1]))

    def roll(state, frames, bgs, knobs, gate, n: int):
        with pinned():
            state, out = steps[0](state, frames, bgs, knobs, gate)
            accs = _acc_init(out, acc_mode)
            for i in range(1, n):
                fr = _perturb(frames, i) if perturb == "xor" else frames
                step = steps[i & 1] if perturb == "weights" else steps[0]
                state, out = step(state, fr, bgs, knobs, gate)
                accs = _acc_add(accs, out, acc_mode)
        return state, accs[0], accs[1]

    return roll


def make_round_rollout(model, statics, group_sizes, face_models=None,
                       tick_dt: float = 1.0 / 30.0, acc_mode: str = "buffer",
                       perturb="xor", perturbed=None):
    """``roll(full_state, frames_list, full_bgs, full_knobs, face_last, now0,
    min_interval, n) -> (full_state, face_last, accs)``: ``n`` whole rounds
    of the production rotation (``make_round_step``: every group's range
    step at the schedule's offsets, the rows and ``face_last`` written in
    place), round ``i`` at ``now0 + f32(i) * f32(tick_dt)`` in ``now0``'s
    dtype; ``accs`` one ``(frame, alpha)`` pair a group.  ``frames_list``:
    one frame batch a group, as the round step takes them;
    ``perturb``/``perturbed``: as :func:`make_step_rollout`."""
    perturb = _modes(acc_mode, perturb, perturbed)
    rounds = [make_round_step(model, statics, group_sizes, face_models)]
    if perturb == "weights":
        rounds.append(make_round_step(perturbed[0], statics, group_sizes, perturbed[1]))

    def roll(full_state, frames_list, full_bgs, full_knobs, face_last, now0, min_interval,
             n: int):
        with pinned():
            full_state, face_last, outs = rounds[0](full_state, frames_list, full_bgs,
                                                    full_knobs, face_last, now0, min_interval)
            accs = [_acc_init(o, acc_mode) for o in outs]
            for i in range(1, n):
                # f32(i) * f32(tick_dt), exact in now0's f32 as a Python float
                now = now0 + float(np.float32(i) * np.float32(tick_dt))
                fl = ([_perturb(f, i) for f in frames_list] if perturb == "xor"
                      else frames_list)
                rstep = rounds[i & 1] if perturb == "weights" else rounds[0]
                full_state, face_last, outs = rstep(full_state, fl, full_bgs, full_knobs,
                                                    face_last, now, min_interval)
                accs = [_acc_add(a, o, acc_mode) for a, o in zip(accs, outs)]
        return full_state, face_last, accs

    return roll


def time_rollout(rolls, args_for, n1: int, n2: int, reps: int = 5, device="cuda") -> list:
    """Paired slopes of chained rollouts (the reference's bench.py
    ``time_rolls``): each rep times, for each roll in turn, a chain of
    ``n1`` then of ``n2`` iterations back to back, so that a pair shares
    one window of the device's drift.  ``rolls``: one roll or a list of
    them (variants interleaved within each rep); ``args_for``: the roll's
    arguments but ``n`` (a tuple, or a callable that returns them, called
    before each chain, outside the clock), or a list of those, one a roll.  A chain is timed by the host
    clock from its first issue to a synchronize, and by CUDA events on the
    current stream (None on the CPU).  Returns, per roll, ``{"host_ms",
    "event_ms"}`` each ``{"slope", "fixed", "slopes"}``: the median per-rep
    slope ``(t(n2) - t(n1)) / (n2 - n1)``, the median fixed term ``t(n1) -
    n1 * slope`` and every rep's slope."""
    single = callable(rolls)
    rolls = [rolls] if single else list(rolls)
    dev = check_device(device)
    cuda = dev.type == "cuda"

    def args(r):
        a = args_for[r] if isinstance(args_for, list) else args_for
        return a() if callable(a) else a

    def once(r, n):
        roll, a = rolls[r], args(r)
        wait(dev)
        if cuda:
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
        t0 = time.perf_counter()
        roll(*a, n)
        if cuda:
            e1.record()
        wait(dev)
        host = (time.perf_counter() - t0) * 1e3
        return host, (e0.elapsed_time(e1) if cuda else None)

    for r in range(len(rolls)):  # warm-up: allocations, cuDNN plans, the library
        once(r, min(n1, 2))
    pairs = [[] for _ in rolls]
    for _ in range(reps):
        for r in range(len(rolls)):
            pairs[r].append((once(r, n1), once(r, n2)))
    results = []
    for ps in pairs:
        res = {}
        for c, key in ((0, "host_ms"), (1, "event_ms")):
            if ps[0][0][c] is None:
                res[key] = None
                continue
            slopes = [(t2[c] - t1[c]) / (n2 - n1) for t1, t2 in ps]
            slope = statistics.median(slopes)
            res[key] = {"slope": slope,
                        "fixed": statistics.median(t1[c] - n1 * slope for t1, _ in ps),
                        "slopes": slopes}
        results.append(res)
    return results[0] if single else results
