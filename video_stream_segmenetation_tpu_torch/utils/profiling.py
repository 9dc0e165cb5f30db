"""Timing and tracing (port of ``utils/profiling.py``).

The reference instruments with ``performance.now()`` spans around inference
and the whole frame (frameProcessorTest.ts:76,90-92,180-185).  Here:

* :func:`event_ms`: the CUDA-event timer of a function's calls (one warm-up
  call, then events around ``iters`` calls, the mean), which
  ``profile_step.py`` and ``chip_smoke.py`` time their kernels and stages
  with;
* :func:`device_timer`: a host-clock span that waits for the device's
  pending work before it closes;
* :func:`time_fn`: mean, least and median of calls, each waited for;
* :func:`trace`: ``torch.profiler`` over the CPU and the card, written as a
  Chrome trace (``chrome://tracing`` or Perfetto read it).

Each takes ``device``: ``"cuda"`` (the default) waits for the card and
raises without one; ``"cpu"`` times the host clock alone.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def check_device(device) -> torch.device:
    """``device`` as a torch.device; ``"cuda"`` without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch.cuda.is_available() is False; "
                           "pass device='cpu' to time the host clock")
    return dev


def wait(device) -> None:
    """Wait for all work pending on ``device`` (nothing on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def event_ms(fn, iters: int = 5, device="cuda"):
    """``(ms, out)``: the mean time of ``iters`` calls of ``fn`` after one
    warm-up call, by CUDA events on the current stream (``device='cpu'``:
    the host clock), and the last call's result."""
    dev = check_device(device)
    out = fn()
    wait(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        return (time.perf_counter() - t0) * 1e3 / iters, out
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        out = fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters, out


@contextlib.contextmanager
def device_timer(results: dict, key: str, device="cuda"):
    """Host-clock milliseconds of the block into ``results[key]``, waiting
    for everything pending on ``device`` before the clock stops."""
    dev = check_device(device)
    t0 = time.perf_counter()
    yield
    wait(dev)
    results[key] = (time.perf_counter() - t0) * 1e3


def time_fn(fn, *args, warmup: int = 2, iters: int = 10, device="cuda", **kw) -> dict:
    """``{"mean_ms", "min_ms", "p50_ms", "samples"}`` of ``iters`` calls of
    ``fn(*args, **kw)`` after ``warmup`` calls, each call waited for on
    ``device`` (host clock)."""
    dev = check_device(device)
    for _ in range(warmup):
        fn(*args, **kw)
    wait(dev)
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args, **kw)
        wait(dev)
        samples.append((time.perf_counter() - t0) * 1e3)
    return {
        "mean_ms": sum(samples) / len(samples),
        "min_ms": min(samples),
        "p50_ms": sorted(samples)[len(samples) // 2],
        "samples": samples,
    }


@contextlib.contextmanager
def trace(logdir: str, device="cuda"):
    """``torch.profiler`` over the block (CPU activity, and the card's with
    ``device='cuda'``); on exit the device is waited for and a Chrome trace
    is written into ``logdir`` (made if missing), as
    ``trace_<pid>_<ms>.json``.  Yields ``logdir``."""
    dev = check_device(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield logdir
        wait(dev)
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))
