"""Engine: the stateful multi-stream serving loop (port of
``service/engine.py::Engine``, synchronous ``process`` path).

The engine owns S stream slots, batches their latest frames into one
``[S, H, W, 3]`` step on its device, and keeps all per-stream state (EMA
accumulator, affine, knobs, packed backgrounds) there.  Knob updates are
staged host-side and applied at the next step boundary, so a step sees one
consistent config.

Unlike the reference, a failed step raises (after recording the failure
in ``health``): there is no catch-all that serves passthrough frames.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from video_stream_segmenetation_tpu_torch.models.mattenet_hd import init_pico_params
from video_stream_segmenetation_tpu_torch.models.quantized import (
    QuantizedMatteNetHD,
    quantize_mattenet_hd,
)
from video_stream_segmenetation_tpu_torch.ops.layout import (
    depth_to_space,
    space_to_depth,
)
from video_stream_segmenetation_tpu_torch.ops.resize import interp_matrix
from video_stream_segmenetation_tpu_torch.runtime.config import (
    PipelineStatics,
    default_knobs,
)
from video_stream_segmenetation_tpu_torch.runtime.pipeline import (
    check_statics,
    make_step,
)
from video_stream_segmenetation_tpu_torch.runtime.presets import preset
from video_stream_segmenetation_tpu_torch.runtime.state import (
    init_state,
    reset_stream,
    reset_streams,
)
from video_stream_segmenetation_tpu_torch.service.counters import Counters
from video_stream_segmenetation_tpu_torch.service.health import HealthMonitor


def resolve_device(device) -> torch.device:
    """``cuda`` (the default) must have a card; the CPU only on request."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch.cuda.is_available() is False; "
                           "pass device='cpu' to run the plain versions")
    return dev


class Engine:
    def __init__(self, num_streams: int, statics: PipelineStatics | None = None,
                 params: dict | None = None, seed: int = 0, device="cuda"):
        """``params``: the int8 serving dict (models/quantized.py
        ``quantize_mattenet_hd`` or bridge.py); None quantizes a float pico
        tree made from ``seed`` (models/mattenet_hd.py)."""
        self.device = resolve_device(device)
        self.num_streams = num_streams
        self.statics = statics or preset("fast_int8_pico", face_path=False)
        check_statics(self.statics)
        st = self.statics
        fh, fw = st.frame_hw
        mh, mw = st.mask_hw
        blk = st.s2d_block
        if fh % blk or fw % blk:
            raise ValueError(f"frame_hw {st.frame_hw} not divisible by s2d_block {blk}")
        hp, wp = fh // blk, fw // blk
        if mh % hp or mw % wp or mh // hp != mw // wp:
            raise ValueError(f"mask_hw {st.mask_hw} must be one integer multiple "
                             f"of the stem grid {(hp, wp)}")
        if params is None:
            params = quantize_mattenet_hd(init_pico_params(seed, blk), blk)
        self.model = QuantizedMatteNetHD(params, blk, mh // hp, device=self.device)
        self._step = make_step(self.model, st)
        self.state = init_state(num_streams, (mh, mw), device=self.device)
        self.knobs = default_knobs(num_streams, ema_adapt=st.ema_adapt_default,
                                   device=self.device)
        # backgrounds are kept packed u8, ready for the packed composite
        self.backgrounds = torch.zeros((num_streams, hp, wp, blk * blk * 3),
                                       dtype=torch.uint8, device=self.device)
        self.active = np.zeros((num_streams,), bool)
        self.counters = Counters()
        self.health = HealthMonitor()
        self._lock = threading.Lock()
        self._staged_knobs: dict[int, dict] = {}

    # ---- stream admission ---------------------------------------------
    def admit(self) -> int:
        """Take a free slot; cold-start its state.  Returns the slot id."""
        with self._lock:
            free = np.flatnonzero(~self.active)
            if free.size == 0:
                raise RuntimeError("engine full: no free stream slots")
            s = int(free[0])
            self.active[s] = True
        reset_stream(self.state, s)
        return s

    def admit_all(self) -> list[int]:
        """Activate every free slot at once, with one state reset."""
        with self._lock:
            free = np.flatnonzero(~self.active)
            self.active[:] = True
        if free.size:
            mask = np.zeros((self.num_streams,), bool)
            mask[free] = True
            reset_streams(self.state, torch.as_tensor(mask, device=self.device))
        return [int(s) for s in free]

    def evict(self, slot: int) -> None:
        with self._lock:
            self.active[slot] = False
        reset_stream(self.state, slot)

    # ---- live config --------------------------------------------------
    def set_knobs(self, slot: int, **kw) -> None:
        """Stage per-stream knob updates; applied at the next step."""
        with self._lock:
            self._staged_knobs.setdefault(slot, {}).update(kw)

    def set_background(self, slot: int, image) -> None:
        """Set a stream's background (u8 or float 0..1 RGB ``[h, w, 3]``;
        resized half-pixel bilinear to the frame), packed once here."""
        img = torch.as_tensor(np.asarray(image), device=self.device)
        if img.dtype == torch.uint8:
            img = img.to(torch.float32) / 255.0
        img = img.to(torch.float32)
        fh, fw = self.statics.frame_hw
        if tuple(img.shape[:2]) != (fh, fw):
            a_h = interp_matrix(fh, img.shape[0], "half_pixel", device=self.device)
            a_w = interp_matrix(fw, img.shape[1], "half_pixel", device=self.device)
            img = torch.einsum("oh,hwc->owc", a_h, img)
            img = torch.einsum("pw,hwc->hpc", a_w, img)
        img_u8 = torch.clamp(torch.floor(img * 255.0 + 0.5), 0, 255).to(torch.uint8)
        self.backgrounds[slot] = space_to_depth(img_u8, self.statics.s2d_block)

    def _apply_staged(self):
        with self._lock:
            staged, self._staged_knobs = self._staged_knobs, {}
        for slot, kw in staged.items():
            self.knobs.replace_stream(slot, **kw)

    # ---- the serving step ---------------------------------------------
    def process(self, frames: np.ndarray) -> dict:
        """One batch step: frames u8 ``[S, H, W, 3]`` (rows of inactive slots
        are processed too and ignored).  Returns ``frame`` (composited u8
        ``[S, H, W, 3]``), ``alpha`` (bf16 ``[S, mh, mw]``), ``metrics`` and
        the step's other outputs, as tensors on the engine's device."""
        t0 = time.perf_counter()
        self._apply_staged()
        want = (self.num_streams, *self.statics.frame_hw, 3)
        if tuple(np.shape(frames)) != want:
            raise ValueError(f"process: frames must be u8 {want}, got {np.shape(frames)}")
        frames_t = torch.as_tensor(np.asarray(frames, dtype=np.uint8), device=self.device)
        frames_p = space_to_depth(frames_t, self.statics.s2d_block).contiguous()
        t1 = time.perf_counter()
        try:
            new_state, out = self._step(self.state, frames_p, self.backgrounds, self.knobs)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        except BaseException as e:
            self.health.record_failure(e)
            raise
        self.health.record_success()
        self.state = new_state
        t2 = time.perf_counter()
        n_active = int(self.active.sum()) or self.num_streams
        self.counters.record_step(n_active, (t2 - t1) * 1e3, (t2 - t0) * 1e3)
        extras = {k: v for k, v in out.items()
                  if k not in ("frame", "alpha", "face_applied")}
        return {
            "frame": depth_to_space(out["frame"], self.statics.s2d_block),
            "alpha": out["alpha"],
            "metrics": self.stats(),
            **extras,
        }

    def stats(self) -> dict:
        """FPS / latency / thread-load counters + health."""
        return {**self.counters.snapshot(), "health": self.health.snapshot()}
