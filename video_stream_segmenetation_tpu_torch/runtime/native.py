"""ctypes binding to the native frame-ingestion library (port of the
reference's ``runtime/native.py``, over the same C++ source,
``native/framebuf.cpp``).

FramePool: one lock-free ring a stream, batch assembly into a ring of
buffers (natural ``[S, H, W, 3]`` or space-to-depth packed
``[S, H/b, W/b, b*b*3]``), the guide's tap lanes emitted while it packs,
and YUV420 -> RGB, all in C++.  Batches and lanes come out as zero-copy
numpy views into the ring.

The library is compiled from the repository's source with the host C++
compiler (``c++`` or ``g++`` on ``PATH``) at first use, into ``build/`` at
the repository root; its file name carries a hash of the source, the
compiler and the flags, so a changed source is rebuilt.  Nothing prebuilt
is loaded and ``make`` is not called.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "framebuf.cpp"
BUILD_DIR = _REPO / "build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-pthread")

_lock = threading.Lock()
_lib = None


def find_cxx() -> str:
    """Path of the host C++ compiler; raises naming what was looked for."""
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler: neither c++ nor g++ is on PATH")


def build() -> Path:
    """Compile ``native/framebuf.cpp`` unless the current library exists;
    returns its path."""
    cxx = find_cxx()
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join((cxx,) + CXX_FLAGS).encode())
    lib_path = BUILD_DIR / f"libvstio-{h.hexdigest()[:16]}.so"
    if lib_path.is_file():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / lib_path.name
        run = subprocess.run([cxx, *CXX_FLAGS, "-o", str(out), str(SOURCE)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if run.returncode != 0:
            raise RuntimeError(f"{cxx} failed on {SOURCE.name} (exit {run.returncode}):\n"
                               f"{run.stdout}")
        os.replace(out, lib_path)
    return lib_path


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        P, I, U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64
        CP, U8P = ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8)
        sigs = {
            "vst_pool_create_s2d": (P, [I, I, I, I]),
            "vst_pool_destroy": (None, [P]),
            "vst_pool_set_depth": (I, [P, I]),
            "vst_push_rgb": (U64, [P, I, CP]),
            "vst_push_i420": (U64, [P, I, CP, CP, CP, I, I]),
            "vst_assemble_batch": (U8P, [P, ctypes.POINTER(U64)]),
            "vst_assemble_range": (U8P, [P, I, I, ctypes.POINTER(U64)]),
            "vst_pool_enable_lanes": (I, [P, ctypes.POINTER(ctypes.c_int32), I]),
            "vst_lanes_ptr": (U8P, [P]),
            "vst_stream_drops": (U64, [P, I]),
            "vst_rgb_to_i420": (None, [CP, I, I, CP, CP, CP]),
            "vst_s2d_rgb_to_i420": (None, [CP, I, I, I, CP, CP, CP]),
        }
        for name, (res, args) in sigs.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _lib = lib
        return lib


def native_available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _load()
        return True
    except Exception:
        return False


def _planes(h: int, w: int):
    return (np.empty((h, w), np.uint8), np.empty((h // 2, w // 2), np.uint8),
            np.empty((h // 2, w // 2), np.uint8))


def _cp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_char_p)


def rgb_to_i420(frame: np.ndarray):
    """u8 ``[H, W, 3]`` -> (Y ``[H, W]``, U, V ``[H/2, W/2]``), BT.601: the
    encoder hand-off."""
    lib = _load()
    h, w, _ = frame.shape
    frame = np.ascontiguousarray(frame, np.uint8)
    y, u, v = _planes(h, w)
    lib.vst_rgb_to_i420(_cp(frame), w, h, _cp(y), _cp(u), _cp(v))
    return y, u, v


def s2d_rgb_to_i420(packed: np.ndarray, frame_hw, block: int):
    """A packed composite ``[H/b, W/b, b*b*3]`` u8 -> I420 planes, unpacked
    inside the encode pass."""
    lib = _load()
    h, w = frame_hw
    packed = np.ascontiguousarray(packed, np.uint8)
    y, u, v = _planes(h, w)
    lib.vst_s2d_rgb_to_i420(_cp(packed), w, h, block, _cp(y), _cp(u), _cp(v))
    return y, u, v


class FramePool:
    """Host-side frame staging for S streams of HxW RGB frames."""

    def __init__(self, num_streams: int, height: int, width: int,
                 s2d_block: int = 0, guide_lanes=None, depth: int = 2):
        """``s2d_block=b > 0``: batches come out packed ``[S, H/b, W/b,
        b*b*3]`` (patch order (dy, dx, c)), the pack taking the place of the
        assembly copy.

        ``depth``: the size of the ring of assembly buffers.  A view that
        :meth:`assemble` or :meth:`assemble_range` returns (and the matching
        :meth:`lanes`) stays valid for ``depth - 1`` further assembles: 2
        is double buffering; a fused-round scheduler that assembles G
        groups before one dispatch and collects a round late needs ``2*G``.

        ``guide_lanes``: the per-patch tap offsets (ops/layout.py::
        guide_s2d_sel); each assemble then also fills the raw guide lanes
        ``[nl, rows, H/b, W/b]`` u8 while it packs (read by :meth:`lanes`),
        so the card never re-reads the frames for the guide."""
        self._lib = _load()
        self.num_streams = num_streams
        self.height = height
        self.width = width
        self.s2d_block = s2d_block
        if s2d_block and (height % s2d_block or width % s2d_block):
            raise ValueError("s2d_block must divide height and width")
        self._pool = self._lib.vst_pool_create_s2d(num_streams, height, width, s2d_block)
        if not self._pool:
            raise RuntimeError("vst_pool_create_s2d failed")
        if depth != 2 and self._lib.vst_pool_set_depth(self._pool, int(depth)) != 0:
            raise ValueError(f"bad pool depth {depth}")
        self.depth = depth
        self._ids = (ctypes.c_uint64 * num_streams)()
        self.num_lanes = 0
        self._last_rows = num_streams
        if guide_lanes is not None:
            if not s2d_block:
                raise ValueError("guide_lanes requires s2d_block > 0")
            sel = np.ascontiguousarray(guide_lanes, np.int32)
            rc = self._lib.vst_pool_enable_lanes(
                self._pool, sel.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(sel))
            if rc != 0:
                raise ValueError("vst_pool_enable_lanes rejected the taps")
            self.num_lanes = len(sel)

    def close(self) -> None:
        if self._pool:
            self._lib.vst_pool_destroy(self._pool)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def push_rgb(self, stream: int, frame: np.ndarray) -> int:
        """frame: u8 ``[H, W, 3]``.  Returns the frame id."""
        if frame.shape != (self.height, self.width, 3) or frame.dtype != np.uint8:
            raise ValueError(f"expected uint8 [{self.height},{self.width},3]")
        frame = np.ascontiguousarray(frame)
        return self._lib.vst_push_rgb(self._pool, stream, _cp(frame))

    def push_i420(self, stream: int, y: np.ndarray, u: np.ndarray, v: np.ndarray) -> int:
        """Planar YUV420 planes (u8), converted to RGB here (BT.601)."""
        y, u, v = (np.ascontiguousarray(p, np.uint8) for p in (y, u, v))
        return self._lib.vst_push_i420(self._pool, stream, _cp(y), _cp(u), _cp(v),
                                       y.shape[1], u.shape[1])

    def _view(self, ptr, rows: int) -> np.ndarray:
        buf = np.ctypeslib.as_array(ptr, shape=(rows * self.height * self.width * 3,))
        if self.s2d_block:
            b = self.s2d_block
            return buf.reshape(rows, self.height // b, self.width // b, b * b * 3)
        return buf.reshape(rows, self.height, self.width, 3)

    def assemble(self) -> tuple[np.ndarray, np.ndarray]:
        """The freshest frame of every stream: (batch, frame_ids), batch a
        zero-copy u8 view into the ring, valid for ``depth - 1`` further
        assembles; frame_ids the capture ids (0 where a stream has sent
        nothing yet, its row zeroed)."""
        ptr = self._lib.vst_assemble_batch(self._pool, self._ids)
        self._last_rows = self.num_streams
        return self._view(ptr, self.num_streams), np.asarray(self._ids, np.uint64).copy()

    def assemble_range(self, begin: int, end: int) -> tuple[np.ndarray, np.ndarray]:
        """Only streams ``[begin, end)``: (batch ``[end-begin, ...]``,
        frame_ids ``[end-begin]``)."""
        if not (0 <= begin < end <= self.num_streams):
            raise ValueError(f"bad range [{begin}, {end})")
        g = end - begin
        ptr = self._lib.vst_assemble_range(self._pool, begin, end, self._ids)
        self._last_rows = g
        return self._view(ptr, g), np.asarray(self._ids[:g], np.uint64).copy()

    def lanes(self) -> np.ndarray:
        """The guide lanes of the last assembled batch: a zero-copy u8 view
        ``[nl, rows, H/b, W/b]`` into the same ring, valid as long as the
        batch is."""
        if not self.num_lanes:
            raise RuntimeError("pool created without guide_lanes")
        ptr = self._lib.vst_lanes_ptr(self._pool)
        b = self.s2d_block
        hp, wp = self.height // b, self.width // b
        n = self.num_lanes * self._last_rows * hp * wp
        return np.ctypeslib.as_array(ptr, shape=(n,)).reshape(
            self.num_lanes, self._last_rows, hp, wp)

    def drops(self, stream: int) -> int:
        """Frames overwritten before they were ever batched (backpressure)."""
        return int(self._lib.vst_stream_drops(self._pool, stream))
