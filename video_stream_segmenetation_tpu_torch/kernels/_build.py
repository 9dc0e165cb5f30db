"""Build and load the package's CUDA kernels.

Every ``*.cu`` under the package's ``csrc/`` is compiled with ``nvcc`` for
``sm_90a`` (one ``nvcc`` process for each source, all started together;
the ``*.cuh`` headers beside them are included, not compiled alone),
linked into one shared library with a plain C interface, and loaded with
``ctypes``.  PyTorch's extension builder is not used: a source that
includes PyTorch's headers takes minutes to compile, these take seconds.

The library goes to ``build/`` at the repository root at first use and is
rebuilt when a source, a header or a flag changes (its file name carries
their hash).
``nvcc`` is looked for on ``PATH``, then under ``$CUDA_HOME/bin``, then at
``/usr/local/cuda/bin/nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no fused multiply-add: every epilogue rounds as the plain version does
    "--fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argument types (every one returns a cudaError_t)
SIGNATURES = {
    "vst_conv_i8": [_P] * 7 + [_I] * 16 + [_P],
    "vst_conv3x3_i8_fused": [_P] * 6 + [_I] * 7 + [_P],
    "vst_se_requant": [_P] * 7 + [_I] * 4 + [_P],
    "vst_alpha_head_i8": [_P] * 5 + [_I] * 5 + [_P],
    "vst_temporal_refine": [_P] * 11 + [_I] * 10 + [_P],
    "vst_refine": [_P] * 5 + [_I] * 3 + [_P],
    "vst_composite": [_P, _P, ctypes.c_longlong] + [_P] * 6 + [_I] * 5 + [_P],
    "vst_decoder_level_i8": [_P] * 7 + [_I] * 6 + [_P],
    "vst_stochastic_round_bf16": [_P, _P, ctypes.c_longlong, ctypes.c_uint, _I, _P],
}

_lock = threading.Lock()
_lib = None


def find_nvcc() -> str:
    """Path of ``nvcc``; raises naming every place looked in."""
    looked = []
    found = shutil.which("nvcc")
    if found:
        return found
    looked.append("PATH")
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home:
        cand = Path(cuda_home) / "bin" / "nvcc"
        if cand.is_file():
            return str(cand)
    looked.append(f"$CUDA_HOME/bin ({cuda_home or 'unset'})")
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.is_file():
        return str(cand)
    looked.append(str(cand))
    raise RuntimeError("nvcc not found; looked in: " + ", ".join(looked))


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    """The headers the sources include (``csrc/*.cuh``)."""
    return sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def parse_ptxas(log: str) -> dict:
    """Registers, shared memory and spill bytes of each kernel, from the
    ``-Xptxas -v`` report."""
    out: dict = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {"registers": None, "smem": 0,
                                              "spill_stores": 0, "spill_loads": 0})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                cur["smem"] = int(m.group(1))
    return out


def build() -> dict:
    """Compile and link the library unless the current one exists.  Returns
    ``{"path", "seconds", "built", "nvcc", "kernels"}``; ``kernels`` is
    :func:`parse_ptxas` of the compile that made the library."""
    tag = _digest()
    lib_path = BUILD_DIR / f"libvst_kernels-{tag}.so"
    log_path = BUILD_DIR / f"libvst_kernels-{tag}.ptxas.txt"
    if lib_path.is_file() and log_path.is_file():
        return {"path": str(lib_path), "seconds": 0.0, "built": False,
                "nvcc": None, "kernels": parse_ptxas(log_path.read_text())}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        # nvcc's own scratch files stay inside the build directory too
        env = {**os.environ, "TMPDIR": tmp}
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)))
        logs, failed = [], []
        for src, _, p in procs:
            out, _ = p.communicate()
            logs.append(out)
            if p.returncode != 0:
                failed.append(f"{src.name} (exit {p.returncode}):\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib), *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {link.returncode}):\n{link.stdout}")
        log = "\n".join(logs)
        (Path(tmp) / log_path.name).write_text(log)
        os.replace(Path(tmp) / log_path.name, log_path)
        os.replace(tmp_lib, lib_path)
    return {"path": str(lib_path), "seconds": time.perf_counter() - t0,
            "built": True, "nvcc": nvcc, "kernels": parse_ptxas(log)}


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use in this process)."""
    global _lib
    with _lock:
        if _lib is None:
            info = build()
            lib = ctypes.CDLL(info["path"])
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.vst_error_string.argtypes = [ctypes.c_int]
            lib.vst_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = lib.vst_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
