"""The torch port's kernel build (kernels/_build.py) without a compiler:
nvcc lookup, the -Xptxas -v report parser, and the ctypes signatures
against the C entry points in csrc/."""

import os
import re

import pytest

from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu_torch.kernels import _build

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function 'conv_i8_kernel' for 'sm_90a'
ptxas info    : Function properties for conv_i8_kernel
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 4608 bytes smem, 472 bytes cmem[0]
ptxas info    : Compiling entry function 'alpha_head_i8_kernel' for 'sm_90a'
ptxas info    : Function properties for alpha_head_i8_kernel
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 408 bytes cmem[0]
"""


def test_parse_ptxas_report():
    got = _build.parse_ptxas(PTXAS_LOG)
    assert got["conv_i8_kernel"] == {"registers": 64, "smem": 4608,
                                     "spill_stores": 8, "spill_loads": 4}
    assert got["alpha_head_i8_kernel"] == {"registers": 40, "smem": 0,
                                           "spill_stores": 0, "spill_loads": 0}


def test_find_nvcc_names_every_place_looked(monkeypatch, tmp_path):
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has /usr/local/cuda/bin/nvcc")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError) as err:
        _build.find_nvcc()
    msg = str(err.value)
    assert "PATH" in msg and "CUDA_HOME" in msg and "/usr/local/cuda/bin/nvcc" in msg


def test_find_nvcc_under_cuda_home(monkeypatch, tmp_path):
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\n")
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert _build.find_nvcc() == str(nvcc)


def _c_entry_points():
    """name -> number of parameters of each ``extern "C" int vst_*`` in csrc/."""
    found = {}
    for src in _build.sources():
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (vst_\w+)\(([^)]*)\)', text):
            found[m.group(1)] = len([a for a in m.group(2).split(",") if a.strip()])
    return found


def test_ctypes_signatures_match_the_c_sources():
    """Each binding declares as many arguments as its C function takes, and
    pointers (void*) are bound as c_void_p: a pointer passed as a 32-bit
    int would be cut."""
    c = _c_entry_points()
    assert set(_build.SIGNATURES) == set(c)
    for name, argtypes in _build.SIGNATURES.items():
        assert len(argtypes) == c[name], name
    for src in _build.sources():
        for m in re.finditer(r'extern "C" int (vst_\w+)\(([^)]*)\)', src.read_text()):
            args = [a.strip() for a in m.group(2).split(",")]
            types = _build.SIGNATURES[m.group(1)]
            for a, t in zip(args, types):
                assert ("*" in a) == (t is _build.ctypes.c_void_p), (m.group(1), a)


def test_build_flags_target_hopper_without_fma():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "--fmad=false" in flags
    assert {p.name for p in _build.sources()} >= {"trunk_int8.cu", "refine_fused.cu"}
