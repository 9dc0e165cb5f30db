"""Stochastic rounding f32 -> bf16 as one CUDA kernel
(``csrc/stochastic_round.cu``), beside its plain PyTorch version.

Replaces the Pallas kernel ``video_stream_segmenetation_tpu/utils/
quantize.py::stochastic_round_bf16`` (pallas_call at line 91, inner
``kernel`` at line 80), which rounds with the TPU's own random bits.  Those
cannot be matched, so both versions here draw from a counter-based
Philox4x32-10 keyed by ``(seed, 0)``: element ``i`` takes word ``i % 4`` of
the draw at counter ``(i // 4, 0, 0, 0)``, adds the word's low 16 bits to
its f32 bit pattern and keeps the top 16 bits (NaN -> a quiet NaN of the
same sign; +-inf unchanged; values above bf16's largest finite value round
to inf with the probability the addition gives).  The source's header has
the reasoning and the design.

Bound on an H100: bytes (4 read and 2 written an element).  One call is one
launch and counts once in ``stochastic_round_bf16.launches``.
"""

from __future__ import annotations

import torch

from video_stream_segmenetation_tpu_torch.kernels import _build

MASK32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
PHILOX_ROUNDS = 10


def _mulhilo(m: int, c: torch.Tensor):
    """High and low 32-bit words of ``m * c`` (``c`` int64 holding u32
    values), exact in int64: ``m`` split into 16-bit halves keeps every
    partial product below 2^49."""
    lo_part = c * (m & 0xFFFF)
    mid = c * (m >> 16) + (lo_part >> 16)
    return mid >> 16, ((mid & 0xFFFF) << 16) | (lo_part & 0xFFFF)


def philox4x32_10(counter: torch.Tensor, key: tuple[int, int]) -> torch.Tensor:
    """Philox4x32-10 of ``counter [..., 4]`` (int64 holding u32 words) under
    ``key`` (two u32) -> ``[..., 4]`` int64 words."""
    c0, c1, c2, c3 = counter.unbind(-1)
    k0, k1 = key[0] & MASK32, key[1] & MASK32
    for r in range(PHILOX_ROUNDS):
        if r:
            k0, k1 = (k0 + PHILOX_W[0]) & MASK32, (k1 + PHILOX_W[1]) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], dim=-1)


def random_words(n: int, seed: int, device) -> torch.Tensor:
    """The 32-bit word each of ``n`` elements draws: ``[n]`` int64."""
    groups = -(-n // 4)
    g = torch.arange(groups, dtype=torch.int64, device=device)
    counter = torch.stack([g & MASK32, g >> 32, torch.zeros_like(g), torch.zeros_like(g)], -1)
    return philox4x32_10(counter, (seed, 0)).reshape(-1)[:n]


def stochastic_round_bf16_plain(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Plain PyTorch version: the kernel's integer operations on int64."""
    x = x.to(torch.float32).contiguous()
    bits = x.reshape(-1).view(torch.int32).to(torch.int64) & MASK32
    rounded = (bits + (random_words(bits.numel(), seed, x.device) & 0xFFFF)) >> 16
    nan = (bits & 0x7FFFFFFF) > 0x7F800000
    out = torch.where(nan, (bits >> 16) | 0x40, rounded)
    # u16 -> the int16 of the same bits, viewed as bf16
    out = ((out + 0x8000) & 0xFFFF) - 0x8000
    return out.to(torch.int16).view(torch.bfloat16).reshape(x.shape)


def stochastic_round_bf16(x, seed: int = 0) -> torch.Tensor:
    """``x`` (a tensor or an array of any shape; cast to f32 first, as the
    reference does) -> bf16 of the same shape, rounded stochastically with
    ``seed``.  CPU tensors take the plain version, so that unlike the
    reference, which rounds to nearest off the TPU, the CPU rounds
    stochastically too; CUDA tensors launch the kernel or raise."""
    x = torch.as_tensor(x).to(torch.float32)
    if x.device.type == "cpu":
        return stochastic_round_bf16_plain(x, seed)
    x = x.contiguous()
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    vec = int(x.data_ptr() % 16 == 0 and out.data_ptr() % 8 == 0)
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(lib, lib.vst_stochastic_round_bf16(
        x.data_ptr(), out.data_ptr(), x.numel(), seed & MASK32, vec, stream),
        "stochastic_round_bf16")
    stochastic_round_bf16.launches += 1
    return out


stochastic_round_bf16.launches = 0
