// Stochastic rounding f32 -> bf16 for Hopper (sm_90a): the port of the
// Pallas kernel video_stream_segmenetation_tpu/utils/quantize.py::
// stochastic_round_bf16 (pallas_call :91, inner kernel :80).  The TPU kernel
// draws 32 bits an element from the TPU's own generator and hands them to
// pltpu.stochastic_round; those bits cannot be reproduced off the TPU, so
// the contract is the distribution: each value rounds to one of its two
// bf16 neighbours, up with the probability of its distance from the lower
// one, in units of the gap (unbiased).
//
// The generator: counter-based Philox4x32-10 (Salmon et al., SC'11; the
// Random123 constants), written here, no library.  The key is (seed, 0);
// element i takes word i % 4 of the draw at counter (i / 4 mod 2^32,
// i / 4 >> 32, 0, 0).  The rounding: add the word's low 16 bits to the f32
// bit pattern and keep the top 16 bits.  The pattern is sign-magnitude, so
// the carry raises the magnitude for either sign; subnormals round the same
// way (their bits are evenly spaced too), and nothing here is float
// arithmetic, so nothing flushes them.  Special values:
//   NaN  -> a quiet NaN of the same sign (top 16 bits, quiet bit set): the
//           addition could carry a payload into the sign bit, and
//           truncating a NaN whose payload sits in the low 16 bits would
//           give inf;
//   +-inf -> unchanged (the low 16 bits are 0 and the carry never reaches
//           the exponent);
//   finite values above bf16's largest finite value (0x7f7f) round to inf
//           with the probability that the addition gives (their low 16
//           bits over 2^16): the choice of the rounding rule itself, kept
//           rather than saturating, so that the mean stays x.
// The plain PyTorch version (kernels/stochastic_round.py) runs the same
// integer operations; the two are equal bit for bit.
//
// What bounds it on an H100: it reads 4 bytes and writes 2 an element, and
// a Philox draw (10 rounds of two 32-bit multiplies and a few xors, about
// 30 integer operations an element) is well under the card's integer rate
// for that: bound by bytes (6 B an element at 3.35 TB/s).
//
// Design: one thread a group of four elements (one draw), a grid-stride
// loop, 16-byte loads and 8-byte stores where the pointers allow them
// (`vec`), one element at a time otherwise and at the ragged end.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define MAX_BLOCKS (132 * 16)

#define PHILOX_M0 0xD2511F53u
#define PHILOX_M1 0xCD9E8D57u
#define PHILOX_W0 0x9E3779B9u
#define PHILOX_W1 0xBB67AE85u

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0,
                                              uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += PHILOX_W0;
      k1 += PHILOX_W1;
    }
    const uint32_t hi0 = __umulhi(PHILOX_M0, c[0]), lo0 = PHILOX_M0 * c[0];
    const uint32_t hi1 = __umulhi(PHILOX_M1, c[2]), lo1 = PHILOX_M1 * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0, n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

__device__ __forceinline__ uint32_t round_bits(uint32_t b, uint32_t r) {
  if ((b & 0x7FFFFFFFu) > 0x7F800000u) return (b >> 16) | 0x40u;  // NaN
  return (b + (r & 0xFFFFu)) >> 16;
}

// x [n] f32 -> out [n] bf16 bits.  vec: x is 16-byte and out 8-byte aligned.
extern "C" __global__ void __launch_bounds__(THREADS)
stochastic_round_kernel(const float* __restrict__ x, uint16_t* __restrict__ out,
                        long long n, uint32_t seed, int vec) {
  const long long groups = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    uint32_t c[4] = {(uint32_t)g, (uint32_t)(g >> 32), 0u, 0u};
    philox4x32_10(c, seed, 0u);
    const long long i = 4 * g;
    if (vec && i + 4 <= n) {
      const float4 v = reinterpret_cast<const float4*>(x)[g];
      const uint32_t o0 = round_bits(__float_as_uint(v.x), c[0]);
      const uint32_t o1 = round_bits(__float_as_uint(v.y), c[1]);
      const uint32_t o2 = round_bits(__float_as_uint(v.z), c[2]);
      const uint32_t o3 = round_bits(__float_as_uint(v.w), c[3]);
      reinterpret_cast<uint2*>(out)[g] = make_uint2(o0 | (o1 << 16), o2 | (o3 << 16));
    } else {
      for (int j = 0; j < 4 && i + j < n; ++j)
        out[i + j] = (uint16_t)round_bits(__float_as_uint(x[i + j]), c[j]);
    }
  }
}

extern "C" int vst_stochastic_round_bf16(const void* x, void* out, long long n,
                                         unsigned int seed, int vec,
                                         void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const long long groups = (n + 3) / 4;
  long long blocks = (groups + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  stochastic_round_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (uint16_t*)out, n, (uint32_t)seed, vec);
  return (int)cudaGetLastError();
}
