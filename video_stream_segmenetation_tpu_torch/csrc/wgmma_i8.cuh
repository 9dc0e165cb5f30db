// The int8 tensor-core building blocks for Hopper (sm_90a) that the
// port's int8 kernels share, and the implicit-GEMM convolution tile they
// run on: csrc/trunk_int8.cu (every conv of the int8 trunks) and
// csrc/conv_int8.cu (the routed 3x3 convs of int8_conv_impl='pallas')
// launch conv_i8_kernel; csrc/decoder_int8.cu builds its two-product
// decoder level from the same helpers.
//
// Operands are s8, K-major in shared memory (the only layout int8 wgmma
// takes: NHWC activations and OHWI weights as they lie), in rows of 128
// bytes under the 128-byte swizzle (16-byte chunk j of row r at chunk
// j XOR r mod 8, the tile 1024-aligned); the descriptors name 8-row core
// groups 1024 bytes apart and advance 32 bytes a k32 slice.  Loads are
// 16-byte cp.async, zero filled where a row or a chunk is out of range,
// in flight while earlier stages multiply.  Sums are exact s32; every
// epilogue is f32 built with --fmad=false, so no fused multiply-add
// changes a rounding.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define RELU6_SCALE (127.0f / 6.0f)
#define ACT_SCALE (6.0f / 127.0f)

// relu6, then onto the 6/127 lattice, round half to even
__device__ __forceinline__ int8_t requant(float y) {
  y = fminf(fmaxf(y, 0.0f), 6.0f);
  return (int8_t)(int)rintf(y * RELU6_SCALE);
}

// the linear output onto the lattice, clipped to [-127, 127] (no act)
__device__ __forceinline__ int8_t requant_linear(float y) {
  return (int8_t)(int)fminf(fmaxf(rintf(y * RELU6_SCALE), -127.0f), 127.0f);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the first 1024-aligned shared address at or after p's
__device__ __forceinline__ uint32_t align1024(const void* p) {
  const uint32_t raw = smem_u32(p);
  return raw + ((1024 - (raw & 1023)) & 1023);
}

// 16 bytes global -> shared, in flight until cp.async.wait_group; with ok
// false nothing is read and the 16 bytes are zero
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}

// byte offset of 16-byte chunk j of row r in a tile of 128-byte rows under
// the 128-byte swizzle (chunk index XOR row mod 8; the tile 1024-aligned)
__device__ __forceinline__ uint32_t swz(int r, int j) {
  return (uint32_t)(r * 128 + ((j ^ (r & 7)) << 4));
}

// wgmma shared-memory descriptor of a K-major operand in the 128-byte
// swizzle: 8-row core groups 1024 bytes apart (stride byte offset), the
// leading byte offset unused (1), layout type 1 (128B swizzle)
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D[64 x 64] (s32, 32 registers a thread) += A[64 x 32] . B[64 x 32]^T, s8,
// both from shared memory.  Register v of D holds row 16 warp + lane/4 +
// 8 ((v/2) % 2), column 8 (v/4) + 2 (lane%4) + v%2 (warp within the
// warpgroup).
__device__ __forceinline__ void wgmma_m64n64k32(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma's fence and wait
__device__ __forceinline__ void fence_acc(int& r) { asm volatile("" : "+r"(r)::"memory"); }

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the generic-proxy writes of cp.async become visible to wgmma's async
// proxy (then a barrier makes them every thread's)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// ---- the implicit-GEMM convolution tile -----------------------------------
//
// M = output pixels of all streams, N = output channels, K = taps x input
// channels in the OHWI weights' own order.  A block computes 128 pixels x
// N = 64 NT channels (each A row is gathered once for all N), as two
// warpgroups of 64 rows, each issuing wgmma m64n64k32 (NT of them a
// 32-byte K slice).  K advances 128 bytes a stage through a ring of 4
// stages (3 for 128-channel tiles, two blocks of which share an SM): each
// stage's A rows (16-byte cp.async gathers, zero filled for the SAME
// padding, the K tail and ragged M) and B rows land in the swizzle while
// earlier stages multiply.  The epilogue works on the accumulator
// fragments (staging them through shared memory for wider stores measured
// slower): y = acc * mult + bias in f32, then one of
//   mode 0: s8 = requant(up + y [+ res * 6/127]), with `up` an f32 addend
//           at half the output's grid broadcast nearest x2 (up_shift 1) or
//           at its own (up_shift 0), or absent, and `res` an s8 residual
//           or absent,
//   mode 1: f32 y,
//   mode 2: f32 clip(y + res * 6/127, 0, 6),
//   mode 3 (ROUTED only): s8 = requant_linear(y [+ res * 6/127]), the
//           no-act form of conv3x3_i8_fused.
// With in_shift 1 the input is read through a nearest x2 upsample (the
// tensor is [S, H/2, W/2, Cin], the conv runs on the H x W grid).
//
// ROUTED (the routed 3x3 convs of csrc/conv_int8.cu) adds what the trunk's
// layers never need: Cout need not be N (missing weight rows zero filled,
// stores masked; the output's row stride is Cout) and blockIdx.y walks N
// tiles for Cout above 256, and mode 3.  The trunk's instantiations
// (ROUTED false) compile to the code without those.

#define CONV_BM 128
#define CONV_BK 128
#define CONV_THREADS 256
#define CONV_A_BYTES (CONV_BM * CONV_BK)

// the ring's stages, and the blocks an SM holds, by the tile's width: a
// 128-channel tile (NT <= 2) keeps its accumulators in few enough
// registers (128) for two blocks an SM, so that one block's epilogue and
// loads overlap the other's products (3 stages, so that two fit)
template <int NT>
struct ConvShape {
  static constexpr int stages = NT <= 2 ? 3 : 4;
  static constexpr int blocks = NT <= 2 ? 2 : 1;
  static constexpr int stage_bytes = CONV_A_BYTES + 64 * NT * CONV_BK;
  // the dynamic shared memory at most (all stages), with 1 KB to align the
  // ring to 1024 bytes
  static constexpr int max_smem = stages * stage_bytes + 1024;
};

template <int NT, bool ROUTED>
__global__ void __launch_bounds__(CONV_THREADS, ConvShape<NT>::blocks)
conv_i8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ mult, const float* __restrict__ bias,
               const int8_t* __restrict__ res, const float* __restrict__ up,
               void* __restrict__ out, int S, int H, int W, int Cin, int Ho,
               int Wo, int KH, int KW, int stride, int dil, int pad_t,
               int pad_l, int mode, int in_shift, int up_shift, int nk,
               int Cout) {
  constexpr int N = 64 * NT;
  constexpr int STAGES = ConvShape<NT>::stages;
  constexpr int STAGE_BYTES = ConvShape<NT>::stage_bytes;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle is a function of the address: the ring starts 1024-aligned
  const uint32_t ring_u32 = align1024(smem_raw);

  const int tid = threadIdx.x;
  const int K = KH * KW * Cin;
  const int HoWo = Ho * Wo;
  const long long M = (long long)S * HoWo;
  const long long m0 = (long long)blockIdx.x * CONV_BM;
  const int Hin = H >> in_shift, Win = W >> in_shift;  // the tensor's grid
  // this block's first output channel, and the output's row stride
  const int n0 = ROUTED ? (int)blockIdx.y * N : 0;
  const int ldo = ROUTED ? Cout : N;

  // the loads: this thread's 16-byte chunk j of rows tid/8 + 32 i (A: 4
  // rows of the 128; B: 2 NT rows of the N)
  const int j = tid & 7, r0 = tid >> 3;
  int a_iy[4], a_ix[4];
  const int8_t* a_px[4];
  bool a_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + r0 + 32 * i;
    a_ok[i] = m < M;
    const long long mm = a_ok[i] ? m : 0;
    const int s = (int)(mm / HoWo), rem = (int)(mm - (long long)s * HoWo);
    const int oy = rem / Wo, ox = rem - (rem / Wo) * Wo;
    a_iy[i] = oy * stride - pad_t;
    a_ix[i] = ox * stride - pad_l;
    a_px[i] = x + (size_t)s * Hin * Win * Cin;
  }

  auto load_stage = [&](int ks) {
    const uint32_t a_s = ring_u32 + (uint32_t)((ks % STAGES) * STAGE_BYTES);
    const uint32_t b_s = a_s + CONV_A_BYTES;
    const int k = ks * CONV_BK + 16 * j;  // this chunk's K offset
    const bool k_ok = k < K;
    const int tap = k_ok ? k / Cin : 0;
    const int c = k - tap * Cin;
    const int r = tap / KW, q = tap - (tap / KW) * KW;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int iy = a_iy[i] + r * dil, ix = a_ix[i] + q * dil;
      const bool ok = k_ok && a_ok[i] && iy >= 0 && iy < H && ix >= 0 && ix < W;
      const int8_t* src =
          ok ? a_px[i] + ((size_t)(iy >> in_shift) * Win + (ix >> in_shift)) * Cin + c : x;
      cp_async16(a_s + swz(r0 + 32 * i, j), src, ok);
    }
#pragma unroll
    for (int i = 0; i < 2 * NT; ++i) {
      const int n = r0 + 32 * i;
      const bool ok = k_ok && (!ROUTED || n0 + n < Cout);
      const int8_t* src = ok ? w + (size_t)(n0 + n) * K + k : w;
      cp_async16(b_s + swz(n, j), src, ok);
    }
  };

  int acc[NT][32];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int v = 0; v < 32; ++v) acc[t][v] = 0;

  const int wg = tid >> 7;  // this warpgroup's 64 rows of the tile
#pragma unroll 1
  for (int ks = 0; ks < STAGES - 1; ++ks) {
    if (ks < nk) load_stage(ks);
    cp_async_commit();
  }
#pragma unroll 1
  for (int ks = 0; ks < nk; ++ks) {
    // stage ks has landed (at most STAGES - 2 later groups in flight), for
    // this thread; the fence hands the generic-proxy writes to the async
    // proxy the wgmma reads through, the barrier makes them every thread's
    // and tells that every warpgroup's wgmma on stage ks - 1 has finished
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();
    const uint32_t a_s = ring_u32 + (uint32_t)((ks % STAGES) * STAGE_BYTES);
    const uint32_t b_s = a_s + CONV_A_BYTES;
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int v = 0; v < 32; ++v) fence_acc(acc[t][v]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < CONV_BK / 32; ++kk) {
      const uint64_t da = wgmma_desc(a_s + wg * (64 * CONV_BK) + 32 * kk);
#pragma unroll
      for (int t = 0; t < NT; ++t)
        wgmma_m64n64k32(acc[t], da, wgmma_desc(b_s + t * (64 * CONV_BK) + 32 * kk));
    }
    wgmma_commit();
    // the next loads go to the stage that ks - 1 used, while this one runs
    if (ks + STAGES - 1 < nk) load_stage(ks + STAGES - 1);
    cp_async_commit();
    wgmma_wait_all();
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int v = 0; v < 32; ++v) fence_acc(acc[t][v]);
  }
  cp_async_wait<0>();

  // the epilogue on the fragments: register v of n-tile t holds row
  // 16 warp + lane/4 + 8 ((v/2) % 2), column 64 t + 8 (v/4) + 2 (lane%4) + v%2
  const int lane = tid & 31, warp = (tid >> 5) & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long m = m0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * h;
    if (m >= M) continue;
    const int s = (int)(m / HoWo), rem = (int)(m - (long long)s * HoWo);
    const int oy = rem / Wo, ox = rem - (rem / Wo) * Wo;
    const float* up_row = nullptr;
    if (up != nullptr) {
      const int hh = Ho >> up_shift, wh = Wo >> up_shift;
      up_row = up + (((size_t)s * hh + (oy >> up_shift)) * wh + (ox >> up_shift)) * ldo;
    }
    const size_t o = (size_t)m * ldo;
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int n = n0 + 64 * t + 8 * g + 2 * (lane & 3);
        // Cout a multiple of 4: n < Cout holds for n + 1 too
        if (ROUTED && n >= Cout) continue;
        const float2 mu = *reinterpret_cast<const float2*>(mult + n);
        const float2 bi = *reinterpret_cast<const float2*>(bias + n);
        float y0 = (float)acc[t][4 * g + 2 * h] * mu.x + bi.x;
        float y1 = (float)acc[t][4 * g + 2 * h + 1] * mu.y + bi.y;
        if (ROUTED && mode == 3) {
          if (res != nullptr) {
            const char2 rv = *reinterpret_cast<const char2*>(res + o + n);
            y0 = y0 + (float)rv.x * ACT_SCALE;
            y1 = y1 + (float)rv.y * ACT_SCALE;
          }
          *reinterpret_cast<char2*>(reinterpret_cast<int8_t*>(out) + o + n) =
              make_char2(requant_linear(y0), requant_linear(y1));
        } else if (mode == 0) {
          if (up_row != nullptr) {
            const float2 u = *reinterpret_cast<const float2*>(up_row + n);
            y0 = u.x + y0;
            y1 = u.y + y1;
          }
          if (res != nullptr) {
            const char2 rv = *reinterpret_cast<const char2*>(res + o + n);
            y0 = y0 + (float)rv.x * ACT_SCALE;
            y1 = y1 + (float)rv.y * ACT_SCALE;
          }
          *reinterpret_cast<char2*>(reinterpret_cast<int8_t*>(out) + o + n) =
              make_char2(requant(y0), requant(y1));
        } else {
          if (mode == 2) {
            const char2 rv = *reinterpret_cast<const char2*>(res + o + n);
            y0 = fminf(fmaxf(y0 + (float)rv.x * ACT_SCALE, 0.0f), 6.0f);
            y1 = fminf(fmaxf(y1 + (float)rv.y * ACT_SCALE, 0.0f), 6.0f);
          }
          *reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + o + n) =
              make_float2(y0, y1);
        }
      }
  }
}

// Once-a-device state of the launchers of this header's includers.
constexpr int VST_MAX_DEVICES = 64;

// The current device (below VST_MAX_DEVICES) and its SMs (looked up once a
// device; sms may be null); 0 or the CUDA error.
static inline int current_device(int* dev, int* sms) {
  static int cached[VST_MAX_DEVICES] = {};
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  if (*dev < 0 || *dev >= VST_MAX_DEVICES) return (int)cudaErrorInvalidValue;
  if (sms == nullptr) return 0;
  if (cached[*dev] == 0 &&
      (err = cudaDeviceGetAttribute(&cached[*dev], cudaDevAttrMultiProcessorCount, *dev)) !=
          cudaSuccess)
    return (int)err;
  *sms = cached[*dev];
  return 0;
}

// The opt-in of `kernel` above 48 KB of dynamic shared memory, once on
// device dev (an attribute of the function in that device's context;
// `sized` is the caller's flags for this kernel); 0 or the CUDA error.
template <typename Kernel>
static int opt_in_smem(Kernel kernel, int max_smem, bool (&sized)[VST_MAX_DEVICES], int dev) {
  if (sized[dev]) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (err != cudaSuccess) return (int)err;
  sized[dev] = true;
  return 0;
}

// One launch of the tile over S x Ho x Wo output pixels and, with ROUTED,
// ceil(Cout / N) tiles of N channels; 0 or the CUDA error.
template <int NT, bool ROUTED>
static int launch_conv(const void* x, const void* w, const void* mult,
                       const void* bias, const void* res, const void* up,
                       void* out, int S, int H, int W, int Cin, int Ho, int Wo,
                       int Cout, int KH, int KW, int stride, int dil, int pad_t,
                       int pad_l, int mode, int in_shift, int up_shift,
                       cudaStream_t stream) {
  using C = ConvShape<NT>;
  const int nk = (KH * KW * Cin + CONV_BK - 1) / CONV_BK;
  const int stages = nk < C::stages ? nk : C::stages;  // the ring's stages in use
  const int smem = stages * C::stage_bytes + 1024;
  static bool sized[VST_MAX_DEVICES] = {};
  int dev = 0;
  int err = current_device(&dev, nullptr);
  if (err == 0) err = opt_in_smem(conv_i8_kernel<NT, ROUTED>, C::max_smem, sized, dev);
  if (err != 0) return err;
  const long long M = (long long)S * Ho * Wo;
  const int n_tiles = ROUTED ? (Cout + 64 * NT - 1) / (64 * NT) : 1;
  const dim3 grid((unsigned)((M + CONV_BM - 1) / CONV_BM), (unsigned)n_tiles);
  conv_i8_kernel<NT, ROUTED><<<grid, CONV_THREADS, smem, stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const float*)mult, (const float*)bias,
      (const int8_t*)res, (const float*)up, out, S, H, W, Cin, Ho, Wo, KH, KW,
      stride, dil, pad_t, pad_l, mode, in_shift, up_shift, nk, Cout);
  return (int)cudaGetLastError();
}

// The trunk's conv entry point, defined in csrc/trunk_int8.cu and launched
// by csrc/conv_int8.cu too.  Declared here once, so that the definition
// is compiled against the same prototype its other caller uses.
extern "C" int vst_conv_i8(const void* x, const void* w, const void* mult,
                           const void* bias, const void* res, const void* up,
                           void* out, int S, int H, int W, int Cin, int Ho,
                           int Wo, int Cout, int KH, int KW, int stride,
                           int dil, int pad_t, int pad_l, int mode,
                           int in_shift, int up_shift, void* stream);
