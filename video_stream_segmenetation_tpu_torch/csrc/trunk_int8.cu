// int8 pico/nano trunk for Hopper (sm_90a): the port of the Pallas
// megakernel video_stream_segmenetation_tpu/kernels/trunk_int8.py (body
// _kernel, pallas_call in _run) in its one-class form
// fused_nano_trunk_alpha_rowfold, its K-class form
// fused_nano_trunk_alpha_q / fused_nano_trunk_alpha and its u1-out form
// fused_nano_trunk (head=False: the same launches without the head).
//
// What bounds it on an H100: about 1.44 G multiply-adds a stream at the
// 720p pico shapes (x0 [72,128,128] s8; about 2.6 G at the nano widths
// 192/256; the head is 10.6 M of them a class), against 1.2 MB of input
// and 37 KB of output a class: as a whole it is bound by operations (int8
// peak 1979 TOP/s); launch by launch, the 1x1 convs, d2dn, ctx, the SE and
// the head move more bytes than their products take (chip_smoke.py prints
// each launch beside its own bound).
//
// Design: the TPU kernel keeps one stream's whole trunk in VMEM and folds
// quad parities into lanes; neither fits Hopper (227 KB of shared memory a
// block, blocks run in no order).  Here each layer is one launch over the
// whole batch, activations stay NHWC s8 in device memory between layers
// (L2 holds most of them), and:
//   * vst_conv_i8: an implicit-GEMM int8 convolution on the tensor cores
//     (M = output pixels of all streams, N = output channels, K = taps x
//     input channels, in the OHWI weights' own order).  A block computes
//     128 pixels x all Cout channels (64 to 256, so each A row is gathered
//     once), as two warpgroups of 64 rows, each issuing
//     wgmma.mma_async m64n64k32 .s32.s8.s8 (Cout / 64 of them a 32-byte K
//     slice) with both operands K-major in shared memory: the NHWC
//     activations' and the OHWI weights' own layout, which is the only one
//     int8 wgmma takes.  K advances 128 bytes a stage through a ring of 4
//     stages (3 for 128-channel tiles, two blocks of which share an SM),
//     each stage's A rows (16-byte cp.async gathers, zero filled for the
//     SAME padding, the K tail and ragged M) and B rows (16-byte cp.async)
//     stored in the 128-byte swizzle the wgmma descriptors name; the loads
//     of the next stages are in flight while a stage multiplies.  The s32
//     sums are exact.  The epilogue, on the accumulator fragments (staging
//     them through shared memory for wider stores measured slower), is the
//     reference's:
//     y = acc * mult + bias in f32 (built with --fmad=false, so no fused
//     multiply-add changes the rounding), then one of
//       mode 0: s8 = round(clip(up + y [+ res * 6/127], 0, 6) * 127/6),
//               with `up` an f32 addend (the up-path half of a split
//               decoder conv) at half resolution broadcast by nearest x2
//               (up_shift 1: u2red/u1red) or at the output's own
//               (up_shift 0: plan B's 3x3 u2/u1), or absent, and `res`
//               the s8 residual of plan B's b1 block, or absent,
//       mode 1: f32 y (the up-path convs),
//       mode 2: f32 clip(y + res * 6/127, 0, 6) (ctx + residual, relu6).
//     With in_shift 1 the input is read through a nearest x2 upsample:
//     the tensor is [S, H/2, W/2, Cin] and the conv runs on the H x W grid
//     (plan B's up-path 3x3 convs over nearest_x2 of the level below).
//   * vst_se_requant: one block a stream; the SE mean over the stream's
//     grid and both dense layers in double, sigmoid, gate, an optional
//     residual (res * 6/127, the micro trunk's _Block), requant to s8.
// The same kernels run the convolutions of the micro, light (plan C) and
// full (plan B) trunks (models/quantized.py), whose 1x1 decoder levels
// are csrc/decoder_int8.cu and whose routed 3x3 convs, with
// int8_conv_impl='pallas', are csrc/conv_int8.cu.
//   * vst_alpha_head_i8: the 3x3 int8 alpha head with K output channels
//     (1 <= K <= ALPHA_HEAD_MAX_K; the served presets use K = 1 and the
//     multi-class K = 4), one thread a (pixel, class), classes fastest so
//     a warp's neighbours read the same taps; f32 logits [S, H, W, K],
//     acc * mult[k] + bias[k].  This is the Pallas head's K-class form
//     (trunk_int8.py:_alpha_head_consts, quad columns qo*K + k), written
//     in the natural layout: no quad fold to undo.
// What the conv leaves on the table: each layer is still one launch with
// its activations in device memory, one output tile a block (no
// persistent blocks, no TMA, the epilogue not overlapped with the next
// tile's loads); the SE and the head are simple first kernels.  Fusing
// layers so that activations stay on chip is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define RELU6_SCALE (127.0f / 6.0f)
#define ACT_SCALE (6.0f / 127.0f)

#define ALPHA_HEAD_MAX_K 16

// the wgmma conv's tile: BM output pixels (two warpgroups of 64 rows), all
// Cout = 64 * NT channels, BK bytes of K a stage (one 128-byte swizzle row)
#define BM 128
#define BK 128
#define CONV_THREADS 256
#define A_BYTES (BM * BK)
// the ring's stages, and the blocks an SM holds, by the tile's width: a
// 128-channel tile (NT <= 2) keeps its accumulators in few enough
// registers (128) for two blocks an SM, so that one block's epilogue and
// loads overlap the other's products (3 stages, so that two fit)
template <int NT>
struct ConvShape {
  static constexpr int stages = NT <= 2 ? 3 : 4;
  static constexpr int blocks = NT <= 2 ? 2 : 1;
  static constexpr int stage_bytes = A_BYTES + 64 * NT * BK;
  // the dynamic shared memory at most (all stages), with 1 KB to align the
  // ring to 1024 bytes
  static constexpr int max_smem = stages * stage_bytes + 1024;
};

__device__ __forceinline__ int8_t requant(float y) {
  y = fminf(fmaxf(y, 0.0f), 6.0f);
  return (int8_t)(int)rintf(y * RELU6_SCALE);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
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

// D[64 x 64] (s32, 32 registers a thread) += A[64 x 32] . B[64 x 32]^T, s8
__device__ __forceinline__ void wgmma_m64n64k32(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]),
        "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
        "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]),
        "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma's fence and wait
__device__ __forceinline__ void fence_acc(int& r) { asm volatile("" : "+r"(r)::"memory"); }

template <int NT>
__global__ void __launch_bounds__(CONV_THREADS, ConvShape<NT>::blocks)
conv_i8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ mult, const float* __restrict__ bias,
               const int8_t* __restrict__ res, const float* __restrict__ up,
               void* __restrict__ out, int S, int H, int W, int Cin, int Ho,
               int Wo, int KH, int KW, int stride, int dil, int pad_t,
               int pad_l, int mode, int in_shift, int up_shift, int nk) {
  constexpr int N = 64 * NT;
  constexpr int STAGES = ConvShape<NT>::stages;
  constexpr int STAGE_BYTES = ConvShape<NT>::stage_bytes;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle is a function of the address: the ring starts 1024-aligned
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* ring = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t ring_u32 = smem_u32(ring);

  const int tid = threadIdx.x;
  const int K = KH * KW * Cin;
  const int HoWo = Ho * Wo;
  const long long M = (long long)S * HoWo;
  const long long m0 = (long long)blockIdx.x * BM;
  const int Hin = H >> in_shift, Win = W >> in_shift;  // the tensor's grid

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
    const uint32_t b_s = a_s + A_BYTES;
    const int k = ks * BK + 16 * j;  // this chunk's K offset
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
      const int8_t* src = k_ok ? w + (size_t)n * K + k : w;
      cp_async16(b_s + swz(n, j), src, k_ok);
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
    asm volatile("cp.async.commit_group;\n" ::);
  }
#pragma unroll 1
  for (int ks = 0; ks < nk; ++ks) {
    // stage ks has landed (at most STAGES - 2 later groups in flight), for
    // this thread; the fence hands the generic-proxy writes to the async
    // proxy the wgmma reads through, the barrier makes them every thread's
    // and tells that every warpgroup's wgmma on stage ks - 1 has finished
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
    asm volatile("fence.proxy.async.shared::cta;\n" ::);
    __syncthreads();
    const uint32_t a_s = ring_u32 + (uint32_t)((ks % STAGES) * STAGE_BYTES);
    const uint32_t b_s = a_s + A_BYTES;
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int v = 0; v < 32; ++v) fence_acc(acc[t][v]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      const uint64_t da = wgmma_desc(a_s + wg * (64 * BK) + 32 * kk);
#pragma unroll
      for (int t = 0; t < NT; ++t)
        wgmma_m64n64k32(acc[t], da, wgmma_desc(b_s + t * (64 * BK) + 32 * kk));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the next loads go to the stage that ks - 1 used, while this one runs
    if (ks + STAGES - 1 < nk) load_stage(ks + STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int v = 0; v < 32; ++v) fence_acc(acc[t][v]);
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

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
      up_row = up + (((size_t)s * hh + (oy >> up_shift)) * wh + (ox >> up_shift)) * N;
    }
    const size_t o = (size_t)m * N;
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int n = 64 * t + 8 * g + 2 * (lane & 3);
        const float2 mu = *reinterpret_cast<const float2*>(mult + n);
        const float2 bi = *reinterpret_cast<const float2*>(bias + n);
        float y0 = (float)acc[t][4 * g + 2 * h] * mu.x + bi.x;
        float y1 = (float)acc[t][4 * g + 2 * h + 1] * mu.y + bi.y;
        if (mode == 0) {
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

// SE over one stream's [P, C] f32 plane, then gate, add the residual
// (res * 6/127, where res is given) and requant to s8.
extern "C" __global__ void se_requant_kernel(
    const float* __restrict__ ctx, const float* __restrict__ k0,
    const float* __restrict__ b0, const float* __restrict__ k1,
    const float* __restrict__ b1, const int8_t* __restrict__ res,
    int8_t* __restrict__ out, int P, int C, int R) {
  extern __shared__ double sh[];
  double* mean = sh;      // [C]
  double* hid = sh + C;   // [R]
  float* gate = reinterpret_cast<float*>(sh + C + R);  // [C]
  const int s = blockIdx.x;
  const float* xs = ctx + (size_t)s * P * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    double acc = 0.0;
    for (int p = 0; p < P; ++p) acc += (double)xs[(size_t)p * C + c];
    mean[c] = acc / (double)P;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    double acc = 0.0;
    for (int c = 0; c < C; ++c) acc += mean[c] * (double)k0[(size_t)c * R + r];
    acc += (double)b0[r];
    hid[r] = acc > 0.0 ? acc : 0.0;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    double acc = 0.0;
    for (int r = 0; r < R; ++r) acc += hid[r] * (double)k1[(size_t)r * C + c];
    acc += (double)b1[c];
    gate[c] = (float)(1.0 / (1.0 + exp(-acc)));
  }
  __syncthreads();
  int8_t* os = out + (size_t)s * P * C;
  const int8_t* rs = res == nullptr ? nullptr : res + (size_t)s * P * C;
  for (int e = threadIdx.x; e < P * C; e += blockDim.x) {
    float y = xs[e] * gate[e % C];
    if (rs != nullptr) y = y + (float)rs[e] * ACT_SCALE;
    os[e] = requant(y);
  }
}

// 3x3 SAME int8 conv to K output channels (weights OHWI [K, 3, 3, Cin]):
// f32 logits [S, H, W, K], one thread an output element.
extern "C" __global__ void alpha_head_i8_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ mult, const float* __restrict__ bias,
    float* __restrict__ out, int S, int H, int W, int Cin, int K) {
  const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= (long long)S * H * W * K) return;
  const int k = (int)(m % K);
  const long long px = m / K;
  const int s = (int)(px / ((long long)H * W));
  const int rem = (int)(px % ((long long)H * W));
  const int oy = rem / W, ox = rem % W;
  int acc = 0;
  for (int r = 0; r < 3; ++r) {
    const int iy = oy + r - 1;
    if (iy < 0 || iy >= H) continue;
    for (int q = 0; q < 3; ++q) {
      const int ix = ox + q - 1;
      if (ix < 0 || ix >= W) continue;
      const int* xa = reinterpret_cast<const int*>(
          x + (((size_t)s * H + iy) * W + ix) * Cin);
      const int* wa = reinterpret_cast<const int*>(
          w + ((size_t)k * 9 + r * 3 + q) * Cin);
      for (int c = 0; c < Cin / 4; ++c) acc = __dp4a(__ldg(xa + c), __ldg(wa + c), acc);
    }
  }
  out[m] = (float)acc * mult[k] + bias[k];
}

template <int NT>
static int launch_conv(const void* x, const void* w, const void* mult,
                       const void* bias, const void* res, const void* up,
                       void* out, int S, int H, int W, int Cin, int Ho, int Wo,
                       int KH, int KW, int stride, int dil, int pad_t,
                       int pad_l, int mode, int in_shift, int up_shift,
                       cudaStream_t stream) {
  using C = ConvShape<NT>;
  const int nk = (KH * KW * Cin + BK - 1) / BK;
  const int stages = nk < C::stages ? nk : C::stages;  // the ring's stages in use
  const int smem = stages * C::stage_bytes + 1024;
  static bool sized = false;  // the opt-in above 48 KB, once a kernel
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        conv_i8_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::max_smem);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const long long M = (long long)S * Ho * Wo;
  conv_i8_kernel<NT><<<(unsigned)((M + BM - 1) / BM), CONV_THREADS, smem, stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const float*)mult, (const float*)bias,
      (const int8_t*)res, (const float*)up, out, S, H, W, Cin, Ho, Wo, KH, KW,
      stride, dil, pad_t, pad_l, mode, in_shift, up_shift, nk);
  return (int)cudaGetLastError();
}

// Cout a multiple of 64 up to 256, Cin a multiple of 16 (16-byte gathers)
extern "C" int vst_conv_i8(const void* x, const void* w, const void* mult,
                           const void* bias, const void* res, const void* up,
                           void* out, int S, int H, int W, int Cin, int Ho,
                           int Wo, int Cout, int KH, int KW, int stride,
                           int dil, int pad_t, int pad_l, int mode,
                           int in_shift, int up_shift, void* stream) {
  if (Cin % 16 || Cout % 64 || Cout < 64 || Cout > 256)
    return (int)cudaErrorInvalidValue;
#define CONV(NT)                                                               \
  launch_conv<NT>(x, w, mult, bias, res, up, out, S, H, W, Cin, Ho, Wo, KH, KW, \
                  stride, dil, pad_t, pad_l, mode, in_shift, up_shift,          \
                  (cudaStream_t)stream)
  switch (Cout / 64) {
    case 1: return CONV(1);
    case 2: return CONV(2);
    case 3: return CONV(3);
    default: return CONV(4);
  }
#undef CONV
}

extern "C" int vst_se_requant(const void* ctx, const void* k0, const void* b0,
                              const void* k1, const void* b1, const void* res,
                              void* out, int S, int P, int C, int R,
                              void* stream) {
  const size_t smem = (size_t)(C + R) * sizeof(double) + (size_t)C * sizeof(float);
  se_requant_kernel<<<S, 256, smem, (cudaStream_t)stream>>>(
      (const float*)ctx, (const float*)k0, (const float*)b0, (const float*)k1,
      (const float*)b1, (const int8_t*)res, (int8_t*)out, P, C, R);
  return (int)cudaGetLastError();
}

extern "C" int vst_alpha_head_i8(const void* x, const void* w,
                                 const void* mult, const void* bias, void* out,
                                 int S, int H, int W, int Cin, int K,
                                 void* stream) {
  if (K < 1 || K > ALPHA_HEAD_MAX_K || Cin % 4) return (int)cudaErrorInvalidValue;
  const long long M = (long long)S * H * W * K;
  alpha_head_i8_kernel<<<(unsigned)((M + 255) / 256), 256, 0,
                         (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const float*)mult,
      (const float*)bias, (float*)out, S, H, W, Cin, K);
  return (int)cudaGetLastError();
}
