// int8 fused 3x3 convolution for Hopper (sm_90a): the port of the Pallas
// kernel video_stream_segmenetation_tpu/kernels/conv_int8.py::
// conv3x3_i8_fused (body _kernel, pallas_call at line 116).
//
// It computes, for x s8 [S, H, W, Cin] (6/127-lattice activations) and
// weights s8 HWIO [3, 3, Cin, Cout], a 3x3 SAME convolution at stride 1
// and dilation d with exact s32 sums, then per output element
//   y = acc * mult[n] + bias[n]           (f32; built with --fmad=false)
//   y = y + res * 6/127                   (with a residual, s8 [S, H, W, Cout])
//   act:    s8 = rint(clip(y, 0, 6) * 127/6)
//   no act: s8 = clip(rint(y * 127/6), -127, 127)
// exactly as the Pallas kernel's epilogue (conv_int8.py:62-74).
//
// What bounds it on an H100: operations.  At the plan B layers it serves
// (S = 64, 720p): b1's first conv 72x128, 128 -> 128 channels, is 86.9 G
// multiply-adds (0.088 ms at the int8 peak of 1979 TOP/s) against 75.5 MB
// in and 75.5 MB out (0.045 ms at 3.35 TB/s); the d2b, d3b and ctx2 convs
// have the same ratio or a higher one.
//
// Design: the TPU kernel keeps one stream's padded plane in VMEM and runs
// nine tap matmuls.  Here it is the implicit GEMM of csrc/trunk_int8.cu's
// conv_i8_kernel (M = output pixels, N = output channels, K = taps x input
// channels): a block computes 64 pixels x 64 channels, 32-channel K slices
// of activations and weights are staged in shared memory as 32-bit words
// and reduced with __dp4a (s8 x s8 -> s32, exact).  The SAME padding is a
// bounds test on the staged loads (no padded copy).  The weights are read
// in the reference's HWIO layout: each thread loads four output channels
// of one input channel as one word and scatters its bytes into the
// [channel][K] tile the __dp4a reads.  wgmma s8 tiles are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define RELU6_SCALE (127.0f / 6.0f)
#define ACT_SCALE (6.0f / 127.0f)

#define BM 64
#define BN 64
#define KW_WORDS 8  // 32 channels of K per stage, as 8 words of 4 s8
#define LDS 9       // padded row stride (words) of the shared tiles

extern "C" __global__ void __launch_bounds__(256)
conv3x3_i8_fused_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                        const float* __restrict__ mult, const float* __restrict__ bias,
                        const int8_t* __restrict__ res, int8_t* __restrict__ out,
                        int S, int H, int W, int Cin, int Cout, int dil, int act) {
  __shared__ int As[BM * LDS];
  __shared__ int Bs[BN * LDS];
  int8_t* Bb = reinterpret_cast<int8_t*>(Bs);
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // channel lane: channels n0 + tx + 16 j
  const int ty = tid >> 4;  // pixel lane: pixels m0 + 4 ty + i
  const long long HW = (long long)H * W;
  const long long M = (long long)S * HW;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // the two activation words this thread stages each K step
  int a_pix[2], a_word[2], a_s[2], a_oy[2], a_ox[2];
  bool a_ok[2];
  for (int t = 0; t < 2; ++t) {
    const int idx = tid + t * 256;
    a_pix[t] = idx >> 3;
    a_word[t] = idx & 7;
    const long long m = m0 + a_pix[t];
    a_ok[t] = m < M;
    const long long mm = a_ok[t] ? m : 0;
    a_s[t] = (int)(mm / HW);
    const int rem = (int)(mm % HW);
    a_oy[t] = rem / W;
    a_ox[t] = rem % W;
  }

  int acc[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int tap = 0; tap < 9; ++tap) {
    const int r = tap / 3, q = tap % 3;
    for (int c0 = 0; c0 < Cin; c0 += 4 * KW_WORDS) {
      for (int t = 0; t < 2; ++t) {
        int v = 0;
        const int iy = a_oy[t] + (r - 1) * dil;
        const int ix = a_ox[t] + (q - 1) * dil;
        if (a_ok[t] && iy >= 0 && iy < H && ix >= 0 && ix < W) {
          const size_t off =
              (((size_t)a_s[t] * H + iy) * W + ix) * Cin + c0 + 4 * a_word[t];
          v = __ldg(reinterpret_cast<const int*>(x + off));
        }
        As[a_pix[t] * LDS + a_word[t]] = v;
        // weights: input channel c0 + ci, output channels n0 + 4 cw .. + 3
        const int idx = tid + t * 256;
        const int ci = idx >> 4, cw = idx & 15, n = n0 + 4 * cw;
        int u = 0;
        if (n < Cout) {
          const size_t off = ((size_t)tap * Cin + c0 + ci) * Cout + n;
          u = __ldg(reinterpret_cast<const int*>(w + off));
        }
#pragma unroll
        for (int b = 0; b < 4; ++b)
          Bb[(4 * cw + b) * (4 * LDS) + ci] = (int8_t)(u >> (8 * b));
      }
      __syncthreads();
#pragma unroll
      for (int kw = 0; kw < KW_WORDS; ++kw) {
        int a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[(ty * 4 + i) * LDS + kw];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[(tx + 16 * j) * LDS + kw];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= M) continue;
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= Cout) continue;
      const size_t o = (size_t)m * Cout + n;
      float y = (float)acc[i][j] * mult[n] + bias[n];
      if (res != nullptr) y = y + (float)res[o] * ACT_SCALE;
      float qv;
      if (act) {
        qv = rintf(fminf(fmaxf(y, 0.0f), 6.0f) * RELU6_SCALE);
      } else {
        qv = fminf(fmaxf(rintf(y * RELU6_SCALE), -127.0f), 127.0f);
      }
      out[o] = (int8_t)(int)qv;
    }
  }
}

extern "C" int vst_conv3x3_i8_fused(const void* x, const void* w, const void* mult,
                                    const void* bias, const void* res, void* out,
                                    int S, int H, int W, int Cin, int Cout, int dil,
                                    int act, void* stream) {
  if (Cin % (4 * KW_WORDS) || Cout % 4 || dil < 1) return (int)cudaErrorInvalidValue;
  const long long M = (long long)S * H * W;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Cout + BN - 1) / BN));
  conv3x3_i8_fused_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const float*)mult, (const float*)bias,
      (const int8_t*)res, (int8_t*)out, S, H, W, Cin, Cout, dil, act);
  return (int)cudaGetLastError();
}
