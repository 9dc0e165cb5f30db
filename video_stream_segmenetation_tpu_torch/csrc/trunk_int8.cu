// int8 pico/nano trunk for Hopper (sm_90a): the port of the Pallas
// megakernel video_stream_segmenetation_tpu/kernels/trunk_int8.py::
// fused_nano_trunk_alpha_rowfold (body _kernel, pallas_call in _run).
//
// What bounds it on an H100: about 1.44 G multiply-adds a stream at the
// 720p pico shapes (x0 [72,128,128] s8), against 1.2 MB of input and
// 37 KB of output: it is bound by operations (int8 peak 1979 TOP/s),
// never by bytes.
//
// Design: the TPU kernel keeps one stream's whole trunk in VMEM and folds
// quad parities into lanes; neither fits Hopper (227 KB of shared memory a
// block, blocks run in no order).  Here each layer is one launch over the
// whole batch, activations stay NHWC s8 in device memory between layers
// (L2 holds most of them), and:
//   * vst_conv_i8: a direct int8 convolution (implicit GEMM, M = output
//     pixels, N = output channels, K = taps x input channels).  A block
//     computes 64 pixels x 64 channels; 32-channel K slices of activations
//     and weights are staged in shared memory as 32-bit words and reduced
//     with __dp4a (s8 x s8 -> s32, exact).  The epilogue is the reference's:
//     y = acc * mult + bias in f32 (built with --fmad=false, so no fused
//     multiply-add changes the rounding), then one of
//       mode 0: s8 = round(clip(up + y, 0, 6) * 127/6), with `up` the f32
//               up-path conv at half resolution broadcast by nearest x2
//               (the split 1x1 convs of u2red/u1red) or absent,
//       mode 1: f32 y (the up-path 1x1 convs),
//       mode 2: f32 clip(y + res * 6/127, 0, 6) (ctx + residual, relu6).
//   * vst_se_requant: one block a stream; the SE mean over the 18x32 grid
//     and both dense layers in double, sigmoid, gate, requant to s8.
//   * vst_alpha_head_i8: the 3x3 int8 alpha head (one output channel),
//     one thread a pixel, f32 logits.
// The fast form (wgmma s8 tiles, layers fused so activations stay on
// chip) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define RELU6_SCALE (127.0f / 6.0f)
#define ACT_SCALE (6.0f / 127.0f)

#define BM 64
#define BN 64
#define KW_WORDS 8  // 32 channels of K per stage, as 8 words of 4 s8
#define LDS 9       // padded row stride (words) of the shared tiles

__device__ __forceinline__ int8_t requant(float y) {
  y = fminf(fmaxf(y, 0.0f), 6.0f);
  return (int8_t)(int)rintf(y * RELU6_SCALE);
}

extern "C" __global__ void __launch_bounds__(256)
conv_i8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ mult, const float* __restrict__ bias,
               const int8_t* __restrict__ res, const float* __restrict__ up,
               void* __restrict__ out, int S, int H, int W, int Cin, int Ho,
               int Wo, int Cout, int KH, int KW, int stride, int dil,
               int pad_t, int pad_l, int mode) {
  __shared__ int As[BM * LDS];
  __shared__ int Bs[BN * LDS];
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // channel lane: channels n0 + tx + 16 j
  const int ty = tid >> 4;  // pixel lane: pixels m0 + 4 ty + i
  const long long M = (long long)S * Ho * Wo;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int taps = KH * KW;

  // the two A words and two B words this thread stages each K step
  int a_pix[2], a_word[2], a_s[2], a_oy[2], a_ox[2];
  bool a_ok[2];
  for (int t = 0; t < 2; ++t) {
    int idx = tid + t * 256;
    a_pix[t] = idx >> 3;
    a_word[t] = idx & 7;
    long long m = m0 + a_pix[t];
    a_ok[t] = m < M;
    long long mm = a_ok[t] ? m : 0;
    a_s[t] = (int)(mm / ((long long)Ho * Wo));
    int rem = (int)(mm % ((long long)Ho * Wo));
    a_oy[t] = rem / Wo;
    a_ox[t] = rem % Wo;
  }

  int acc[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int tap = 0; tap < taps; ++tap) {
    const int r = tap / KW, q = tap % KW;
    for (int c0 = 0; c0 < Cin; c0 += 4 * KW_WORDS) {
      for (int t = 0; t < 2; ++t) {
        int v = 0;
        const int iy = a_oy[t] * stride - pad_t + r * dil;
        const int ix = a_ox[t] * stride - pad_l + q * dil;
        if (a_ok[t] && iy >= 0 && iy < H && ix >= 0 && ix < W) {
          const size_t off =
              (((size_t)a_s[t] * H + iy) * W + ix) * Cin + c0 + 4 * a_word[t];
          v = __ldg(reinterpret_cast<const int*>(x + off));
        }
        As[a_pix[t] * LDS + a_word[t]] = v;
        const int ch = a_pix[t], n = n0 + ch;
        int u = 0;
        if (n < Cout) {
          const size_t off =
              ((size_t)n * taps + tap) * Cin + c0 + 4 * a_word[t];
          u = __ldg(reinterpret_cast<const int*>(w + off));
        }
        Bs[ch * LDS + a_word[t]] = u;
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
    const int s = (int)(m / ((long long)Ho * Wo));
    const int rem = (int)(m % ((long long)Ho * Wo));
    const int oy = rem / Wo, ox = rem % Wo;
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= Cout) continue;
      float y = (float)acc[i][j] * mult[n] + bias[n];
      const size_t o = (size_t)m * Cout + n;
      if (mode == 0) {
        if (up != nullptr) {
          const int hh = Ho >> 1, wh = Wo >> 1;
          const size_t u =
              (((size_t)s * hh + (oy >> 1)) * wh + (ox >> 1)) * Cout + n;
          y = up[u] + y;
        }
        reinterpret_cast<int8_t*>(out)[o] = requant(y);
      } else if (mode == 1) {
        reinterpret_cast<float*>(out)[o] = y;
      } else {
        y = y + (float)res[o] * ACT_SCALE;
        reinterpret_cast<float*>(out)[o] = fminf(fmaxf(y, 0.0f), 6.0f);
      }
    }
  }
}

// SE over one stream's [P, C] f32 plane, then gate and requant to s8.
extern "C" __global__ void se_requant_kernel(
    const float* __restrict__ ctx, const float* __restrict__ k0,
    const float* __restrict__ b0, const float* __restrict__ k1,
    const float* __restrict__ b1, int8_t* __restrict__ out, int P, int C,
    int R) {
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
  for (int e = threadIdx.x; e < P * C; e += blockDim.x)
    os[e] = requant(xs[e] * gate[e % C]);
}

// 3x3 SAME int8 conv to one output channel: f32 logits [S, H, W].
extern "C" __global__ void alpha_head_i8_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ mult, const float* __restrict__ bias,
    float* __restrict__ out, int S, int H, int W, int Cin) {
  const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= (long long)S * H * W) return;
  const int s = (int)(m / ((long long)H * W));
  const int rem = (int)(m % ((long long)H * W));
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
      const int* wa = reinterpret_cast<const int*>(w + (size_t)(r * 3 + q) * Cin);
      for (int k = 0; k < Cin / 4; ++k) acc = __dp4a(__ldg(xa + k), __ldg(wa + k), acc);
    }
  }
  out[m] = (float)acc * mult[0] + bias[0];
}

extern "C" int vst_conv_i8(const void* x, const void* w, const void* mult,
                           const void* bias, const void* res, const void* up,
                           void* out, int S, int H, int W, int Cin, int Ho,
                           int Wo, int Cout, int KH, int KW, int stride,
                           int dil, int pad_t, int pad_l, int mode,
                           void* stream) {
  const long long M = (long long)S * Ho * Wo;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Cout + BN - 1) / BN));
  conv_i8_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const float*)mult,
      (const float*)bias, (const int8_t*)res, (const float*)up, out, S, H, W,
      Cin, Ho, Wo, Cout, KH, KW, stride, dil, pad_t, pad_l, mode);
  return (int)cudaGetLastError();
}

extern "C" int vst_se_requant(const void* ctx, const void* k0, const void* b0,
                              const void* k1, const void* b1, void* out,
                              int S, int P, int C, int R, void* stream) {
  const size_t smem = (size_t)(C + R) * sizeof(double) + (size_t)C * sizeof(float);
  se_requant_kernel<<<S, 256, smem, (cudaStream_t)stream>>>(
      (const float*)ctx, (const float*)k0, (const float*)b0, (const float*)k1,
      (const float*)b1, (int8_t*)out, P, C, R);
  return (int)cudaGetLastError();
}

extern "C" int vst_alpha_head_i8(const void* x, const void* w,
                                 const void* mult, const void* bias, void* out,
                                 int S, int H, int W, int Cin, void* stream) {
  const long long M = (long long)S * H * W;
  alpha_head_i8_kernel<<<(unsigned)((M + 255) / 256), 256, 0,
                         (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const float*)mult,
      (const float*)bias, (float*)out, S, H, W, Cin);
  return (int)cudaGetLastError();
}
