// Fused int8 decoder level for Hopper (sm_90a): the port of the Pallas
// kernel video_stream_segmenetation_tpu/kernels/decoder_int8.py::
// fused_decoder_level (body _kernel, pallas_call in _run), i.e. the
// split 1x1 decoder conv of models/quantized.py::split_conv_up:
//
//   out = requant(nearest_x2(small @ Wa * mult + bias) + skip @ Wb * mult)
//
// small [S, sh, sw, Ca] s8, skip and out [S, 2sh, 2sw, Cb|Cout] s8, Wa
// [Cout, Ca] and Wb [Cout, Cb] s8 (the up-path and skip halves of the 1x1
// weights, output-channel major).  Sums are exact s32 (__dp4a); the f32
// epilogue runs in the reference's order: yaf = acc_a * mult + bias, then
// y = yaf + acc_b * mult, then round(clip(y, 0, 6) * 127/6) half-even.
// Built with --fmad=false, so no fused multiply-add changes a rounding.
//
// What bounds it on an H100: bytes.  At micro's u1 level (S=64, small
// [64,36,64,192], skip and out [64,72,128,128]) it moves 179 MB against
// 13.3 G multiply-adds; the u2 level 66 MB against 7.2 G: about 0.073 ms
// by bytes at 3.35 TB/s against 0.021 ms by int8 operations.
//
// Design: the TPU kernel holds one stream's level in VMEM and folds the
// column parity into lanes; that layout does not carry over.  Here a
// block takes 16 parent pixels (flattened over S, sh, sw) and 64 output
// channels.  Phase A stages each 32-channel K slice of the 16 small rows
// and of Wa in shared memory and accumulates acc_a (one parent, four
// channels a thread); phase B stages the 64 child skip pixels of those
// parents (4 a parent, in dy, dx order) and Wb, and accumulates acc_b
// (the thread's parent's 4 children x the same 4 channels).  So the
// epilogue needs no exchange: each thread owns yaf for its children.
// The fast form (wgmma s8 tiles, TMA staging) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define RELU6_SCALE (127.0f / 6.0f)
#define TP 16       // parent pixels a block
#define BN 64       // output channels a block
#define KW_WORDS 8  // 32 channels of K a stage, as 8 words of 4 s8
#define LDS 9       // padded row stride (words) of the shared tiles

static __device__ __forceinline__ int8_t requant_s8(float y) {
  y = fminf(fmaxf(y, 0.0f), 6.0f);
  return (int8_t)(int)rintf(y * RELU6_SCALE);
}

extern "C" __global__ void __launch_bounds__(256)
decoder_level_i8_kernel(const int8_t* __restrict__ small,
                        const int8_t* __restrict__ skip,
                        const int8_t* __restrict__ wa,
                        const int8_t* __restrict__ wb,
                        const float* __restrict__ mult,
                        const float* __restrict__ bias,
                        int8_t* __restrict__ out, int S, int sh, int sw,
                        int Ca, int Cb, int Cout) {
  __shared__ int As[4 * TP * LDS];
  __shared__ int Bs[BN * LDS];
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // channel lane: channels n0 + tx + 16 j
  const int ty = tid >> 4;  // parent lane: parent p0 + ty, children 4 ty + i
  const long long Mp = (long long)S * sh * sw;
  const long long p0 = (long long)blockIdx.x * TP;
  const int n0 = blockIdx.y * BN;
  const int bh = 2 * sh, bw = 2 * sw;

  // the two skip words and two weight words this thread stages a K step
  long long skip_off[2];
  int row[2], word[2];
  for (int t = 0; t < 2; ++t) {
    const int idx = tid + t * 256;
    row[t] = idx >> 3;  // child (phase B) or output channel (weights)
    word[t] = idx & 7;
    const long long p = p0 + (row[t] >> 2);
    skip_off[t] = -1;
    if (p < Mp) {
      const int s = (int)(p / ((long long)sh * sw));
      const int rem = (int)(p % ((long long)sh * sw));
      const int y = 2 * (rem / sw) + ((row[t] >> 1) & 1);
      const int x = 2 * (rem % sw) + (row[t] & 1);
      skip_off[t] = (((long long)s * bh + y) * bw + x) * Cb + 4 * word[t];
    }
  }

  // ---- phase A: acc_a[j] = small[p0 + ty] . Wa[n0 + tx + 16 j]
  int acc_a[4] = {0, 0, 0, 0};
  for (int c0 = 0; c0 < Ca; c0 += 4 * KW_WORDS) {
    if (tid < TP * KW_WORDS) {
      const long long p = p0 + (tid >> 3);
      As[(tid >> 3) * LDS + (tid & 7)] =
          p < Mp ? __ldg(reinterpret_cast<const int*>(
                       small + p * Ca + c0 + 4 * (tid & 7)))
                 : 0;
    }
    for (int t = 0; t < 2; ++t) {
      const int n = n0 + row[t];
      Bs[row[t] * LDS + word[t]] =
          n < Cout ? __ldg(reinterpret_cast<const int*>(
                         wa + (size_t)n * Ca + c0 + 4 * word[t]))
                   : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < KW_WORDS; ++kw) {
      const int a = As[ty * LDS + kw];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc_a[j] = __dp4a(a, Bs[(tx + 16 * j) * LDS + kw], acc_a[j]);
    }
    __syncthreads();
  }

  // ---- phase B: acc_b[i][j] = skip[child 4 ty + i] . Wb[n0 + tx + 16 j]
  int acc_b[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) acc_b[i][j] = 0;
  for (int c0 = 0; c0 < Cb; c0 += 4 * KW_WORDS) {
    for (int t = 0; t < 2; ++t) {
      As[row[t] * LDS + word[t]] =
          skip_off[t] >= 0
              ? __ldg(reinterpret_cast<const int*>(skip + skip_off[t] + c0))
              : 0;
      const int n = n0 + row[t];
      Bs[row[t] * LDS + word[t]] =
          n < Cout ? __ldg(reinterpret_cast<const int*>(
                         wb + (size_t)n * Cb + c0 + 4 * word[t]))
                   : 0;
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
        for (int j = 0; j < 4; ++j) acc_b[i][j] = __dp4a(a[i], b[j], acc_b[i][j]);
    }
    __syncthreads();
  }

  // ---- epilogue: the thread's parent, its 4 children, 4 channels
  const long long p = p0 + ty;
  if (p >= Mp) return;
  const int s = (int)(p / ((long long)sh * sw));
  const int rem = (int)(p % ((long long)sh * sw));
  const int py = rem / sw, px = rem % sw;
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx + 16 * j;
    if (n >= Cout) continue;
    const float m = mult[n];
    const float yaf = (float)acc_a[j] * m + bias[n];
    for (int i = 0; i < 4; ++i) {
      const int y = 2 * py + (i >> 1), x = 2 * px + (i & 1);
      const float v = yaf + (float)acc_b[i][j] * m;
      out[(((size_t)s * bh + y) * bw + x) * Cout + n] = requant_s8(v);
    }
  }
}

extern "C" int vst_decoder_level_i8(const void* small, const void* skip,
                                    const void* wa, const void* wb,
                                    const void* mult, const void* bias,
                                    void* out, int S, int sh, int sw, int Ca,
                                    int Cb, int Cout, void* stream) {
  const long long Mp = (long long)S * sh * sw;
  dim3 grid((unsigned)((Mp + TP - 1) / TP), (unsigned)((Cout + BN - 1) / BN));
  decoder_level_i8_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const int8_t*)small, (const int8_t*)skip, (const int8_t*)wa,
      (const int8_t*)wb, (const float*)mult, (const float*)bias,
      (int8_t*)out, S, sh, sw, Ca, Cb, Cout);
  return (int)cudaGetLastError();
}
