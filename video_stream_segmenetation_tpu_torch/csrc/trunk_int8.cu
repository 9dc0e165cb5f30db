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
//   * vst_conv_i8: the implicit-GEMM int8 convolution on the tensor cores
//     of csrc/wgmma_i8.cuh (conv_i8_kernel, its trunk instantiations: Cout
//     64 to 256 in one N tile), in its modes 0-2: the s8 requant with an
//     optional f32 addend (the up-path half of a split decoder conv, at
//     the output's grid or at half of it: u2red/u1red, plan B's 3x3
//     u2/u1) and an optional s8 residual (plan B's b1 block), the f32
//     output of the up-path convs, and ctx + residual with relu6 in f32;
//     the input optionally read through a nearest x2 upsample (plan B's
//     up-path 3x3 convs over nearest_x2 of the level below).
//   * vst_se_requant: one block a stream; the SE mean over the stream's
//     grid and both dense layers in double, sigmoid, gate, an optional
//     residual (res * 6/127, the micro trunk's _Block), requant to s8.
// The same kernels run the convolutions of the micro, light (plan C) and
// full (plan B) trunks (models/quantized.py); their 1x1 decoder levels are
// csrc/decoder_int8.cu (both products of a level in one wgmma kernel) and
// their routed 3x3 convs, with int8_conv_impl='pallas', csrc/conv_int8.cu
// (the same conv tile, routed instantiations).
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
// tile's loads).  The SE (f64) and the head (__dp4a) still run on the
// CUDA cores: 0.13 and 0.70 ms of the pico trunk's 1.55 at S=64 on an
// H100 (PERF.md section 6).  Fusing layers so that activations stay on
// chip is later work.

#include "wgmma_i8.cuh"

#define ALPHA_HEAD_MAX_K 16

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

// Cout a multiple of 64 up to 256, Cin a multiple of 16 (16-byte gathers),
// modes 0-2 (mode 3 is conv3x3_i8_fused's); 0 or the CUDA error
extern "C" int vst_conv_i8(const void* x, const void* w, const void* mult,
                           const void* bias, const void* res, const void* up,
                           void* out, int S, int H, int W, int Cin, int Ho,
                           int Wo, int Cout, int KH, int KW, int stride,
                           int dil, int pad_t, int pad_l, int mode,
                           int in_shift, int up_shift, void* stream) {
  if (Cin % 16 || Cout % 64 || Cout < 64 || Cout > 256 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
#define CONV(NT)                                                                 \
  launch_conv<NT, false>(x, w, mult, bias, res, up, out, S, H, W, Cin, Ho, Wo,    \
                         Cout, KH, KW, stride, dil, pad_t, pad_l, mode, in_shift, \
                         up_shift, (cudaStream_t)stream)
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
