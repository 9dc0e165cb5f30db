// Fused composite for Hopper (sm_90a): the port of the Pallas kernel
// video_stream_segmenetation_tpu/kernels/composite_fused.py::fused_composite
// (pallas_call :84, _composite_kernel :46).  Per stream: the mask-resolution
// alpha upsampled to the frame with the bilinear taps of the upsample method
// (half-pixel, asymmetric or align-corners: the wrapper hands them in as
// tables, so the kernel is the same for all three), clipped to [0, 1], then
// out = frame * a + bg * (1 - a) in u8 units, rounded half up.
//
// What it computes, not its layout.  The TPU kernel runs the horizontal pass
// as one product with a dense [mw, 3W] matrix whose RGB columns are
// interleaved, so that the result lands on the u8 pixel lanes; that
// triples the multiply-adds and is a lane answer.  Every output row and
// column has at most two taps (ops/resize.py::_interp_matrix), and zeros
// add exactly, so here each row value is the two-tap sum of the alpha rows
// in f64 (both products exact, one rounding, so no order of summation can
// change it, whatever the f32 weights -- not exact in bf16 at the
// asymmetric and align-corners taps; then rounded to f32), rounded to bf16
// as the TPU kernel's operand is, and each pixel the two-tap sum of the bf16
// row values with bf16 weights (exact products, one f32 rounding), as the
// reference's bf16 product with f32 accumulation gives it.
//
// What bounds it on an H100: it reads the frame, the background (u8) and
// the alpha (f32) and writes the output (u8) once -- about 8.9 MB a
// 720p stream, against a few flops a byte: bound by bytes (3.35 TB/s).
//
// Design: one block a (stream, output row).  It computes the row's mw
// values in shared memory, then the row's W upsampled alpha values, then
// blends the row's W*3 bytes, 16 bytes a thread where the rows are
// 16-byte aligned, else a byte a thread.  Built with --fmad=false so
// the blend rounds as the plain PyTorch version does.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define THREADS 256

__device__ __forceinline__ uint8_t blend(uint8_t f, uint8_t b, float a,
                                         float one_minus_a) {
  const float o = (float)f * a + (float)b * one_minus_a;
  return (uint8_t)fminf(fmaxf(floorf(o + 0.5f), 0.0f), 255.0f);
}

// frames, bg: [S, H, W, 3] u8 (bg's stream stride in bytes: 0 broadcasts
// one background); alpha [S, mh, mw] f32; vy [H, 2] int32 source rows and
// vw [H, 2] f32 weights; hx [W, 2] int32 source columns and hw [W, 2]
// weights already rounded to bf16; out [S, H, W, 3] u8.  Scratch: the row
// values [mw] and the upsampled alpha [W], dynamic shared memory.
extern "C" __global__ void __launch_bounds__(THREADS)
composite_kernel(const uint8_t* __restrict__ frames,
                 const uint8_t* __restrict__ bg, long long bg_stride,
                 const float* __restrict__ alpha, const int* __restrict__ vy,
                 const float* __restrict__ vw, const int* __restrict__ hx,
                 const float* __restrict__ hw, uint8_t* __restrict__ out,
                 int H, int W, int mh, int mw) {
  extern __shared__ float smem[];
  float* row = smem;       // [mw]
  float* up = smem + mw;   // [W]
  const int y = blockIdx.x, s = blockIdx.y;
  const float* a_s = alpha + (size_t)s * mh * mw;
  const float* r0 = a_s + (size_t)vy[2 * y] * mw;
  const float* r1 = a_s + (size_t)vy[2 * y + 1] * mw;
  const double w0 = (double)vw[2 * y], w1 = (double)vw[2 * y + 1];
  for (int j = threadIdx.x; j < mw; j += blockDim.x) {
    const float r = (float)(w0 * (double)r0[j] + w1 * (double)r1[j]);
    row[j] = __bfloat162float(__float2bfloat16_rn(r));
  }
  __syncthreads();
  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    const float v = row[hx[2 * x]] * hw[2 * x] + row[hx[2 * x + 1]] * hw[2 * x + 1];
    up[x] = fminf(fmaxf(v, 0.0f), 1.0f);
  }
  __syncthreads();
  const int nb = W * 3;
  const size_t off = ((size_t)s * H + y) * nb;
  const uint8_t* f_row = frames + off;
  const uint8_t* b_row = bg + (size_t)s * bg_stride + (size_t)y * nb;
  uint8_t* o_row = out + off;
  const bool vec = nb % 16 == 0 &&
      (((uintptr_t)f_row | (uintptr_t)b_row | (uintptr_t)o_row) & 15) == 0;
  if (vec) {
    for (int c = threadIdx.x; c < nb / 16; c += blockDim.x) {
      const uint4 fv = reinterpret_cast<const uint4*>(f_row)[c];
      const uint4 bv = reinterpret_cast<const uint4*>(b_row)[c];
      const uint8_t* fb = reinterpret_cast<const uint8_t*>(&fv);
      const uint8_t* bb = reinterpret_cast<const uint8_t*>(&bv);
      uint4 ov;
      uint8_t* ob = reinterpret_cast<uint8_t*>(&ov);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float a = up[(16 * c + i) / 3];
        ob[i] = blend(fb[i], bb[i], a, 1.0f - a);
      }
      reinterpret_cast<uint4*>(o_row)[c] = ov;
    }
  } else {
    for (int i = threadIdx.x; i < nb; i += blockDim.x) {
      const float a = up[i / 3];
      o_row[i] = blend(f_row[i], b_row[i], a, 1.0f - a);
    }
  }
}

extern "C" int vst_composite(const void* frames, const void* bg,
                             long long bg_stride, const void* alpha,
                             const void* vy, const void* vw, const void* hx,
                             const void* hw, void* out, int S, int H, int W,
                             int mh, int mw, void* stream) {
  const size_t smem = (size_t)(mw + W) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      composite_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)H, (unsigned)S);
  composite_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)frames, (const uint8_t*)bg, bg_stride,
      (const float*)alpha, (const int*)vy, (const float*)vw, (const int*)hx,
      (const float*)hw, (uint8_t*)out, H, W, mh, mw);
  return (int)cudaGetLastError();
}
