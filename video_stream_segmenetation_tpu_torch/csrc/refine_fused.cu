// Fused refine kernels for Hopper (sm_90a): ports of the Pallas kernels of
// video_stream_segmenetation_tpu/kernels/refine_fused.py with a planar u8
// guide.  One templated body serves three of them:
//   * fused_temporal_refine (pallas_call :752) in its analytic-prior form
//     (_temporal_refine_kernel_analytic :243): stages 3-9, the face prior
//     rasterised here from 4 scalars;
//   * the same call's plane-prior form (_temporal_refine_kernel :207):
//     stages 3-9 with the prior read from an [S, H, W] f32 plane;
//   * fused_refine (pallas_call :522, _refine_kernel :182): stages 5, 7, 8
//     and 9 alone, on an alpha already warped and smoothed, with the prior
//     plane and an f32 output.
// new_prev stays f32; the temporal forms' refined alpha is bf16 or f32
// (the reference's out_dtype: bf16 for refined_dtype='bf16', else f32).
//
// Per stream, stages 3-9 of the reference pipeline:
//   3  nearest warp of prev by per-row/per-column source indices yi/xi
//      (-1 reads 0), blended wb*warped + (1-wb)*alpha where use_warp;
//   4  motion-gated EMA, first frame copied -> new_prev;
//   5  3x3 opening, interior only, zero border;
//   7  3x3 closing inside the face prior, where the stream has one;
//   8  joint bilateral 3x3 on the u8 guide, self-normalising at the edges;
//   9  threshold/gamma, face floor, near-background cap.
//
// What bounds it on an H100: per pixel the analytic form reads alpha, prev
// and a gathered prev (f32), three guide bytes, and writes new_prev (f32)
// and the refined alpha (bf16 or f32): about 17-19 bytes a pixel, against a
// few hundred flops -- bound by bytes (3.35 TB/s).  The plane form reads 4
// bytes more a pixel; fused_refine reads alpha, the prior and the guide and
// writes the refined alpha, about 15 bytes a pixel.
//
// Design: the TPU kernel holds a whole 288x512 plane per stream in VMEM.
// A plane's 576 KB does not fit one SM, so a block takes one stream's
// TILE_H rows at full width, with a halo of 5 rows (one for each chained
// 3x3 stage: opening 2, closing 2, bilateral 1).  new_prev is computed for
// the tile and its halo (halo rows are recomputed, not exchanged), and the
// stencil stages ping-pong between two [TILE_H+10, W] f32 planes in shared
// memory.  The zero/interior border is applied at the plane's edges only;
// rows outside the plane are zero and never interior.  The warp is a
// direct gather.  Built with --fmad=false so every stage rounds as the
// plain PyTorch version does.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define TILE_H 16
#define HALO 5
#define ROWS (TILE_H + 2 * HALO)
#define NKNOB 16

// per-stream scalars, one row of 16 floats each (flags as 0/1)
enum {
  K_LOW, K_HIGH, K_GAMMA, K_USE_BI, K_SS, K_SR, K_HAS_PRIOR, K_EMA,
  K_ADAPT, K_USE_WARP, K_INIT, K_WB, K_PCX, K_PCY, K_PRX, K_PRY
};

#define EMA_T0 ((float)0.10)
#define EMA_INV_RAMP ((float)(1.0 / (0.40 - 0.10)))
#define FACE_FLOOR 0.55f
#define NEAR_BG_CAP 0.35f
#define NEAR_BG_BLEND 0.15f
#define PI_F 3.14159265358979323846f

// the face prior at (y, x) of a stream with scalars k: read from the
// stream's plane (PLANE) or rasterised from its ellipse; 0 without a prior
template <bool PLANE>
__device__ __forceinline__ float prior_at(const float* k, const float* plane_s,
                                          int y, int x, int W, int pad) {
  if (k[K_HAS_PRIOR] <= 0.0f) return 0.0f;
  if (PLANE) return plane_s[(size_t)y * W + x];
  const float rx = k[K_PRX], ry = k[K_PRY];
  const float dx = ((float)x - k[K_PCX]) / rx;
  const float dy = ((float)y - k[K_PCY]) / ry;
  const float d2 = dx * dx + dy * dy;
  const float t = sqrtf(fminf(fmaxf(d2, 0.0f), 1.0f));
  float v = 0.5f - 0.5f * cosf(PI_F * (1.0f - t));
  if (d2 > 1.0f - (float)pad / fmaxf(rx, ry)) v = fmaxf(v, 0.25f);
  return d2 <= 1.0f ? v : 0.0f;
}

// TEMPORAL: stages 3-9 from the raw alpha and prev; else stages 5-9 on
// alpha as it is.  PLANE: the prior from prior_plane, else from the scalars.
template <bool TEMPORAL, bool PLANE>
__global__ void __launch_bounds__(256)
refine_kernel(const float* __restrict__ alpha, const float* __restrict__ prev,
              const int* __restrict__ yi, const int* __restrict__ xi,
              const uint8_t* __restrict__ guide,
              const float* __restrict__ knobs,
              const float* __restrict__ prior_plane,
              float* __restrict__ new_prev, void* __restrict__ out,
              int out_f32, int H, int W, int pad) {
  extern __shared__ float smem[];
  float* P = smem;             // [ROWS, W]
  float* Q = smem + ROWS * W;  // [ROWS, W]
  const int s = blockIdx.y;
  const int y0 = blockIdx.x * TILE_H;
  const float* k = knobs + (size_t)s * NKNOB;
  const size_t plane = (size_t)H * W;
  const float* a_s = alpha + s * plane;
  const float* pl_s = PLANE ? prior_plane + s * plane : nullptr;
  const int n = ROWS * W;

  // ---- stages 3+4: warp, blend, EMA -> P (rows y0-5 .. y0+TILE_H+4);
  // without TEMPORAL the alpha itself
  if (!TEMPORAL) {
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int j = e / W, x = e % W, y = y0 - HALO + j;
      P[e] = (y >= 0 && y < H) ? a_s[(size_t)y * W + x] : 0.0f;
    }
  } else {
    const float* p_s = prev + s * plane;
    const bool use_warp = k[K_USE_WARP] > 0.0f;
    const bool init = k[K_INIT] > 0.0f;
    const float wb = k[K_WB], ema = k[K_EMA], ad = k[K_ADAPT];
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int j = e / W, x = e % W, y = y0 - HALO + j;
      float v = 0.0f;
      if (y >= 0 && y < H) {
        const float ar = a_s[(size_t)y * W + x];
        const float pv = p_s[(size_t)y * W + x];
        float base = ar;
        if (use_warp) {
          const int sy = yi[(size_t)s * H + y], sx = xi[(size_t)s * W + x];
          const float warped =
              (sy >= 0 && sx >= 0) ? p_s[(size_t)sy * W + sx] : 0.0f;
          base = warped * wb + ar * (1.0f - wb);
        }
        const float d = fabsf(base - pv);
        const float m = fminf(fmaxf((d - EMA_T0) * EMA_INV_RAMP, 0.0f), 1.0f);
        const float ke = ema * (1.0f - ad * m);
        v = init ? ke * pv + (1.0f - ke) * base : base;
        if (j >= HALO && j < HALO + TILE_H) new_prev[s * plane + (size_t)y * W + x] = v;
      }
      P[e] = v;
    }
  }
  __syncthreads();

#define INTERIOR(y, x) ((y) >= 1 && (y) <= H - 2 && (x) >= 1 && (x) <= W - 2)
  // ---- stage 5: erode P -> Q (rows 1..ROWS-2), dilate Q -> P (2..ROWS-3)
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int j = e / W, x = e % W, y = y0 - HALO + j;
    if (j < 1 || j > ROWS - 2) continue;
    float v = 0.0f;
    if (INTERIOR(y, x)) {
      v = 1.0f;
      for (int dy = -1; dy <= 1; ++dy)
        for (int dx = -1; dx <= 1; ++dx) v = fminf(v, P[(j + dy) * W + x + dx]);
    }
    Q[e] = v;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int j = e / W, x = e % W, y = y0 - HALO + j;
    if (j < 2 || j > ROWS - 3) continue;
    float v = 0.0f;
    if (INTERIOR(y, x)) {
      for (int dy = -1; dy <= 1; ++dy)
        for (int dx = -1; dx <= 1; ++dx) v = fmaxf(v, Q[(j + dy) * W + x + dx]);
    }
    P[e] = v;
  }
  __syncthreads();

  // ---- stage 7: closing inside the prior: dilate P -> Q (3..ROWS-4),
  // erode Q -> P (4..ROWS-5); pass-through outside the prior
  if (k[K_HAS_PRIOR] > 0.0f) {
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int j = e / W, x = e % W, y = y0 - HALO + j;
      if (j < 3 || j > ROWS - 4) continue;
      float v = 0.0f;
      if (INTERIOR(y, x)) {
        v = P[e];
        if (prior_at<PLANE>(k, pl_s, y, x, W, pad) > 0.0f) {
          v = 0.0f;
          for (int dy = -1; dy <= 1; ++dy)
            for (int dx = -1; dx <= 1; ++dx) v = fmaxf(v, P[(j + dy) * W + x + dx]);
        }
      }
      Q[e] = v;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int j = e / W, x = e % W, y = y0 - HALO + j;
      if (j < 4 || j > ROWS - 5) continue;
      float v = Q[e];
      if (INTERIOR(y, x) && prior_at<PLANE>(k, pl_s, y, x, W, pad) > 0.0f) {
        v = 1.0f;
        for (int dy = -1; dy <= 1; ++dy)
          for (int dx = -1; dx <= 1; ++dx) v = fminf(v, Q[(j + dy) * W + x + dx]);
      }
      P[e] = v;
    }
    __syncthreads();
  }
#undef INTERIOR

  // ---- stages 8+9 on the tile's own rows
  const bool use_bi = k[K_USE_BI] > 0.0f;
  const float ss = k[K_SS], sr = k[K_SR];
  const float inv_two_ss2 = 1.0f / (2.0f * ss * ss);
  const float inv_two_sr2 = 1.0f / (2.0f * sr * sr);
  const float low = k[K_LOW], high = k[K_HIGH], gamma = k[K_GAMMA];
  const bool has_prior = k[K_HAS_PRIOR] > 0.0f;
  const uint8_t* g_s = guide + (size_t)s * 3 * plane;
  for (int e = threadIdx.x; e < TILE_H * W; e += blockDim.x) {
    const int jt = e / W, x = e % W, y = y0 + jt, j = jt + HALO;
    if (y >= H) continue;
    float a = P[j * W + x];
    if (use_bi) {
      const size_t c0 = (size_t)y * W + x;
      const float gr = g_s[c0], gg = g_s[plane + c0], gb = g_s[2 * plane + c0];
      float sum_w = 0.0f, sum_a = 0.0f;
      for (int dy = -1; dy <= 1; ++dy) {
        const int ny = y + dy;
        if (ny < 0 || ny >= H) continue;
        for (int dx = -1; dx <= 1; ++dx) {
          const int nx = x + dx;
          if (nx < 0 || nx >= W) continue;
          const size_t c1 = (size_t)ny * W + nx;
          const float dr = (float)g_s[c1] - gr;
          const float dg = (float)g_s[plane + c1] - gg;
          const float db = (float)g_s[2 * plane + c1] - gb;
          const float range2 = dr * dr + dg * dg + db * db;
          const float spatial2 = (float)(dy * dy + dx * dx);
          const float wgt = expf(-spatial2 * inv_two_ss2) * expf(-range2 * inv_two_sr2);
          sum_w = sum_w + wgt;
          sum_a = sum_a + wgt * P[(j + dy) * W + nx];
        }
      }
      a = sum_a / sum_w;
    }
    const float denom = fmaxf(1e-6f, high - low);
    const float t = fminf(fmaxf((a - low) / denom, 0.0f), 1.0f);
    float v = a <= low ? 0.0f : (a >= high ? 1.0f : powf(t, gamma));
    if (has_prior) {
      const float p = prior_at<PLANE>(k, pl_s, y, x, W, pad);
      if (p > 0.25f)
        v = fmaxf(v, fminf(1.0f, FACE_FLOOR * p + 0.15f));
      else if (p > 0.0f)
        v = fminf(v, NEAR_BG_CAP + NEAR_BG_BLEND * p);
    }
    const size_t o = s * plane + (size_t)y * W + x;
    if (out_f32)
      reinterpret_cast<float*>(out)[o] = v;
    else
      reinterpret_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
  }
}

template <bool TEMPORAL, bool PLANE>
static int launch(const void* alpha, const void* prev, const void* yi,
                  const void* xi, const void* guide, const void* knobs,
                  const void* prior, void* new_prev, void* out, int out_f32,
                  int S, int H, int W, int pad, void* stream) {
  const size_t smem = 2 * (size_t)ROWS * W * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      refine_kernel<TEMPORAL, PLANE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((H + TILE_H - 1) / TILE_H), (unsigned)S);
  refine_kernel<TEMPORAL, PLANE><<<grid, 256, smem, (cudaStream_t)stream>>>(
      (const float*)alpha, (const float*)prev, (const int*)yi, (const int*)xi,
      (const uint8_t*)guide, (const float*)knobs, (const float*)prior,
      (float*)new_prev, out, out_f32, H, W, pad);
  return (int)cudaGetLastError();
}

// stages 3-9; prior == NULL: the analytic prior from the scalar table,
// else the [S, H, W] f32 plane
extern "C" int vst_temporal_refine(const void* alpha, const void* prev,
                                   const void* yi, const void* xi,
                                   const void* guide, const void* knobs,
                                   const void* prior, void* new_prev,
                                   void* out, int out_f32, int S, int H,
                                   int W, int pad, void* stream) {
  if (prior == nullptr)
    return launch<true, false>(alpha, prev, yi, xi, guide, knobs, prior,
                               new_prev, out, out_f32, S, H, W, pad, stream);
  return launch<true, true>(alpha, prev, yi, xi, guide, knobs, prior,
                            new_prev, out, out_f32, S, H, W, pad, stream);
}

// stages 5-9 on alpha as it is, the prior plane, f32 out
extern "C" int vst_refine(const void* alpha, const void* guide,
                          const void* knobs, const void* prior, void* out,
                          int S, int H, int W, void* stream) {
  return launch<false, true>(alpha, nullptr, nullptr, nullptr, guide, knobs,
                             prior, nullptr, out, 1, S, H, W, 0, stream);
}
