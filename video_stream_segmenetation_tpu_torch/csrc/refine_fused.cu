// Fused refine kernels for Hopper (sm_90a): ports of the Pallas kernels of
// video_stream_segmenetation_tpu/kernels/refine_fused.py.  One templated
// body serves four of them:
//   * fused_temporal_refine (pallas_call :752) in its analytic-prior form
//     (_temporal_refine_kernel_analytic :243): stages 3-9, the face prior
//     rasterised here from 4 scalars;
//   * the same call's plane-prior form (_temporal_refine_kernel :207):
//     stages 3-9 with the prior read from an [S, H, W] f32 plane;
//   * fused_refine (pallas_call :522, _refine_kernel :182): stages 5, 7, 8
//     and 9 alone, on an alpha already warped and smoothed, with the prior
//     plane and an f32 output;
//   * the same call's fast form (_temporal_refine_kernel_fast :330, with
//     _guide_from_lanes :297), analytic prior only, with one or both of two
//     cuts: LOWRES takes the head-grid logits [S, h0, w0] f32 and computes
//     sigmoid(A_h . L . A_w^T) per pixel (the half-pixel interpolation
//     matrices, at most two taps a row: rows first, then columns, as the
//     reference's two products), so the full-resolution f32 alpha is never
//     written; LANES takes the guide's raw tap lanes [nl, S, hp, wp] u8 and
//     reads guide pixel (c, y, x) at lane (c*fy + y%fy)*fx + x%fx, patch
//     (y/fy, x/fx), so the planar guide is never built.
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
// writes the refined alpha, about 15 bytes a pixel.  The fast form with
// both cuts reads a sixteenth of an f32 logit a pixel instead of the f32
// alpha: about 13.3 bytes a pixel.
//
// Design: the TPU kernel holds a whole 288x512 plane per stream in VMEM.
// Here a block takes one stream's strip of TW = 2 RT - 12 columns (RT = 96
// threads, two neighbouring columns each, with a halo of 6 columns on each
// side) over `seg` rows, and rolls down it a row a step: at step t stage k
// (0: warp, blend and EMA; 1-2: the opening's erode and dilate; 3-4: the
// closing's dilate and erode inside the prior; 5: the bilateral and
// stages 8-9) computes row ys - 5 + t - 2k from rows of stage k-1 that
// the step before wrote, so that one barrier a step orders the whole
// chain, and each stage's rows live in a ring of 2 (or 4) rows in shared
// memory.  Only the 5 halo rows above and below a strip's rows, and the 6
// halo columns on each side, are computed twice.  `seg` is 36 rows, 24 for
// grids too small to fill the card (rows_a_block).
//   * Two columns a thread share each step's row and index work and read
//     their neighbours in pairs.  A step issues its global loads first, so
//     that their latency overlaps the stages that read only shared memory.
//   * The 3x3 min and max are separable: each thread keeps the 3-wide
//     reductions of the two rows above in registers and reads one new row
//     a step (min and max are exact, so their order does not matter).
//   * The face prior is evaluated once a pixel (stage 3), only on the rows
//     that use it; its per-column term once a thread.
//   * The guide is staged a row a step, a pixel's three bytes in a word,
//     de-laned as it is staged.  The bilateral's range factor
//     expf(-range2 / (2 sr^2)) is computed once an edge of the pixel grid,
//     4 a pixel instead of 9: range2 is a sum of squared channel
//     differences, which the edge's two ends see with opposite signs, so
//     both get the very value the plain version computes; it is an integer
//     below 2^24, summed exactly by __vabsdiffu4 and __dp4a.  The three
//     spatial factors are computed once a block with the plain version's
//     expression.
//   * LOWRES: one thread a head-grid column interpolates the next row's two
//     source rows once (a0 L[r0][c] + a1 L[r1][c], the expression each
//     column computed before), and each column combines its two.
//   * Registers, not shared memory (30-35 KB a block), limit the blocks an
//     SM holds: the bounds ask for 6 (96 registers).
// The zero/interior border is applied at the plane's edges only; rows
// outside the plane are never read.  Built with --fmad=false, with every
// stage's f32 operations in the plain version's order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define RT 96           // threads a block, two columns of the strip each
#define HALO 5          // one row or column for each chained 3x3 stage
#define NC (2 * RT)     // the strip's columns
#define XH 6            // the strip's halo columns on each side (HALO, even)
#define TW (NC - 2 * XH)  // output columns a block
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

// the analytic face prior of a stream at a pixel whose row and column
// terms are dy2 = ((y - cy) / ry)^2 and dx2 = ((x - cx) / rx)^2, thr =
// 1 - pad / max(rx, ry): the raised-cosine ellipse, at least 0.25 in its
// rim, 0 outside it
__device__ __forceinline__ float prior_ellipse(float dx2, float dy2, float thr) {
  const float d2 = dx2 + dy2;
  const float t = sqrtf(fminf(fmaxf(d2, 0.0f), 1.0f));
  float v = 0.5f - 0.5f * cosf(PI_F * (1.0f - t));
  if (d2 > thr) v = fmaxf(v, 0.25f);
  return d2 <= 1.0f ? v : 0.0f;
}

// two neighbouring floats of a shared row, from an even column
__device__ __forceinline__ float2 ld2(const float* row, int j) {
  return *reinterpret_cast<const float2*>(row + j);
}
__device__ __forceinline__ void st2(float* row, int j, float a, float b) {
  *reinterpret_cast<float2*>(row + j) = make_float2(a, b);
}

__device__ __forceinline__ float min3(float a, float b, float c) {
  return fminf(fminf(a, b), c);
}
__device__ __forceinline__ float max3(float a, float b, float c) {
  return fmaxf(fmaxf(a, b), c);
}

// the blocks an SM must hold, which caps the registers at 96: every form
// fits them without a spill, and more blocks an SM beat more registers a
// thread (the fast forms at 128 registers and 5 blocks ran 8 % slower)
#define REFINE_BLOCKS_PER_SM 6

// TEMPORAL: stages 3-9 from the raw alpha and prev; else stages 5-9 on
// alpha as it is.  PLANE: the prior from prior_plane, else from the scalars.
// LOWRES: alpha holds the head-grid logits [S, h0, w0].  LANES: guide holds
// the tap lanes.  Grid: (strips of TW columns, segments of seg rows, S).
template <bool TEMPORAL, bool PLANE, bool LOWRES, bool LANES>
__global__ void __launch_bounds__(RT, REFINE_BLOCKS_PER_SM)
refine_kernel(const float* __restrict__ alpha, const float* __restrict__ prev,
              const int* __restrict__ yi, const int* __restrict__ xi,
              const uint8_t* __restrict__ guide,
              const float* __restrict__ knobs,
              const float* __restrict__ prior_plane,
              const int* __restrict__ taps, const float* __restrict__ wts,
              float* __restrict__ new_prev, void* __restrict__ out,
              int out_f32, int S, int H, int W, int h0, int w0, int fy, int fx,
              int pad, int seg) {
  // stage k's rows, k = 0..3, row mod 2 (stage k+1 reads one of them a
  // step, the one stage k wrote the step before), and stage 4's, row mod 4
  // (stage 5 reads three)
  __shared__ __align__(16) float ring[4][2][NC];
  __shared__ __align__(16) float ring4[4][NC];
  // the guide's rows, row mod 4, a pixel's three channels packed in the
  // low three bytes of a word
  __shared__ __align__(8) unsigned gd[4][NC];
  // the bilateral's range weights expf(-range2 / (2 sr^2)) of the edges
  // from (y, x) to (y, x+1), (y+1, x), (y+1, x+1), and from (y, x+1) to
  // (y+1, x), row mod 4: each edge's weight serves both its ends (range2
  // is a sum of squares of differences that only change sign)
  __shared__ __align__(16) float ew[4][4][NC];
  // LOWRES: each column's two interpolation taps and their weights
  __shared__ int tc[LOWRES ? 2 : 1][LOWRES ? NC : 1];
  __shared__ float tw[LOWRES ? 2 : 1][LOWRES ? NC : 1];
  // row-interpolated logits, row mod 2: a strip's NC columns interpolate
  // from at most NC + 1 head-grid columns (the grid no wider than the plane)
  __shared__ float urow[2][LOWRES ? NC + 2 : 1];
  // the prior of the rows stage 3 computed, row mod 8, for stages 4 and 5
  // (each thread reads back only its own columns)
  __shared__ __align__(8) float pr[8][NC];
  const int c = threadIdx.x;
  // this thread's columns j0, j0 + 1 of the strip and their neighbours
  // (clamped at the strip's ends, whose values no output reads)
  const int j0 = 2 * c;
  const int jl = j0 > 0 ? j0 - 1 : 0, jr = j0 + 2 < NC ? j0 + 2 : NC - 1;
  const int xs = blockIdx.x * TW - XH;  // the plane's column at j = 0
  const int ys = blockIdx.y * seg, ye = min(H, ys + seg);
  const int s = blockIdx.z;
  const float* k = knobs + (size_t)s * NKNOB;
  const size_t plane = (size_t)H * W;
  const float* a_s = alpha + (LOWRES ? (size_t)s * h0 * w0 : s * plane);
  const float* p_s = TEMPORAL ? prev + s * plane : nullptr;
  const float* pl_s = PLANE ? prior_plane + s * plane : nullptr;

  const bool use_warp = TEMPORAL && k[K_USE_WARP] > 0.0f;
  const bool init = k[K_INIT] > 0.0f;
  const float wb = k[K_WB], ema = k[K_EMA], ad = k[K_ADAPT];
  const bool has_prior = k[K_HAS_PRIOR] > 0.0f;
  const bool use_bi = k[K_USE_BI] > 0.0f;
  const float ss = k[K_SS], sr = k[K_SR];
  const float inv_two_ss2 = 1.0f / (2.0f * ss * ss);
  const float inv_two_sr2 = 1.0f / (2.0f * sr * sr);
  const float low = k[K_LOW], high = k[K_HIGH], gamma = k[K_GAMMA];
  // the bilateral's spatial factor at dy*dy + dx*dx = 0, 1, 2
  float sp[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) sp[d] = expf(-(float)d * inv_two_ss2);
  // and the range factor of a pixel with itself (range2 = 0)
  const float w_centre = expf(-0.0f * inv_two_sr2);
  const int hp = H / fy, wp = W / fx;
  // the analytic prior's per-stream terms (its column term is per column)
  const float p_cy = k[K_PCY], p_ry = k[K_PRY];
  const float p_thr = 1.0f - (float)pad / fmaxf(k[K_PRX], p_ry);

  // LOWRES: the head-grid columns cs .. cs + n_src - 1 that the strip's
  // columns interpolate from; each step, one thread a source column
  // interpolates the next row's two source rows into urow, and a column
  // then reads its two source columns' values there (the same expression
  // as a0 * L[r0][c] + a1 * L[r1][c] per column, computed once)
  int cs = 0, n_src = 0;
  if (LOWRES) {
    const int xa = max(xs, 0), xb = min(xs + NC, W) - 1;
    cs = taps[2 * (H + xa)];
    n_src = taps[2 * (H + xb) + 1] - cs + 1;
  }
  auto interp_row = [&](int y, int from) {
    if (!LOWRES || y < 0 || y >= H) return;
    const int r0 = taps[2 * y], r1 = taps[2 * y + 1];
    const float a0 = wts[2 * y], a1 = wts[2 * y + 1];
    for (int i = from; i < n_src; i += RT)
      urow[y & 1][i] = a0 * a_s[(size_t)r0 * w0 + cs + i] + a1 * a_s[(size_t)r1 * w0 + cs + i];
  };

  // each column's constants: its plane column, its warp source column, its
  // interpolation taps (LOWRES), its lane remainder and patch (LANES)
  int x[2], sx[2], g_col[2];
  bool xin[2], x_int[2], out_col[2];
  float p_dx2[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    x[q] = xs + j0 + q;
    xin[q] = x[q] >= 0 && x[q] < W;
    x_int[q] = x[q] >= 1 && x[q] <= W - 2;
    out_col[q] = xin[q] && j0 + q >= XH && j0 + q < NC - XH;
    sx[q] = (use_warp && xin[q]) ? xi[(size_t)s * W + x[q]] : -1;
    // the interpolation taps stay in shared memory, read by this thread
    // alone each step: registers are what limit the blocks an SM holds
    if (LOWRES) {
      tc[0][j0 + q] = xin[q] ? taps[2 * (H + x[q])] - cs : 0;
      tc[1][j0 + q] = xin[q] ? taps[2 * (H + x[q]) + 1] - cs : 0;
      tw[0][j0 + q] = xin[q] ? wts[2 * (H + x[q])] : 0.0f;
      tw[1][j0 + q] = xin[q] ? wts[2 * (H + x[q]) + 1] : 0.0f;
    }
    // the guide's offset of this column: x planar, or (LANES) lane
    // remainder x % fx and patch x / fx
    g_col[q] = !xin[q] ? 0 : (LANES ? (x[q] % fx) * S * hp * wp + x[q] / fx : x[q]);
    const float dx = ((float)x[q] - k[K_PCX]) / k[K_PRX];
    p_dx2[q] = dx * dx;
  }

  // sliding windows, per column: the 3-wide reduction of the two rows
  // above (h*) and, for the closing, the centre of the row being computed
  // (m*)
  float e0[2] = {0.0f, 0.0f}, e1[2] = {0.0f, 0.0f}, d0[2] = {0.0f, 0.0f},
        d1[2] = {0.0f, 0.0f}, cd0[2] = {0.0f, 0.0f}, cd1[2] = {0.0f, 0.0f},
        cdm[2] = {0.0f, 0.0f}, ce0[2] = {0.0f, 0.0f}, ce1[2] = {0.0f, 0.0f},
        cem[2] = {0.0f, 0.0f};

  // the warp's source row of stage 0's first row; each step loads the next
  int sy_next = -1;
  if (use_warp && ys - HALO >= 0) sy_next = yi[(size_t)s * H + ys - HALO];
  interp_row(ys - HALO, c);
  __syncthreads();

  const int steps = ye - ys + 3 * HALO;
  for (int t = 0; t < steps; ++t) {
    // ---- the loads of this step, issued first so that their latency
    // overlaps stages 1-5: stage 0's inputs at row ys-5+t (rows ys-5 ..
    // ye+4), the next row's warp source row, the guide's row ys-12+t (for
    // the edge weights a step later)
    const int y0 = ys - HALO + t;
    const bool row0 = y0 >= 0 && y0 < H && y0 < ye + HALO;
    float l_ar[2] = {0.0f, 0.0f}, l_pv[2] = {0.0f, 0.0f}, l_warp[2] = {0.0f, 0.0f};
    if (row0) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (!xin[q]) continue;
        if (!LOWRES) l_ar[q] = a_s[(size_t)y0 * W + x[q]];
        if (TEMPORAL) {
          l_pv[q] = p_s[(size_t)y0 * W + x[q]];
          if (use_warp && sy_next >= 0 && sx[q] >= 0)
            l_warp[q] = p_s[(size_t)sy_next * W + sx[q]];
        }
      }
    }
    if (use_warp) sy_next = (y0 + 1 >= 0 && y0 + 1 < H) ? yi[(size_t)s * H + y0 + 1] : -1;
    // LOWRES: the next row's source rows at this thread's source columns
    // c and c + RT, loaded now and interpolated into urow at the step's end
    const int yu = y0 + 1;
    const bool row_u = LOWRES && yu >= 0 && yu < H && yu < ye + HALO;
    float ul[2][2] = {}, ua0 = 0.0f, ua1 = 0.0f;
    if (row_u) {
      const int r0 = taps[2 * yu], r1 = taps[2 * yu + 1];
      ua0 = wts[2 * yu];
      ua1 = wts[2 * yu + 1];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (c + i * RT < n_src) {
          ul[i][0] = a_s[(size_t)r0 * w0 + cs + c + i * RT];
          ul[i][1] = a_s[(size_t)r1 * w0 + cs + c + i * RT];
        }
      if (n_src > 2 * RT) interp_row(yu, c + 2 * RT);  // the (NC + 1)-th column
    }
    const int yg = ys - 3 * HALO + 3 + t;
    const bool row_g = use_bi && yg >= 0 && yg < H && yg >= ys - 1 && yg <= ye;
    unsigned g[2] = {0u, 0u};
    if (row_g) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        // the row's offset in channel ch: planar, or (LANES) its lane's
        const int g_row =
            LANES ? (((ch * fy + yg % fy) * fx * S + s) * hp + yg / fy) * wp
                  : ((s * 3 + ch) * H + yg) * W;
#pragma unroll
        for (int q = 0; q < 2; ++q)
          if (xin[q]) g[q] |= (unsigned)guide[g_row + g_col[q]] << (8 * ch);
      }
    }

    // ---- stage 1: erode (opening), row y from stage 0's rows y-1..y+1
    {
      const int y = ys - HALO + t - 2;
      const float* R = ring[0][(y + 1) & 1];
      const float2 m = ld2(R, j0);
      const float hn[2] = {min3(R[jl], m.x, m.y), min3(m.x, m.y, R[jr])};
      const bool rint = y >= 1 && y <= H - 2;
      float v[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        v[q] = rint && x_int[q] ? fminf(1.0f, min3(e0[q], e1[q], hn[q])) : 0.0f;
        e0[q] = e1[q];
        e1[q] = hn[q];
      }
      st2(ring[1][y & 1], j0, v[0], v[1]);
    }
    // ---- stage 2: dilate (opening)
    {
      const int y = ys - HALO + t - 4;
      const float* R = ring[1][(y + 1) & 1];
      const float2 m = ld2(R, j0);
      const float hn[2] = {max3(R[jl], m.x, m.y), max3(m.x, m.y, R[jr])};
      const bool rint = y >= 1 && y <= H - 2;
      float v[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        v[q] = rint && x_int[q] ? fmaxf(0.0f, max3(d0[q], d1[q], hn[q])) : 0.0f;
        d0[q] = d1[q];
        d1[q] = hn[q];
      }
      st2(ring[2][y & 1], j0, v[0], v[1]);
    }
    // ---- stage 3: dilate inside the prior (closing); the prior of row y
    // is evaluated here, once a pixel, on the rows that use it;
    // pass-through without a prior
    {
      const int y = ys - HALO + t - 6;
      const float* R = ring[2][(y + 1) & 1];
      const float2 m = ld2(R, j0);
      const float mn[2] = {m.x, m.y};
      const float hn[2] = {max3(R[jl], m.x, m.y), max3(m.x, m.y, R[jr])};
      const bool rint = y >= 1 && y <= H - 2;
      const bool prow = has_prior && y >= 0 && y < H && y >= ys - 2 && y < ye + 2;
      float dy2 = 0.0f;
      if (!PLANE && prow) {
        const float dy = ((float)y - p_cy) / p_ry;
        dy2 = dy * dy;
      }
      float v[2], p[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        p[q] = 0.0f;
        if (prow && xin[q])
          p[q] = PLANE ? pl_s[(size_t)y * W + x[q]] : prior_ellipse(p_dx2[q], dy2, p_thr);
        v[q] = (has_prior && rint && x_int[q] && p[q] > 0.0f)
                   ? fmaxf(0.0f, max3(cd0[q], cd1[q], hn[q]))
                   : cdm[q];
        cd0[q] = cd1[q];
        cd1[q] = hn[q];
        cdm[q] = mn[q];
      }
      st2(ring[3][y & 1], j0, v[0], v[1]);
      if (has_prior) st2(pr[y & 7], j0, p[0], p[1]);
    }
    // ---- stage 4: erode inside the prior (closing)
    {
      const int y = ys - HALO + t - 8;
      const float* R = ring[3][(y + 1) & 1];
      const float2 m = ld2(R, j0);
      const float mn[2] = {m.x, m.y};
      const float hn[2] = {min3(R[jl], m.x, m.y), min3(m.x, m.y, R[jr])};
      const bool rint = y >= 1 && y <= H - 2;
      float v[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        v[q] = (has_prior && rint && x_int[q] && pr[y & 7][j0 + q] > 0.0f)
                   ? fminf(1.0f, min3(ce0[q], ce1[q], hn[q]))
                   : cem[q];
        ce0[q] = ce1[q];
        ce1[q] = hn[q];
        cem[q] = mn[q];
      }
      st2(ring4[y & 3], j0, v[0], v[1]);
    }
    // ---- the edge weights of row ys-14+t (stage 5's next row), from the
    // guide's rows ys-14+t and ys-13+t
    if (use_bi) {
      const int y = ys - 3 * HALO + 1 + t;
      if (y >= ys - 1 && y < ye && y >= 0) {
        const int r = y & 3, rn = (y + 1) & 3;
        // the guide at columns j0, j0+1, j0+2 of rows y and y+1.  range2,
        // the plain version's d0*d0 + d1*d1 + d2*d2 of integer-valued
        // floats below 2^24, is exact, so its integer sum of squared byte
        // differences converts to the same float
        const uint2 u = *reinterpret_cast<const uint2*>(&gd[r][j0]);
        const uint2 v = *reinterpret_cast<const uint2*>(&gd[rn][j0]);
        const unsigned gc[3] = {u.x, u.y, gd[r][jr]}, gn[3] = {v.x, v.y, gd[rn][jr]};
        float w[4][2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const unsigned dh = __vabsdiffu4(gc[q + 1], gc[q]);
          const unsigned dv = __vabsdiffu4(gn[q], gc[q]);
          const unsigned dd = __vabsdiffu4(gn[q + 1], gc[q]);
          const unsigned da = __vabsdiffu4(gn[q], gc[q + 1]);
          w[0][q] = expf(-(float)__dp4a(dh, dh, 0u) * inv_two_sr2);
          w[1][q] = expf(-(float)__dp4a(dv, dv, 0u) * inv_two_sr2);
          w[2][q] = expf(-(float)__dp4a(dd, dd, 0u) * inv_two_sr2);
          w[3][q] = expf(-(float)__dp4a(da, da, 0u) * inv_two_sr2);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) st2(ew[r][e], j0, w[e][0], w[e][1]);
      }
    }
    // ---- stage 5: joint bilateral, threshold/gamma, prior clamps (stages
    // 8+9 of the pipeline) on the strip's own rows and columns
    {
      const int y = ys - HALO + t - 10;
      if (y >= ys) {
        const int ru = (y - 1) & 3, r = y & 3, rd = (y + 1) & 3;
        // stage 4's rows y-1..y+1 at columns j0-1 .. j0+2
        float av[3][4] = {};
        const int rows[3] = {ru, r, rd};
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          if (!use_bi && i != 1) continue;
          const float* R = ring4[rows[i]];
          const float2 m = ld2(R, j0);
          av[i][0] = R[jl];
          av[i][1] = m.x;
          av[i][2] = m.y;
          av[i][3] = R[jr];
        }
        // the bilateral of both columns, from the range weights of the
        // edges each tap crosses (by (dy + 1) * 3 + dx + 1; the centre's
        // range2 is 0), in the plain version's tap order
        float a_bi[2] = {av[1][1], av[1][2]};
        if (use_bi) {
          const float2 u2 = ld2(ew[ru][2], j0), u1 = ld2(ew[ru][1], j0),
                       u3 = ld2(ew[ru][3], j0), h0 = ld2(ew[r][0], j0),
                       h3 = ld2(ew[r][3], j0), h1 = ld2(ew[r][1], j0),
                       h2 = ld2(ew[r][2], j0);
          const float u2l = ew[ru][2][jl], h0l = ew[r][0][jl], h3l = ew[r][3][jl];
          const float w0[9] = {u2l, u1.x, u3.x, h0l, w_centre, h0.x, h3l, h1.x, h2.x};
          const float w1[9] = {u2.x, u1.y, u3.y, h0.x, w_centre, h0.y, h3.x, h1.y, h2.y};
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            float sum_w = 0.0f, sum_a = 0.0f;
#pragma unroll
            for (int dy = -1; dy <= 1; ++dy) {
              const int ny = y + dy;
              if (ny < 0 || ny >= H) continue;
#pragma unroll
              for (int dx = -1; dx <= 1; ++dx) {
                const int nx = x[q] + dx;
                if (nx < 0 || nx >= W) continue;
                const int i = (dy + 1) * 3 + dx + 1;
                const float wgt = sp[dy * dy + dx * dx] * (q == 0 ? w0[i] : w1[i]);
                sum_w = sum_w + wgt;
                sum_a = sum_a + wgt * av[dy + 1][q + 1 + dx];
              }
            }
            a_bi[q] = sum_a / sum_w;
          }
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (!out_col[q]) continue;
          const float a = a_bi[q];
          const float denom = fmaxf(1e-6f, high - low);
          const float tt = fminf(fmaxf((a - low) / denom, 0.0f), 1.0f);
          float v = a <= low ? 0.0f : (a >= high ? 1.0f : powf(tt, gamma));
          if (has_prior) {
            const float p = pr[y & 7][j0 + q];
            if (p > 0.25f)
              v = fmaxf(v, fminf(1.0f, FACE_FLOOR * p + 0.15f));
            else if (p > 0.0f)
              v = fminf(v, NEAR_BG_CAP + NEAR_BG_BLEND * p);
          }
          const size_t o = s * plane + (size_t)y * W + x[q];
          if (out_f32)
            reinterpret_cast<float*>(out)[o] = v;
          else
            reinterpret_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
        }
      }
    }
    // ---- stage 0 (stages 3+4 of the pipeline) on this step's loads: warp,
    // blend, EMA; without TEMPORAL the alpha itself
    {
      float v[2] = {0.0f, 0.0f};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (!(row0 && xin[q])) continue;
        if (!TEMPORAL) {
          v[q] = l_ar[q];
        } else {
          float ar = l_ar[q];
          if (LOWRES) {
            const float* u = urow[y0 & 1];
            const float lv = tw[0][j0 + q] * u[tc[0][j0 + q]] + tw[1][j0 + q] * u[tc[1][j0 + q]];
            ar = 1.0f / (1.0f + expf(-lv));
          }
          float base = ar;
          if (use_warp) base = l_warp[q] * wb + ar * (1.0f - wb);
          const float dd = fabsf(base - l_pv[q]);
          const float m = fminf(fmaxf((dd - EMA_T0) * EMA_INV_RAMP, 0.0f), 1.0f);
          const float ke = ema * (1.0f - ad * m);
          v[q] = init ? ke * l_pv[q] + (1.0f - ke) * base : base;
          if (y0 >= ys && y0 < ye && out_col[q])
            new_prev[s * plane + (size_t)y0 * W + x[q]] = v[q];
        }
      }
      st2(ring[0][y0 & 1], j0, v[0], v[1]);
    }
    if (row_g) {
      *reinterpret_cast<uint2*>(&gd[yg & 3][j0]) = make_uint2(g[0], g[1]);
    }
    if (row_u) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (c + i * RT < n_src) urow[yu & 1][c + i * RT] = ua0 * ul[i][0] + ua1 * ul[i][1];
    }
    __syncthreads();
  }
}

// The rows a block takes: 36, or 24 where a grid of 36-row blocks would
// not fill the card once (few streams).  Measured on an H100 at S = 16, 64
// and 96 against 24 to 72 rows (PERF.md): a block's cost depends on its
// stream (the bilateral, the prior), and one long wave ends with SMs that
// hold only the dearer streams' blocks, while short blocks pay their 10
// halo rows more often.
static int rows_a_block(int S, int H, int W, int slots) {
  const long long strips = (W + TW - 1) / TW;
  const int seg = S * strips * ((H + 35) / 36) >= slots ? 36 : 24;
  return seg < H ? seg : H;
}

template <bool TEMPORAL, bool PLANE, bool LOWRES = false, bool LANES = false>
static int launch(const void* alpha, const void* prev, const void* yi,
                  const void* xi, const void* guide, const void* knobs,
                  const void* prior, void* new_prev, void* out, int out_f32,
                  int S, int H, int W, int pad, void* stream,
                  const void* taps = nullptr, const void* wts = nullptr,
                  int h0 = 0, int w0 = 0, int fy = 1, int fx = 1) {
  static int slots = 0;  // the blocks the card holds at once, by the launch bounds
  if (slots == 0) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    slots = sms * REFINE_BLOCKS_PER_SM;
  }
  const int seg = rows_a_block(S, H, W, slots);
  dim3 grid((unsigned)((W + TW - 1) / TW), (unsigned)((H + seg - 1) / seg), (unsigned)S);
  refine_kernel<TEMPORAL, PLANE, LOWRES, LANES>
      <<<grid, RT, 0, (cudaStream_t)stream>>>(
          (const float*)alpha, (const float*)prev, (const int*)yi,
          (const int*)xi, (const uint8_t*)guide, (const float*)knobs,
          (const float*)prior, (const int*)taps, (const float*)wts,
          (float*)new_prev, out, out_f32, S, H, W, h0, w0, fy, fx, pad, seg);
  return (int)cudaGetLastError();
}

// stages 3-9: the analytic prior from the scalar table (prior == NULL) or
// the [S, H, W] f32 plane; the fast form (analytic prior only) with taps !=
// NULL, alpha the head-grid logits [S, h0, w0] (h0 <= H, w0 <= W) and
// taps/wts the two taps of the interpolation matrices, and/or lanes != 0, guide the tap lanes
// [3*fy*fx, S, H/fy, W/fx]
extern "C" int vst_temporal_refine(const void* alpha, const void* prev,
                                   const void* yi, const void* xi,
                                   const void* guide, const void* knobs,
                                   const void* prior, const void* taps,
                                   const void* wts, void* new_prev, void* out,
                                   int out_f32, int lanes, int S, int H, int W,
                                   int h0, int w0, int fy, int fx, int pad,
                                   void* stream) {
  const bool lowres = taps != nullptr;
  if (prior != nullptr && (lowres || lanes)) return (int)cudaErrorInvalidValue;
  if (prior != nullptr)
    return launch<true, true>(alpha, prev, yi, xi, guide, knobs, prior,
                              new_prev, out, out_f32, S, H, W, pad, stream);
#define FAST(L, N)                                                          \
  launch<true, false, L, N>(alpha, prev, yi, xi, guide, knobs, nullptr,     \
                            new_prev, out, out_f32, S, H, W, pad, stream,   \
                            taps, wts, h0, w0, fy, fx)
  if (lowres) return lanes ? FAST(true, true) : FAST(true, false);
  return lanes ? FAST(false, true) : FAST(false, false);
#undef FAST
}

// stages 5-9 on alpha as it is, the prior plane, f32 out
extern "C" int vst_refine(const void* alpha, const void* guide,
                          const void* knobs, const void* prior, void* out,
                          int S, int H, int W, void* stream) {
  return launch<false, true>(alpha, nullptr, nullptr, nullptr, guide, knobs,
                             prior, nullptr, out, 1, S, H, W, 0, stream);
}
