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
// (L2 holds most of them); the pico/nano/femto trunk is 9 entry-point
// calls (d2dn, d2b, d3dn, d3b, ctx, the SE, u2red, u1red, the head):
//   * vst_conv_i8: the implicit-GEMM int8 convolution on the tensor cores
//     of csrc/wgmma_i8.cuh (conv_i8_kernel, its trunk instantiations: Cout
//     64 to 256 in one N tile), in its modes 0-2: the s8 requant with an
//     optional f32 addend (the up-path half of plan B's split 3x3 u2/u1, at
//     the output's grid or at half of it) and an optional s8 residual (plan
//     B's b1 block), the f32 output of the up-path convs, and ctx +
//     residual with relu6 in f32; the input optionally read through a
//     nearest x2 upsample (plan B's up-path 3x3 convs over nearest_x2 of
//     the level below).
//   * u2red and u1red, the split 1x1 decoder levels of every trunk but
//     plan B: csrc/decoder_int8.cu (both products of a level in one wgmma
//     kernel, the up product's f32 result kept in registers), one launch a
//     level, no f32 addend in device memory.
//   * vst_se_requant: the SE spread over the card in two kernels.  The
//     mean's partial sums (se_partial_kernel): (chunk, stream) blocks, at
//     most as many chunks of at least SE_MIN_CHUNK pixels a stream as the
//     caller's scratch buffer holds, each channel summed in double in pixel
//     order into it;
//     then se_apply_kernel over (piece, stream) blocks, about 2 x SMs of
//     them: each block adds its stream's partials in chunk order (no
//     atomics: the mean does not depend on the order blocks run in), runs
//     both dense layers in double and the sigmoid (each block of a stream
//     the same operations in the same order), and gates its piece: 16
//     channels a thread (four 16-byte loads of the plane, one of the
//     residual, one 16-byte store), the optional residual (res * 6/127, the
//     micro trunk's _Block), requant to s8.  It moves 35.5 MB at pico's S=64
//     (the f32 plane in, s8 out): bound by bytes.
//   * vst_alpha_head_i8: the 3x3 int8 alpha head with K output channels
//     (1 <= K <= ALPHA_HEAD_MAX_K; the served presets use K = 1 and the
//     multi-class K = 4) on the tensor cores, mma.sync m16n8k32 s8 -> s32
//     with the classes padded by zero rows to 8 (K <= 8) or 16: the head is
//     bound by bytes (75.5 MB of u1 in at pico's S=64 against 10.6 M
//     multiply-adds a class a stream), so the idle columns cost nothing
//     that matters, while __dp4a would spend a lane-instruction on every 4
//     bytes of every tap of every class.  Persistent blocks (one an SM)
//     walk units of HEAD_BAND output rows x TW columns of a stream; a unit's
//     input rows with a halo row and column on each side (zeros at the SAME
//     padding and past H and W) go into shared memory by 16-byte cp.async,
//     double-buffered (the next unit loads while this one computes), so an
//     input byte comes from device memory at most (HEAD_BAND + 2) /
//     HEAD_BAND times; the weights are staged once a block.  Pixels and
//     weight rows are 16-byte-chunk XOR-swizzled, so ldmatrix reads them
//     free of bank conflicts.  Each warp owns a 16-column strip of the
//     unit: for each 32-channel slice and tap column it loads the three tap
//     rows' B fragments once and each of the HEAD_BAND + 2 input rows' A
//     fragment once, and adds that product into the up to three output rows
//     the input row feeds (so the nine taps cost 1.5 A loads an output row,
//     not nine).  f32 logits [S, H, W, K] = acc * mult[k] + bias[k], the
//     plain version's order.  This is the Pallas head's K-class form
//     (trunk_int8.py:_alpha_head_consts, quad columns qo*K + k), written in
//     the natural layout: no quad fold to undo.
// What the trunk leaves on the table: each layer is still one launch with
// its activations in device memory; the conv is one output tile a block
// (no persistent blocks, no TMA, the epilogue not overlapped with the next
// tile's loads).  Fusing layers so that activations stay on chip is later
// work.  Times beside each launch's bound: PERF.md section 6.

#include "wgmma_i8.cuh"

#define ALPHA_HEAD_MAX_K 16
#define HEAD_BAND 4            // output rows a unit
#define HEAD_THREADS 256       // 8 warps: a 16-column strip of the unit each
#define HEAD_MAX_TW 128        // output columns a unit at most
#define HEAD_MAX_SMEM 232448   // the most a block may use on Hopper (227 KB)
#define SE_MIN_CHUNK 32        // pixels a partial sum at least

// ---- the SE ------------------------------------------------------------

// The SE's mean, first pass: block (chunk, s) sums pixels [chunk PC, +PC)
// of stream s's [P, C] f32 plane, each channel in double, in pixel order,
// into part[s][chunk][C].  No atomics: the second pass adds the chunks in
// their order, so the mean does not depend on the order blocks run in.
extern "C" __global__ void se_partial_kernel(const float* __restrict__ ctx,
                                             double* __restrict__ part, int P,
                                             int C, int PC) {
  const int s = blockIdx.y, ch = blockIdx.x;
  const int p0 = ch * PC, p1 = min(P, p0 + PC);
  const float* xs = ctx + (size_t)s * P * C;
  double* ps = part + ((size_t)s * gridDim.x + ch) * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    double acc = 0.0;
#pragma unroll 8
    for (int p = p0; p < p1; ++p) acc += (double)__ldg(xs + (size_t)p * C + c);
    ps[c] = acc;
  }
}

// The SE's second pass: block (piece, s) adds stream s's partial sums in
// chunk order (the mean), runs both dense layers in double and the sigmoid
// (each block of the stream the same, in the same order; the weights'
// loads unrolled so that several are in flight), then gates
// pixels [piece PA, +PA) of the stream, adds the residual (res * 6/127,
// where res is given) and requantizes to s8, 16 channels a thread at a
// time (four 16-byte loads of the plane, one of the residual, one 16-byte
// store; C a multiple of 16).
extern "C" __global__ void se_apply_kernel(
    const float* __restrict__ ctx, const double* __restrict__ part,
    const float* __restrict__ k0, const float* __restrict__ b0,
    const float* __restrict__ k1, const float* __restrict__ b1,
    const int8_t* __restrict__ res, int8_t* __restrict__ out, int P, int C,
    int R, int nchunks, int PA) {
  // the first dense layer runs on every thread: hidden unit r = t % R
  // sums the channel slice t / R (of `parts`), then the slices in order
  const int parts = (int)blockDim.x >= R ? (int)blockDim.x / R : 1;
  const int cs = (C + parts - 1) / parts;
  extern __shared__ double sh[];
  double* mean = sh;                // [C]
  double* hid = sh + C;             // [R]
  double* slice = sh + C + R;       // [parts][R]
  float* gate = reinterpret_cast<float*>(sh + C + R + parts * R);  // [C]
  const int s = blockIdx.y;
  const double* ps = part + (size_t)s * nchunks * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    double acc = 0.0;
#pragma unroll 4
    for (int ch = 0; ch < nchunks; ++ch) acc += ps[(size_t)ch * C + c];
    mean[c] = acc / (double)P;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < parts * R; t += blockDim.x) {
    const int r = t % R, c0 = (t / R) * cs, c1 = min(C, c0 + cs);
    double acc = 0.0;
#pragma unroll 8
    for (int c = c0; c < c1; ++c) acc += mean[c] * (double)__ldg(k0 + (size_t)c * R + r);
    slice[t] = acc;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    double acc = 0.0;
    for (int q = 0; q < parts; ++q) acc += slice[q * R + r];
    acc += (double)b0[r];
    hid[r] = acc > 0.0 ? acc : 0.0;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    double acc = 0.0;
#pragma unroll 8
    for (int r = 0; r < R; ++r) acc += hid[r] * (double)__ldg(k1 + (size_t)r * C + c);
    acc += (double)b1[c];
    gate[c] = (float)(1.0 / (1.0 + exp(-acc)));
  }
  __syncthreads();
  const int pa = blockIdx.x * PA;
  const int n = (min(P, pa + PA) - pa) * C;  // this block's elements
  const size_t e0 = ((size_t)s * P + pa) * C;
  const float* xs = ctx + e0;
  const int8_t* rs = res == nullptr ? nullptr : res + e0;
  int8_t* os = out + e0;
  for (int e = 16 * threadIdx.x; e < n; e += 16 * blockDim.x) {
    const int c = e % C;
    float y[16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(xs + e) + i);
      y[4 * i] = v.x * gate[c + 4 * i];
      y[4 * i + 1] = v.y * gate[c + 4 * i + 1];
      y[4 * i + 2] = v.z * gate[c + 4 * i + 2];
      y[4 * i + 3] = v.w * gate[c + 4 * i + 3];
    }
    if (rs != nullptr) {
      const int4 rv = __ldg(reinterpret_cast<const int4*>(rs + e));
      const int8_t* rb = reinterpret_cast<const int8_t*>(&rv);
#pragma unroll
      for (int i = 0; i < 16; ++i) y[i] = y[i] + (float)rb[i] * ACT_SCALE;
    }
    int4 o;
    int8_t* ob = reinterpret_cast<int8_t*>(&o);
#pragma unroll
    for (int i = 0; i < 16; ++i) ob[i] = requant(y[i]);
    *reinterpret_cast<int4*>(os + e) = o;
  }
}

// ---- the alpha head ------------------------------------------------------

// 16-byte chunk j of row r (rows of `chunks` chunks, `full8` = the chunks
// in whole groups of 8): XOR-swizzled by r mod 8 inside each whole group,
// so that the 8 rows an ldmatrix phase reads (8 consecutive r, one logical
// chunk, rows a multiple of 128 bytes apart) fall in 8 different 16-byte
// bank groups
__device__ __forceinline__ int head_swz(int j, int r, int full8) {
  return j < full8 ? (j ^ (r & 7)) : j;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&d)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&d)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(d[0]), "=r"(d[1])
               : "r"(addr)
               : "memory");
}

// D[16 x 8] (s32) += A[16 x 32] . B[32 x 8], s8.  A: a[0] rows 0-7 and a[1]
// rows 8-15 at k 0-15, a[2]/a[3] the same rows at k 16-31 (4 bytes a
// thread: row lane/4, k 4 (lane%4)); B: b0 k 0-15, b1 k 16-31 of column
// lane/4; D: d[0..1] row lane/4, d[2..3] row lane/4 + 8, columns 2 (lane%4)
// and + 1.
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 3x3 SAME int8 conv to K output channels (weights OHWI [K, 3, 3,
// Cin], K <= 8 NT): f32 logits [S, H, W, K] = acc * mult[k] + bias[k].
// Persistent blocks walk units of HEAD_BAND output rows x TW output
// columns of one stream (unit u: stream, row band, column tile, columns
// fastest), double-buffered: unit u + gridDim.x's input tile (HEAD_BAND +
// 2 rows x TW + 2 columns x Cin, zeros at the SAME padding and past H and
// W) is in flight (16-byte cp.async) while unit u computes.  The weights,
// padded to 8 NT classes with zero rows, are staged once a block.  Warp w
// owns the 16-column strip 16 w of the unit and all its rows: for each
// 32-channel slice and tap column q it loads the B fragments of the three
// tap rows once, then the A fragment of each of the tile's HEAD_BAND + 2
// input rows once (ldmatrix), and adds that row's product into each of the
// up to three output rows it feeds (m16n8k32).
template <int NT>
__global__ void __launch_bounds__(HEAD_THREADS, 1)
alpha_head_i8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ mult, const float* __restrict__ bias,
                     float* __restrict__ out, int S, int H, int W, int Cin, int K,
                     int TW) {
  constexpr int NP = 8 * NT;  // classes padded to whole n8 tiles
  constexpr int ROWS = HEAD_BAND + 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = align1024(smem_raw);
  const int tcols = TW + 2;
  const int cpp = Cin >> 4, full8 = cpp & ~7;  // 16-byte chunks a pixel
  const uint32_t tile_bytes = (uint32_t)(ROWS * tcols * Cin);
  const uint32_t w_s = base + 2 * tile_bytes;
  float* const mb = reinterpret_cast<float*>(
      smem_raw + (w_s + (uint32_t)(NP * 9 * Cin) - smem_u32(smem_raw)));  // mult, bias
  const int tid = threadIdx.x;
  const int tiles_y = (H + HEAD_BAND - 1) / HEAD_BAND, tiles_x = (W + TW - 1) / TW;
  const int units = S * tiles_y * tiles_x;  // the launcher keeps it below 2^31

  // the weights, once: row n * 9 + tap of Cin bytes, rows past K zero
  for (int idx = tid; idx < NP * 9 * cpp; idx += HEAD_THREADS) {
    const int j = idx % cpp, row = idx / cpp, n = row / 9;
    const bool ok = n < K;
    cp_async16(w_s + (uint32_t)(row * Cin + 16 * head_swz(j, n, full8)),
               ok ? w + (size_t)row * Cin + 16 * j : w, ok);
  }
  for (int i = tid; i < NP; i += HEAD_THREADS) {
    mb[i] = i < K ? mult[i] : 0.0f;
    mb[NP + i] = i < K ? bias[i] : 0.0f;
  }

  // unit u's input tile into dst: this thread's chunk j of pixels p, p +
  // HEAD_THREADS / cpp, ... (carried without a division a chunk)
  const int dj = HEAD_THREADS % cpp, dp = HEAD_THREADS / cpp;
  auto load_unit = [&](int u, uint32_t dst) {
    const int bx = u % tiles_x, t = u / tiles_x;
    const int by = t % tiles_y, s = t / tiles_y;
    const int y0 = by * HEAD_BAND - 1, x0 = bx * TW - 1;
    const int8_t* xin = x + (size_t)s * H * W * Cin;
    int j = tid % cpp, p = tid / cpp;
    int r = p / tcols, c = p - r * tcols;
    while (r < ROWS) {
      const int iy = y0 + r, ix = x0 + c;
      const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W;
      cp_async16(dst + (uint32_t)(p * Cin + 16 * head_swz(j, p, full8)),
                 ok ? xin + ((size_t)iy * W + ix) * Cin + 16 * j : x, ok);
      j += dj;
      p += dp;
      c += dp;
      if (j >= cpp) {
        j -= cpp;
        ++p;
        ++c;
      }
      while (c >= tcols) {
        c -= tcols;
        ++r;
      }
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int xs = 16 * warp;  // this warp's strip in the unit
  // this lane's ldmatrix rows: A, pixel (lane & 7) + 8 ((lane >> 3) & 1) of
  // the strip at K half lane >> 4; B, class (lane & 7) + 8 (lane >> 4)
  // (NT = 2; lanes 16-31 give no address at NT = 1) at K half (lane >> 3) & 1
  const int a_px = (lane & 7) + 8 * ((lane >> 3) & 1), a_half = lane >> 4;
  const int b_n = (lane & 7) + 8 * ((lane >> 4) & (NT - 1)), b_half = (lane >> 3) & 1;
  const int g = lane >> 2, tig = lane & 3;

  int u = blockIdx.x;
  if (u < units) load_unit(u, base);
  cp_async_commit();
#pragma unroll 1
  for (int i = 0; u < units; u += gridDim.x, ++i) {
    const uint32_t tile = base + (uint32_t)(i & 1) * tile_bytes;
    if (u + (int)gridDim.x < units)
      load_unit(u + gridDim.x, base + (uint32_t)((i + 1) & 1) * tile_bytes);
    cp_async_commit();
    cp_async_wait<1>();  // unit u (and, the first time, the weights) landed
    __syncthreads();
    if (xs < TW) {
      int acc[HEAD_BAND][NT][4];
#pragma unroll
      for (int oy = 0; oy < HEAD_BAND; ++oy)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[oy][nt][v] = 0;
#pragma unroll 1
      for (int kc = 0; kc < (Cin >> 5); ++kc) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          uint32_t b[3][NT][2];
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            const uint32_t addr = w_s + (uint32_t)((b_n * 9 + 3 * r + q) * Cin +
                                                   16 * head_swz(2 * kc + b_half, b_n, full8));
            if (NT == 2) {
              uint32_t d[4];
              ldsm_x4(d, addr);
              b[r][0][0] = d[0];
              b[r][0][1] = d[1];
              b[r][NT - 1][0] = d[2];
              b[r][NT - 1][1] = d[3];
            } else {
              uint32_t d[2];
              ldsm_x2(d, addr);
              b[r][0][0] = d[0];
              b[r][0][1] = d[1];
            }
          }
          uint32_t a[ROWS][4];
#pragma unroll
          for (int iy = 0; iy < ROWS; ++iy) {
            const int p = iy * tcols + xs + q + a_px;
            ldsm_x4(a[iy], tile + (uint32_t)(p * Cin + 16 * head_swz(2 * kc + a_half, p, full8)));
          }
#pragma unroll
          for (int iy = 0; iy < ROWS; ++iy)
#pragma unroll
            for (int r = 0; r < 3; ++r) {
              const int oy = iy - r;  // input row iy feeds output row oy through tap row r
              if (oy < 0 || oy >= HEAD_BAND) continue;
#pragma unroll
              for (int nt = 0; nt < NT; ++nt) mma_s8_16832(acc[oy][nt], a[iy], b[r][nt][0], b[r][nt][1]);
            }
        }
      }
      // the epilogue in the plain version's order: acc * mult + bias (f32)
      const int bx = u % tiles_x, t = u / tiles_x;
      const int by = t % tiles_y, s = t / tiles_y;
#pragma unroll
      for (int oy = 0; oy < HEAD_BAND; ++oy) {
        const int gy = by * HEAD_BAND + oy;
        if (gy >= H) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gx = bx * TW + xs + g + 8 * h;
          if (gx >= W) continue;
          float* o = out + (((size_t)s * H + gy) * W + gx) * K;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = 8 * nt + 2 * tig + e;
              if (n < K) o[n] = (float)acc[oy][nt][2 * h + e] * mb[n] + mb[NP + n];
            }
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it refills
  }
  cp_async_wait<0>();
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

// C a multiple of 16 (16-byte loads and stores); part: max_chunks * S * C
// doubles of scratch (the caller's); two launches: the partial sums over S
// x nchunks blocks (at most max_chunks of at least SE_MIN_CHUNK pixels a
// stream), then gate and requant over S x about 2 x SMs / S blocks; 0 or
// the CUDA error
extern "C" int vst_se_requant(const void* ctx, const void* k0, const void* b0,
                              const void* k1, const void* b1, const void* res,
                              void* out, void* part, int S, int P, int C, int R,
                              int max_chunks, void* stream) {
  if (S < 0 || P < 0 || C < 16 || C % 16 || R < 1 || S > 65535 || max_chunks < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)S * P == 0) return 0;
  if ((long long)S * P * C >= (1LL << 40) || (long long)P * C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  int err = current_device(&dev, &sms);
  if (err != 0) return err;
  int pc = (P + max_chunks - 1) / max_chunks;  // so that nchunks <= max_chunks
  if (pc < SE_MIN_CHUNK) pc = SE_MIN_CHUNK;
  const int nchunks = (P + pc - 1) / pc;
  int threads = (C + 31) / 32 * 32;
  if (threads > 256) threads = 256;
  cudaStream_t st = (cudaStream_t)stream;
  se_partial_kernel<<<dim3((unsigned)nchunks, (unsigned)S), threads, 0, st>>>(
      (const float*)ctx, (double*)part, P, C, pc);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  int pieces = (2 * sms + S - 1) / S;
  if (pieces > (P + 15) / 16) pieces = (P + 15) / 16;
  const int pa = (P + pieces - 1) / pieces;
  pieces = (P + pa - 1) / pa;
  const int parts = 256 >= R ? 256 / R : 1;  // se_apply_kernel's first-layer slices
  const size_t smem =
      (size_t)(C + R + parts * R) * sizeof(double) + (size_t)C * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  se_apply_kernel<<<dim3((unsigned)pieces, (unsigned)S), 256, smem, st>>>(
      (const float*)ctx, (const double*)part, (const float*)k0, (const float*)b0,
      (const float*)k1, (const float*)b1, (const int8_t*)res, (int8_t*)out, P, C, R,
      nchunks, pa);
  return (int)cudaGetLastError();
}

// the dynamic shared memory of a head block: two input tiles, the weights
// of 8 nt classes, their mult and bias, 1 KB to align
static size_t head_smem(int tw, int cin, int nt) {
  return (size_t)2 * (HEAD_BAND + 2) * (tw + 2) * cin + (size_t)8 * nt * 9 * cin +
         (size_t)2 * 8 * nt * sizeof(float) + 1024;
}

template <int NT>
static int launch_head(const void* x, const void* w, const void* mult, const void* bias,
                       void* out, int S, int H, int W, int Cin, int K, int TW,
                       cudaStream_t stream) {
  // the opt-in above 48 KB once a device; then one block an SM at most (the
  // tiles take most of its shared memory), persistent over the units
  static bool sized[VST_MAX_DEVICES] = {};
  int dev = 0, sms = 0;
  int err = current_device(&dev, &sms);
  if (err == 0) err = opt_in_smem(alpha_head_i8_kernel<NT>, HEAD_MAX_SMEM, sized, dev);
  if (err != 0) return err;
  const long long units = (long long)S * ((H + HEAD_BAND - 1) / HEAD_BAND) * ((W + TW - 1) / TW);
  if (units >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const size_t smem = head_smem(TW, Cin, NT);
  const int per_sm = (int)(HEAD_MAX_SMEM / smem);
  long long grid = (long long)sms * (per_sm < 1 ? 1 : per_sm);
  if (grid > units) grid = units;
  alpha_head_i8_kernel<NT><<<(unsigned)grid, HEAD_THREADS, smem, stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const float*)mult, (const float*)bias,
      (float*)out, S, H, W, Cin, K, TW);
  return (int)cudaGetLastError();
}

// 1 <= K <= ALPHA_HEAD_MAX_K, Cin a multiple of 32 whose tiles fit in
// shared memory at 16 columns at least; a unit is TW columns wide, the
// widest multiple of 16 up to HEAD_MAX_TW that W needs and shared memory
// holds; 0 or the CUDA error
extern "C" int vst_alpha_head_i8(const void* x, const void* w,
                                 const void* mult, const void* bias, void* out,
                                 int S, int H, int W, int Cin, int K,
                                 void* stream) {
  if (K < 1 || K > ALPHA_HEAD_MAX_K || Cin < 32 || Cin % 32 || S < 0 || H < 0 || W < 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)S * H * W == 0) return 0;
  const int nt = K > 8 ? 2 : 1;
  int tw = (W + 15) / 16 * 16;
  if (tw > HEAD_MAX_TW) tw = HEAD_MAX_TW;
  while (tw > 16 && head_smem(tw, Cin, nt) > HEAD_MAX_SMEM) tw -= 16;
  if (head_smem(tw, Cin, nt) > HEAD_MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (nt == 2)
    return launch_head<2>(x, w, mult, bias, out, S, H, W, Cin, K, tw, (cudaStream_t)stream);
  return launch_head<1>(x, w, mult, bias, out, S, H, W, Cin, K, tw, (cudaStream_t)stream);
}
