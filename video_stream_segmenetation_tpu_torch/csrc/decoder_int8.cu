// Fused int8 decoder level for Hopper (sm_90a): the port of the Pallas
// kernel video_stream_segmenetation_tpu/kernels/decoder_int8.py::
// fused_decoder_level (body _kernel, pallas_call in _run), i.e. the
// split 1x1 decoder conv of models/quantized.py::split_conv_up:
//
//   out = requant(nearest_x2(small @ Wa * mult + bias) + skip @ Wb * mult)
//
// small [S, sh, sw, Ca] s8, skip and out [S, 2sh, 2sw, Cb|Cout] s8, Wa
// [Cout, Ca] and Wb [Cout, Cb] s8 (the up-path and skip halves of the 1x1
// weights, output-channel major: K-major, as wgmma takes them).  Sums are
// exact s32; the f32 epilogue runs in the reference's order: yaf = acc_a *
// mult + bias, then y = yaf + acc_b * mult, then round(clip(y, 0, 6) *
// 127/6) half-even.  Built with --fmad=false, so no fused multiply-add
// changes a rounding.
//
// What bounds it on an H100: bytes.  At micro's u1 level (S=64, small
// [64,36,64,192], skip and out [64,72,128,128]) it moves 179 MB against
// 13.3 G multiply-adds; the u2 level 66 MB against 7.2 G: about 0.073 ms
// by bytes at 3.35 TB/s against 0.021 ms by int8 operations.  The two
// launches the trunk would take for it (an f32 up-path conv, then the skip
// conv adding it) write and read back a 4-byte addend a parent channel.
//
// Design: the TPU kernel holds one stream's level in VMEM and folds the
// column parity into lanes; that layout does not carry over.  Here a tile
// is 64 parents (flattened over S, sh, sw; a tile may end inside a stream
// or past the last parent, whose rows load as zeros and store nothing)
// and their 256 children, over an N tile of 64 NU output channels, one
// warpgroup (128 threads) for each 64 of them:
//   * the up product, small[64 parents] . Wa^T, one wgmma m64n64k32 a
//     warpgroup and 32-byte K slice; its epilogue leaves yaf in f32
//     registers, never in memory;
//   * four skip products, one for each child position (dy, dx): row r of
//     the product is the child (dy, dx) of the tile's parent r, so each
//     thread's accumulator rows are the parents whose yaf it already
//     holds; the epilogue adds yaf and requantizes, and each warp stages
//     its 16 rows x 64 columns in shared memory and stores them as 16-byte
//     pieces of the children's rows (a __syncwarp, no block barrier).
// Both weight halves of the block's N tile are staged in shared memory
// once (128-byte-swizzled, K in slabs of 128 bytes, rows past Cout zero)
// and each thread keeps its columns' mult in registers: blocks are
// persistent and walk tiles blockIdx.x, + gridDim.x, ...  The activations
// stream through a ring of DEC_STAGES stages of 64 rows x 128 bytes of K:
// a tile is ceil(Ca/128) stages of parent rows, then for each child
// position ceil(Cb/128) stages of its rows, gathered with 16-byte cp.async
// (row p's child (dy, dx) at (2 py + dy, 2 px + dx)), the rows' places
// found once a tile and the stages counted, not divided.  The loads run
// DEC_STAGES - 1 stages ahead, across tile boundaries, while the tensor
// cores and the epilogues work.

#include "wgmma_i8.cuh"

#define DEC_P 64          // parents a tile: one m64 product
#define DEC_STAGES 6      // the activation ring
#define DEC_STAGE_BYTES (DEC_P * 128)
#define DEC_MAX_SMEM 232448  // the most a block may use on Hopper (227 KB)
#define DEC_MAX_SLABS (DEC_MAX_SMEM / (64 * 128))  // weight slabs that could fit

// Where a stream of stages stands: stage `slab` of product `phase` (0 the
// up product over ceil(Ca/128) slabs, 1-4 the skip products of child
// position 2 dy + dx = phase - 1 over ceil(Cb/128) slabs) of the block's
// tile `tile`, in ring slot `slot`.  Counters, so that no stage divides.
struct DecStage {
  int tile, phase, slab, slot;
  __device__ __forceinline__ void next(int sa, int sb, int tile_step) {
    if (++slot == DEC_STAGES) slot = 0;
    if (++slab < (phase == 0 ? sa : sb)) return;
    slab = 0;
    if (++phase < 5) return;
    phase = 0;
    tile += tile_step;
  }
};

// NU warpgroups of 128 threads, each 64 of the N tile's 64 NU columns; as
// many blocks an SM as keep 128 registers a thread at NU <= 2
template <int NU>
__global__ void __launch_bounds__(128 * NU, NU == 1 ? 4 : NU == 2 ? 2 : 1)
decoder_level_i8_kernel(const int8_t* __restrict__ small,
                        const int8_t* __restrict__ skip,
                        const int8_t* __restrict__ wa,
                        const int8_t* __restrict__ wb,
                        const float* __restrict__ mult,
                        const float* __restrict__ bias,
                        int8_t* __restrict__ out, int S, int sh, int sw,
                        int Ca, int Cb, int Cout) {
  constexpr int THREADS = 128 * NU;
  constexpr int NB = 64 * NU;  // output channels a block, 64 a warpgroup
  constexpr int NR = 32;       // accumulator registers a thread (m64n64)
  constexpr int RSTEP = THREADS / 8;                  // rows a load step
  constexpr int NROWS = (DEC_P + RSTEP - 1) / RSTEP;  // a thread's rows a stage
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = align1024(smem_raw);
  const int sa = (Ca + 127) >> 7, sb = (Cb + 127) >> 7;  // K slabs
  const uint32_t wa_s = ring + DEC_STAGES * DEC_STAGE_BYTES;
  const uint32_t wb_s = wa_s + (uint32_t)(sa * NB * 128);
  // after the weights: the bias of the N tile, then the staging tile of a
  // child position (each warp stages and stores its own 16 rows x 64
  // columns, so a __syncwarp orders them)
  uint8_t* const tail = smem_raw + (wb_s + (uint32_t)(sb * NB * 128) - smem_u32(smem_raw));
  float* const bias_s = reinterpret_cast<float*>(tail);
  uint8_t* const stage_out = tail + 4 * NB;
  constexpr int SROW = NB + 16;  // the staging tile's row stride: no bank conflicts

  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * NB;
  const int shw = sh * sw, bh = 2 * sh, bw = 2 * sw;
  const int Mp = S * shw;  // parents (the launcher keeps it below 2^31)
  const int ntiles = (Mp + DEC_P - 1) / DEC_P;
  const int my_tiles =
      (int)blockIdx.x < ntiles ? (ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int total = my_tiles * (sa + 4 * sb);  // stages this block consumes

  // both weight halves of this N tile, once: slab-major [slab][NB rows][128]
  for (int idx = tid; idx < (sa + sb) * NB * 8; idx += THREADS) {
    const int c = idx & 7, row = (idx >> 3) % NB, slab = (idx >> 3) / NB;
    const bool is_a = slab < sa;
    const int kslab = is_a ? slab : slab - sa, C = is_a ? Ca : Cb;
    const int k = 128 * kslab + 16 * c;
    const bool ok = n0 + row < Cout && k < C;
    const int8_t* src = ok ? (is_a ? wa : wb) + (size_t)(n0 + row) * C + k : wa;
    cp_async16((is_a ? wa_s : wb_s) + (uint32_t)(kslab * NB * 128) + swz(row, c), src, ok);
  }
  cp_async_commit();
  for (int i = tid; i < NB; i += THREADS) bias_s[i] = n0 + i < Cout ? bias[n0 + i] : 0.0f;

  // the loads: this thread's 16-byte chunk j of rows r0 + RSTEP i (those
  // below 64) of a stage; each tile's parents of those rows found once
  // (row i's parent in small and its first child in skip; null past the
  // last parent)
  const int j = tid & 7, r0 = tid >> 3;
  DecStage ld = {(int)blockIdx.x, 0, 0, 0};
  const int8_t* ld_small[NROWS];
  const int8_t* ld_skip[NROWS];
  auto load_next = [&]() {
    if (ld.phase == 0 && ld.slab == 0) {
#pragma unroll
      for (int i = 0; i < NROWS; ++i) {
        const int p = ld.tile * DEC_P + r0 + RSTEP * i;
        const int s = p / shw, rem = p - s * shw;
        const int py = rem / sw, px = rem - py * sw;
        ld_small[i] = p < Mp ? small + (size_t)p * Ca : nullptr;
        ld_skip[i] = skip + (((size_t)s * bh + 2 * py) * bw + 2 * px) * Cb;
      }
    }
    const uint32_t dst = ring + (uint32_t)(ld.slot * DEC_STAGE_BYTES);
    const int k = 128 * ld.slab + 16 * j;
    const bool k_ok = k < (ld.phase == 0 ? Ca : Cb);
    const int q = ld.phase - 1;
    const size_t child = ld.phase == 0 ? 0 : ((size_t)(q >> 1) * bw + (q & 1)) * Cb;
#pragma unroll
    for (int i = 0; i < NROWS; ++i) {
      if (r0 + RSTEP * i >= DEC_P) break;
      const bool ok = k_ok && ld_small[i] != nullptr;
      const int8_t* src = !ok ? small : ld.phase == 0 ? ld_small[i] + k : ld_skip[i] + child + k;
      cp_async16(dst + swz(r0 + RSTEP * i, j), src, ok);
    }
    ld.next(sa, sb, gridDim.x);
  };

#pragma unroll 1
  for (int g = 0; g < DEC_STAGES - 1; ++g) {
    if (g < total) load_next();
    cp_async_commit();
  }

  const int wg = tid >> 7, lane = tid & 31, warp = (tid >> 5) & 3;
  const int col0 = wg * 64 + 2 * (lane & 3);  // in the N tile; + 8 (v/4) + v%2
  const int wid = Cout - n0 < NB ? Cout - n0 : NB;  // the N tile's columns in out
  // mult of this thread's columns (col0 + 8 c + e at 2 c + e), in registers
  // for the block's life: the epilogues then load nothing
  float mcol[NR / 2];
#pragma unroll
  for (int i = 0; i < NR / 2; ++i) {
    const int n = n0 + col0 + 8 * (i >> 1) + (i & 1);
    mcol[i] = n < Cout ? __ldg(mult + n) : 0.0f;
  }
  int acc[NR];
  float yaf[NR];
  long long obase[2];  // this thread's two parents' first child in out, or -1
  DecStage cs = {(int)blockIdx.x, 0, 0, 0};
#pragma unroll 1
  for (int g = 0; g < total; ++g) {
    // stage g (and, at g = 0, the weights) landed for this thread; the
    // fence hands them to the async proxy, the barrier to every thread and
    // tells that both warpgroups' products on stage g - 1 are done
    cp_async_wait<DEC_STAGES - 2>();
    fence_proxy_async();
    __syncthreads();
    if (cs.slab == 0) {
#pragma unroll
      for (int v = 0; v < NR; ++v) acc[v] = 0;
    }
    const int kleft = (cs.phase == 0 ? Ca : Cb) - 128 * cs.slab;
    const uint32_t a_s = ring + (uint32_t)(cs.slot * DEC_STAGE_BYTES);
    const uint32_t b_s =
        (cs.phase == 0 ? wa_s : wb_s) + (uint32_t)(cs.slab * NB * 128 + wg * 64 * 128);
#pragma unroll
    for (int v = 0; v < NR; ++v) fence_acc(acc[v]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (32 * kk < kleft)
        wgmma_m64n64k32(acc, wgmma_desc(a_s + 32 * kk), wgmma_desc(b_s + 32 * kk));
    wgmma_commit();
    // the next loads go to the slot that g - 1 used, while this one runs
    if (g + DEC_STAGES - 1 < total) load_next();
    cp_async_commit();
    wgmma_wait_all();
#pragma unroll
    for (int v = 0; v < NR; ++v) fence_acc(acc[v]);
    const int phase = cs.phase, tile = cs.tile;
    cs.next(sa, sb, gridDim.x);
    if (kleft > 128) continue;  // the product goes on in the next stage

    if (phase == 0) {
      // the up product is done: yaf for this thread's parents and columns,
      // and the places of those parents' children in out
#pragma unroll
      for (int v = 0; v < NR; ++v) {
        const int n = col0 + 8 * (v >> 2) + (v & 1);
        yaf[v] = (float)acc[v] * mcol[2 * (v >> 2) + (v & 1)] + bias_s[n];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = tile * DEC_P + warp * 16 + (lane >> 2) + 8 * h;
        const int s = p / shw, rem = p - s * shw;
        const int py = rem / sw, px = rem - py * sw;
        obase[h] = p < Mp ? (((long long)s * bh + 2 * py) * bw + 2 * px) * Cout + n0 : -1;
      }
      continue;
    }
    // a skip product is done: its children's outputs, through this warp's
    // part of the staging tile, so that each thread stores 16 bytes of a
    // child's row (the 4 threads of a row: its 64 columns)
    const int q = phase - 1;
    const long long child = ((long long)(q >> 1) * bw + (q & 1)) * Cout;
    const int col = wg * 64 + 16 * (lane & 3);  // this thread's 16 columns
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint8_t* const srow = stage_out + (warp * 16 + (lane >> 2) + 8 * h) * SROW;
#pragma unroll
      for (int c = 0; c < NR / 4; ++c) {
        const int v = 4 * c + 2 * h;
        *reinterpret_cast<char2*>(srow + col0 + 8 * c) =
            make_char2(requant(yaf[v] + (float)acc[v] * mcol[2 * c]),
                       requant(yaf[v + 1] + (float)acc[v + 1] * mcol[2 * c + 1]));
      }
      __syncwarp();
      if (obase[h] < 0 || col >= wid) continue;
      const uint8_t* src = srow + col;
      int8_t* dst = out + obase[h] + child + col;
      if (col + 16 <= wid && (Cout & 15) == 0) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int b = 0; b < 16 && col + b < wid; ++b) dst[b] = (int8_t)src[b];
      }
    }
  }
  cp_async_wait<0>();
}

// the dynamic shared memory of a block: the ring, both weight halves of an
// N tile of NB = 64 NU channels, its bias, the staging tile, 1 KB to align
static size_t decoder_smem(int nu, int Ca, int Cb) {
  const size_t nb = 64 * nu;
  return (size_t)DEC_STAGES * DEC_STAGE_BYTES + nb * 128 * ((Ca + 127) / 128 + (Cb + 127) / 128) +
         4 * nb + DEC_P * (nb + 16) + 1024;
}

template <int NU>
static int launch_decoder(const void* small, const void* skip, const void* wa,
                          const void* wb, const void* mult, const void* bias,
                          void* out, int S, int sh, int sw, int Ca, int Cb,
                          int Cout, cudaStream_t stream) {
  const size_t smem = decoder_smem(NU, Ca, Cb);
  // The blocks resident on the whole card (the persistent grid) depend on
  // the device and, through smem, on the weight slabs: worked out at the
  // first launch of this instantiation on a device at a slab count (with
  // the opt-in above 48 KB at the device's first), then reused; 0 until.
  static bool sized[VST_MAX_DEVICES] = {};
  static int resident[VST_MAX_DEVICES][DEC_MAX_SLABS + 1] = {};
  const int slabs = (Ca + 127) / 128 + (Cb + 127) / 128;
  if (slabs > DEC_MAX_SLABS) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  int e = current_device(&dev, &sms);
  if (e != 0) return e;
  if (resident[dev][slabs] == 0) {
    if ((e = opt_in_smem(decoder_level_i8_kernel<NU>, DEC_MAX_SMEM, sized, dev)) != 0) return e;
    int per_sm = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, decoder_level_i8_kernel<NU>, 128 * NU, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident[dev][slabs] = sms * per_sm;
  }
  const int n_tiles = (Cout + 64 * NU - 1) / (64 * NU);
  const long long tiles = ((long long)S * sh * sw + DEC_P - 1) / DEC_P;
  long long gx = ((long long)resident[dev][slabs] + n_tiles - 1) / n_tiles;
  if (gx > tiles) gx = tiles;
  if (gx < 1) return 0;  // nothing to compute
  decoder_level_i8_kernel<NU><<<dim3((unsigned)gx, (unsigned)n_tiles), 128 * NU, smem,
                                stream>>>(
      (const int8_t*)small, (const int8_t*)skip, (const int8_t*)wa, (const int8_t*)wb,
      (const float*)mult, (const float*)bias, (int8_t*)out, S, sh, sw, Ca, Cb, Cout);
  return (int)cudaGetLastError();
}

// Ca and Cb multiples of 32, Cout >= 1; the N tile is the widest of 256,
// 192, 128 or 64 channels, not wider than Cout needs, whose weights fit in
// shared memory beside the ring; 0 or the CUDA error
extern "C" int vst_decoder_level_i8(const void* small, const void* skip,
                                    const void* wa, const void* wb,
                                    const void* mult, const void* bias,
                                    void* out, int S, int sh, int sw, int Ca,
                                    int Cb, int Cout, void* stream) {
  if (Ca % 32 || Cb % 32 || Ca < 32 || Cb < 32 || Cout < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)S * sh * sw == 0) return 0;
  int nu = (Cout + 63) / 64;
  if (nu > 4) nu = 4;
  while (nu > 0 && decoder_smem(nu, Ca, Cb) > DEC_MAX_SMEM) --nu;
  if (nu == 0) return (int)cudaErrorInvalidValue;
  const long long stages =
      ((long long)S * sh * sw + DEC_P - 1) / DEC_P * ((Ca + 127) / 128 + 4 * ((Cb + 127) / 128));
  if ((long long)S * sh * sw + DEC_P >= (1LL << 31) || stages >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
#define DEC(NU)                                                                         \
  launch_decoder<NU>(small, skip, wa, wb, mult, bias, out, S, sh, sw, Ca, Cb, Cout, \
                     (cudaStream_t)stream)
  switch (nu) {
    case 1: return DEC(1);
    case 2: return DEC(2);
    case 3: return DEC(3);
    default: return DEC(4);
  }
#undef DEC
}
