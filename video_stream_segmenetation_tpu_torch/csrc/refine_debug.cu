// The fused temporal refine's bench-only debug variants (the reference's
// kernels/refine_fused.py `debug` tokens, bound at compile time, :86-138,
// :753): `debug` is DEBUG_NO_MORPH ('no_morph': stages 5 and 7 skipped),
// DEBUG_NO_BILATERAL ('no_bilateral': stage 8 skipped) or both, on the
// analytic, plane and fast forms (fifteen instances of the body).  A
// translation unit of its own, so that nvcc compiles them beside the
// serving ones.

#include "refine_fused.cuh"

extern "C" int vst_temporal_refine_debug(const void* alpha, const void* prev,
                                         const void* yi, const void* xi,
                                         const void* guide, const void* knobs,
                                         const void* prior, const void* taps,
                                         const void* wts, void* new_prev, void* out,
                                         int out_f32, int lanes, int S, int H, int W,
                                         int h0, int w0, int fy, int fx, int pad,
                                         int debug, float ema_t0, float ema_inv_ramp,
                                         void* stream) {
#define VARIANT(D)                                                                  \
  temporal_refine<D>(alpha, prev, yi, xi, guide, knobs, prior, taps, wts, new_prev, \
                     out, out_f32, lanes, S, H, W, h0, w0, fy, fx, pad, ema_t0,     \
                     ema_inv_ramp, stream)
  switch (debug) {
    case DEBUG_NO_MORPH:
      return VARIANT(DEBUG_NO_MORPH);
    case DEBUG_NO_BILATERAL:
      return VARIANT(DEBUG_NO_BILATERAL);
    case DEBUG_NO_MORPH | DEBUG_NO_BILATERAL:
      return VARIANT(DEBUG_NO_MORPH | DEBUG_NO_BILATERAL);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VARIANT
}
