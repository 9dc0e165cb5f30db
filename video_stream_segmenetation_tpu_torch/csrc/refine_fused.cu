// The serving forms of the fused refine kernels (the body and its design:
// refine_fused.cuh): the temporal refine's analytic, plane and fast forms
// (stages 3-9) and fused_refine (stages 5-9).

#include "refine_fused.cuh"

// stages 3-9 (temporal_refine's forms, no debug variant); the EMA's gate
// t0 and 1 / (t1 - t0) (the step's, rounded to f32)
extern "C" int vst_temporal_refine(const void* alpha, const void* prev,
                                   const void* yi, const void* xi,
                                   const void* guide, const void* knobs,
                                   const void* prior, const void* taps,
                                   const void* wts, void* new_prev, void* out,
                                   int out_f32, int lanes, int S, int H, int W,
                                   int h0, int w0, int fy, int fx, int pad,
                                   float ema_t0, float ema_inv_ramp, void* stream) {
  return temporal_refine<0>(alpha, prev, yi, xi, guide, knobs, prior, taps, wts, new_prev,
                            out, out_f32, lanes, S, H, W, h0, w0, fy, fx, pad, ema_t0,
                            ema_inv_ramp, stream);
}

// stages 5-9 on alpha as it is, the prior plane, f32 out
extern "C" int vst_refine(const void* alpha, const void* guide,
                          const void* knobs, const void* prior, void* out,
                          int S, int H, int W, void* stream) {
  return launch<false, true>(alpha, nullptr, nullptr, nullptr, guide, knobs,
                             prior, nullptr, out, 1, S, H, W, 0, 0.0f, 0.0f, stream);
}
