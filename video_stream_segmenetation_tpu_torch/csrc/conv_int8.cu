// int8 fused 3x3 convolution for Hopper (sm_90a): the port of the Pallas
// kernel video_stream_segmenetation_tpu/kernels/conv_int8.py::
// conv3x3_i8_fused (body _kernel, pallas_call at line 116).
//
// It computes, for x s8 [S, H, W, Cin] (6/127-lattice activations) and
// weights s8 OHWI [Cout, 3, 3, Cin] (the reference's HWIO weights
// transposed; the wrapper passes the copy models/quantized.py keeps), a
// 3x3 SAME convolution at stride 1 and dilation d with exact s32 sums,
// then per output element
//   y = acc * mult[n] + bias[n]           (f32; built with --fmad=false)
//   y = y + res * 6/127                   (with a residual, s8 [S, H, W, Cout])
//   act:    s8 = rint(clip(y, 0, 6) * 127/6)
//   no act: s8 = clip(rint(y * 127/6), -127, 127)
// exactly as the Pallas kernel's epilogue (conv_int8.py:62-74).
//
// What bounds it on an H100: operations.  At the plan B layers it serves
// (S = 64, 720p): b1's first conv 72x128, 128 -> 128 channels, is 86.9 G
// multiply-adds (0.088 ms at the int8 peak of 1979 TOP/s) against 75.5 MB
// in and 75.5 MB out (0.045 ms at 3.35 TB/s); the d2b, d3b and ctx2 convs
// have the same ratio or a higher one.
//
// Design: the TPU kernel keeps one stream's padded plane in VMEM and runs
// nine tap matmuls.  Here it is the trunk's own implicit GEMM on the int8
// tensor cores, conv_i8_kernel of csrc/wgmma_i8.cuh: M = output pixels of
// all streams, N = output channels, K = 9 taps x Cin in the OHWI order, a
// block 128 pixels x 64 NT channels with wgmma m64n64k32 from a ring of
// 128-byte-swizzled stages that cp.async fills while earlier stages
// multiply.  The SAME padding is the gathers' zero fill (no padded copy).
// The act forms at the trunk's widths (Cout 64 to 256 in steps of 64: the
// routed layers of plans B, C and micro) are the tile's mode 0, with or
// without the residual, and launch the trunk's own instantiation through
// vst_conv_i8 (csrc/trunk_int8.cu): the same code, so the same time.  The
// no-act forms (mode 3), a Cout that is not a multiple of 64 and a Cout
// above 256 launch the ROUTED instantiations: NT = min(4, ceil(Cout /
// 64)), the weight rows past Cout zero filled and their stores masked,
// ceil(Cout / 256) N tiles.  (The ROUTED epilogue, with its masks and the
// extra mode, measured 13-28 % slower than the trunk's at plan B's layers
// on an H100, hence the two routes.)

#include "wgmma_i8.cuh"

// Cin a multiple of 32, Cout of 4, dilation >= 1; 0 or the CUDA error
extern "C" int vst_conv3x3_i8_fused(const void* x, const void* w, const void* mult,
                                    const void* bias, const void* res, void* out,
                                    int S, int H, int W, int Cin, int Cout, int dil,
                                    int act, void* stream) {
  if (Cin % 32 || Cin < 32 || Cout % 4 || Cout < 4 || dil < 1)
    return (int)cudaErrorInvalidValue;
  if (act && Cout % 64 == 0 && Cout <= 256)
    return vst_conv_i8(x, w, mult, bias, res, nullptr, out, S, H, W, Cin, H, W, Cout, 3, 3,
                       1, dil, dil, dil, 0, 0, 0, stream);
  const int mode = act ? 0 : 3;
#define CONV(NT)                                                                  \
  launch_conv<NT, true>(x, w, mult, bias, res, nullptr, out, S, H, W, Cin, H, W, \
                        Cout, 3, 3, 1, dil, dil, dil, mode, 0, 0,               \
                        (cudaStream_t)stream)
  switch ((Cout + 63) / 64) {
    case 1: return CONV(1);
    case 2: return CONV(2);
    case 3: return CONV(3);
    default: return CONV(4);
  }
#undef CONV
}
