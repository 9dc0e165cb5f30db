// Error text for the status codes the launchers of this library return
// (each launcher returns cudaGetLastError() right after its launch).

#include <cuda_runtime.h>

extern "C" const char* vst_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
