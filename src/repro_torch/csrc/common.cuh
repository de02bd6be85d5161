// Shared definitions of the port's CUDA sources.
//
// Every source is built by kernels/_build.py into its own shared library
// with a plain C interface (nvcc, sm_90a), loaded with ctypes.  Each entry
// point takes device pointers and PyTorch's current stream, allocates
// nothing, and returns cudaGetLastError() of its launch (0 on success).
#pragma once

#include <cuda_runtime.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

// Error text of a code returned by an entry point of library `lib`.
#define REPRO_ERROR_STRING(lib)                                         \
  REPRO_EXPORT const char* lib##_error_string(int e) {                  \
    return cudaGetErrorString(static_cast<cudaError_t>(e));             \
  }

// Blocks for a grid-stride loop over n items: enough to cover n, at most
// `cap` (a few waves over the H100's 132 SMs).
static inline unsigned repro_grid(long long n, int threads, long long cap) {
  long long b = (n + threads - 1) / threads;
  if (b > cap) b = cap;
  return static_cast<unsigned>(b < 1 ? 1 : b);
}
