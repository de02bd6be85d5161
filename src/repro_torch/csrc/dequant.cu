// Dequantize and the fused REF_RECONSTRUCTED chain advance:
//   out[i] = prev[i] * (1 + c),  c = idx[i] < k ? centers[idx[i]] : 0
//   out[i] = curr[i] where idx[i] == marker (chain advance), or 0 there
//            when no `curr` is given (plain dequantize).
//
// Replaces: src/repro/kernels/dequant.py dequantize (Pallas `_kernel`,
// pallas_call at :78), fused with dequant.patch_exceptions (:109) and the
// marker patch of kernels/ops.py chain_advance_core (:88).  The TPU looked
// the centers up with a one-hot matmul on the MXU; that is not ported,
// because TF32 would make it inexact.  Here the lookup is a gather.
//
// Bound on the H100: bytes (idx, prev, curr read once, out written once:
// 16 B per element in f32, 28 B in f64).  The centers table (k <= 65,535
// entries) is reused by every element: a block copies it into shared
// memory when it fits in 48 KB (B <= 13 in f32, B <= 12 in f64), else the
// gather reads it through the read-only cache.  No 2^B lookup table is
// built (it would be 64 MB at B = 24).
//
// Exactness: the add comes before the multiply with the round-to-nearest
// intrinsics, and the build passes -fmad=false, so nothing contracts into
// an FMA.  The f64 instance computes in f64, like the reference's f64
// chain (pipeline.reconstruction_dtype).
#include "common.cuh"

constexpr int kThreads = 256;
constexpr size_t kSmemBytes = 48 * 1024;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <typename T, bool kShared>
__global__ void dequant_kernel(const int* __restrict__ idx,
                               const T* __restrict__ prev,
                               const T* __restrict__ curr,
                               const T* __restrict__ centers, int k,
                               int marker, T* __restrict__ out,
                               long long n) {
  __shared__ __align__(16) unsigned char s_raw[kShared ? kSmemBytes : 16];
  T* s_centers = reinterpret_cast<T*>(s_raw);
  if (kShared) {
    for (int j = threadIdx.x; j < k; j += blockDim.x) s_centers[j] = centers[j];
    __syncthreads();
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const int q = idx[i];
    T c = T(0);
    if (q >= 0 && q < k) c = kShared ? s_centers[q] : __ldg(centers + q);
    T v = mul_rn(prev[i], add_rn(T(1), c));
    if (q == marker) v = curr != nullptr ? curr[i] : T(0);
    out[i] = v;
  }
}

template <typename T>
static int launch(const void* idx, const void* prev, const void* curr,
                  const void* centers, int k, int marker, void* out,
                  long long n, void* stream) {
  if (n <= 0 || k < 0) return cudaErrorInvalidValue;
  const unsigned grid = repro_grid(n, kThreads, 132LL * 8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* q = static_cast<const int*>(idx);
  const T* p = static_cast<const T*>(prev);
  const T* c = static_cast<const T*>(curr);
  const T* ct = static_cast<const T*>(centers);
  T* o = static_cast<T*>(out);
  if (static_cast<size_t>(k) * sizeof(T) <= kSmemBytes) {
    dequant_kernel<T, true><<<grid, kThreads, 0, s>>>(q, p, c, ct, k, marker,
                                                      o, n);
  } else {
    dequant_kernel<T, false><<<grid, kThreads, 0, s>>>(q, p, c, ct, k,
                                                       marker, o, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// `curr` may be NULL: marker lanes then come out 0 (plain dequantize).
REPRO_EXPORT int dequant_f32(const void* idx, const void* prev,
                             const void* curr, const void* centers, int k,
                             int marker, void* out, long long n,
                             void* stream) {
  return launch<float>(idx, prev, curr, centers, k, marker, out, n, stream);
}

REPRO_EXPORT int dequant_f64(const void* idx, const void* prev,
                             const void* curr, const void* centers, int k,
                             int marker, void* out, long long n,
                             void* stream) {
  return launch<double>(idx, prev, curr, centers, k, marker, out, n, stream);
}

REPRO_ERROR_STRING(dequant)
