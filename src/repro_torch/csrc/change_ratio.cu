// Fused change ratio + candidate-bin id (paper Eq. 1 and the histogram's
// "assign index" pre-pass).
//
// Replaces: src/repro/kernels/change_ratio.py change_ratio_bins (Pallas
// `_kernel`, pallas_call at :67).  For each element, with f64 data rounded
// to f32 once first:
//   r   = (curr - safe) / safe,  safe = prev, or 1 where prev == 0
//   ok  = prev != 0 && isfinite(r) && isfinite(curr), else r = 0
//   bin = floor((r - lo) / width), or -1 unless ok and in [0, max_bins)
//
// Bound on the H100: bytes.  It reads prev and curr once and writes r and
// the id once (16 B per element in f32, 24 B in f64) against a few flops,
// far below the card's ~20 flop/B balance point.  The design is a plain
// grid-stride loop with one element per thread per iteration; widening the
// loads is left for a later change.
//
// Exactness: the ids must equal the reference's bit for bit, because one
// ulp in either division moves an element across a bin edge.  Both
// divisions and subtractions use the round-to-nearest intrinsics, the
// build passes -prec-div=true -ftz=false -fmad=false, and floor comes
// before the range test, as in the reference.
#include "common.cuh"

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(double x) { return __double2float_rn(x); }

template <typename T>
__global__ void change_ratio_bins_kernel(const T* __restrict__ prev,
                                         const T* __restrict__ curr,
                                         float* __restrict__ ratio,
                                         int* __restrict__ ids, long long n,
                                         float lo, float width,
                                         float max_bins) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const float p = to_f32(prev[i]);
    const float c = to_f32(curr[i]);
    const bool denom_ok = p != 0.0f;
    const float safe = denom_ok ? p : 1.0f;
    float r = __fdiv_rn(__fsub_rn(c, safe), safe);
    bool ok = denom_ok && isfinite(r) && isfinite(c);
    r = ok ? r : 0.0f;
    const float raw = floorf(__fdiv_rn(__fsub_rn(r, lo), width));
    ok = ok && raw >= 0.0f && raw < max_bins;
    ratio[i] = r;
    ids[i] = ok ? static_cast<int>(raw) : -1;
  }
}

template <typename T>
static int launch(const void* prev, const void* curr, void* ratio, void* ids,
                  long long n, float lo, float width, int max_bins,
                  void* stream) {
  if (n <= 0 || max_bins < 1) return cudaErrorInvalidValue;
  constexpr int kThreads = 256;
  change_ratio_bins_kernel<T>
      <<<repro_grid(n, kThreads, 132LL * 32), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(prev), static_cast<const T*>(curr),
          static_cast<float*>(ratio), static_cast<int*>(ids), n, lo, width,
          static_cast<float>(max_bins));
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT int change_ratio_bins_f32(const void* prev, const void* curr,
                                       void* ratio, void* ids, long long n,
                                       float lo, float width, int max_bins,
                                       void* stream) {
  return launch<float>(prev, curr, ratio, ids, n, lo, width, max_bins,
                       stream);
}

REPRO_EXPORT int change_ratio_bins_f64(const void* prev, const void* curr,
                                       void* ratio, void* ids, long long n,
                                       float lo, float width, int max_bins,
                                       void* stream) {
  return launch<double>(prev, curr, ratio, ids, n, lo, width, max_bins,
                        stream);
}

REPRO_ERROR_STRING(change_ratio)
