// Candidate-bin histogram: int32 counts of the ids in [0, max_bins); ids
// outside (the -1 of invalid elements) are ignored.
//
// Replaces: src/repro/kernels/hist.py histogram (Pallas `_kernel`,
// pallas_call at :56).  The TPU had no scatter-add, so it compared every
// id against 1024-bin chunks; here each block counts with shared-memory
// atomics and merges into the global counts with one atomic per non-zero
// bin.
//
// Bound on the H100: bytes in principle (4 B read per id), but temporal
// data piles most ids into a few bins, so atomics on the same shared
// address serialise.  Two things in the design answer that:
//   * Tiling of the bin range.  65,536 int32 counters are 256 KiB, more
//     than the 227 KB a block may have, so blockIdx.y picks a slice of at
//     most kSlice bins (128 KiB of dynamic shared memory) and every slice
//     scans all ids; the default max_bins = 65536 takes two passes over
//     the ids, the second mostly from L2 at the main path's sizes.
//   * Warp aggregation.  __match_any_sync groups the lanes of a warp that
//     hold the same bin, and one lane adds the group's size, so a warp
//     whose 32 ids share a bin issues one atomic, not 32.
// Integer atomics are exact in any order, so the counts are deterministic.
#include "common.cuh"

constexpr int kThreads = 1024;
constexpr int kSlice = 32768;

__global__ void histogram_kernel(const int* __restrict__ ids, long long n,
                                 int* __restrict__ counts, int max_bins) {
  extern __shared__ int s_counts[];
  const int bin0 = blockIdx.y * kSlice;
  const int nb = min(kSlice, max_bins - bin0);
  for (int b = threadIdx.x; b < nb; b += blockDim.x) s_counts[b] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // `i - lane` is the warp's first element, the same for all 32 lanes, so
  // every lane runs the same iterations and __match_any_sync sees a full
  // warp; lanes past n carry the "no bin" key -1.
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i - lane < n; i += stride) {
    const int id = i < n ? __ldg(ids + i) : -1;
    const int local = (id >= bin0 && id < bin0 + nb) ? id - bin0 : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, local);
    if (local >= 0 && lane == __ffs(peers) - 1) {
      atomicAdd(&s_counts[local], __popc(peers));
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    const int v = s_counts[b];
    if (v) atomicAdd(&counts[bin0 + b], v);
  }
}

// `counts` must hold max_bins zeros on entry (the wrapper allocates it
// with torch.zeros).
REPRO_EXPORT int histogram_i32(const void* ids, long long n, void* counts,
                               int max_bins, void* stream) {
  if (n <= 0 || max_bins < 1) return cudaErrorInvalidValue;
  const int slice = max_bins < kSlice ? max_bins : kSlice;
  const int nslices = (max_bins + kSlice - 1) / kSlice;
  const size_t smem = static_cast<size_t>(slice) * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      histogram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  // One resident block per SM at 128 KiB; about two waves over all slices.
  long long cap = 264 / nslices;
  if (cap < 1) cap = 1;
  const dim3 grid(repro_grid(n, kThreads * 8, cap), nslices);
  histogram_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), n, static_cast<int*>(counts), max_bins);
  return static_cast<int>(cudaGetLastError());
}

REPRO_ERROR_STRING(hist)
