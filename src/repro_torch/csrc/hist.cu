// Candidate-bin histogram: int32 counts of the ids in [0, max_bins); ids
// outside (the -1 of invalid elements) are ignored.
//
// Replaces: src/repro/kernels/hist.py histogram (Pallas `_kernel`,
// pallas_call at :56).  The TPU had no scatter-add, so it compared every
// id against 1024-bin chunks; here blocks count with shared-memory atomics
// and merge into the global counts with one atomic per non-zero bin.
//
// Bound on the H100: bytes (4 B read per id).  At the main path's size
// (3.6 M ids, a few microseconds of work) fixed costs per launch weigh as
// much as the reads, so the design does the least per launch and reads
// each id once:
//   * A table sized to the bins the step can reach.  The caller passes
//     `id_bound`, a hint that every id of the step lies below it (the main
//     path computes it from the ratio range, core/ratios.py id_bound).
//     Only [0, table_bins) lives in shared memory; an id in
//     [table_bins, max_bins) is still counted, with a direct global
//     atomicAdd, so the result is exact for any hint.  A table of a few
//     thousand bins leaves room for two 1024-thread blocks per SM.
//   * One pass over the ids with 16-byte loads and one load in flight
//     ahead of the one being counted; a scalar head and tail take an
//     unaligned start (a view such as ids[1:]) and an n that is not a
//     multiple of 4.  The grid is one wave, sized by the occupancy API.
//   * Into the block's own table, one shared atomic per id.  Temporal data
//     piles 40-80 % of the ids into one bin, but on the H100 shared
//     atomics absorb that: merging equal neighbours within a thread, warp
//     aggregation and replicated tables all cost more than they save
//     (PERF.md).
//   * Wide domains: a table too large for one block is split over a
//     thread-block cluster of 2-8 blocks.  Bin b belongs to block
//     b % cluster (the hot bins near the centre of a zero-centred domain
//     land on different blocks), and an add goes into the owner's shared
//     memory through map_shared_rank.  A remote add costs far more than a
//     local one, so there __match_any_sync first groups the lanes of a
//     warp that hold the same bin and one lane adds the group's size.
//     Only a table beyond what eight blocks hold is cut into slices,
//     which the grid counts one after another, each reading every id.
//   * `counts` is zeroed by cudaMemsetAsync ahead of the launch: cheaper
//     than zeroing in the kernel behind a grid barrier.
//   * The occupancy queries behind a launch's grid take microseconds of
//     host time; their answers are kept per device and launch shape.
// Integer atomics are exact in any order, so the counts are deterministic.
#include <cooperative_groups.h>

#include <cstdint>
#include <mutex>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;
constexpr int kBlocksPerSM = 2;               // aimed for by a one-block table
constexpr int kMaxClusterShift = 3;           // 8 blocks, the portable limit
constexpr int kSmemPerSM = 228 * 1024;        // H100, 1 KB of it per block reserved
constexpr int kSmemPerBlockMax = 227 * 1024;  // opt-in limit of one block
constexpr int kMinIdsPerThread = 16;          // below that the grid shrinks
constexpr unsigned kFull = 0xffffffffu;

struct Geometry {
  long long head;   // scalar ids before the first 16-byte boundary
  long long n4;     // int4 words after the head
  long long tail;   // scalar ids after them (0..3)
  int max_bins;
  int table_bins;   // bins kept in shared memory, [0, table_bins)
  int slice_bins;   // bins one cluster holds in one pass over the ids
  int slices;
  int block_bins;   // bins one block holds
  int cluster_shift;
};

// Slice-relative key of `id`, or -1.  Slice 0 also counts an id in
// [table_bins, max_bins) straight into global memory: the hint was wrong,
// and the count stays exact.
__device__ __forceinline__ int key_of(int id, int lo, int hi,
                                      const Geometry& g, bool outside,
                                      int* counts) {
  if (id >= lo && id < hi) return id - lo;
  if (outside && id >= g.table_bins && id < g.max_bins) {
    atomicAdd(counts + id, 1);
  }
  return -1;
}

// Add v to slice-relative bin `key`: in this block's shared memory, or in
// the owning peer's (key % cluster).
template <bool kCluster>
__device__ __forceinline__ void add(int* tab, int key, int v, int shift) {
  if constexpr (kCluster) {
    int* dst = cg::this_cluster().map_shared_rank(
        tab, static_cast<unsigned>(key & ((1 << shift) - 1)));
    atomicAdd(dst + (key >> shift), v);
  } else {
    atomicAdd(tab + key, v);
  }
}

// Count the four keys of every lane of a full warp (-1 = none).
template <bool kCluster>
__device__ __forceinline__ void count4(int k0, int k1, int k2, int k3,
                                       int lane, int* tab, int shift) {
  const int k[4] = {k0, k1, k2, k3};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if constexpr (kCluster) {
      const unsigned peers = __match_any_sync(kFull, k[c]);
      if (k[c] >= 0 && lane == __ffs(peers) - 1) {
        add<true>(tab, k[c], __popc(peers), shift);
      }
    } else if (k[c] >= 0) {
      add<false>(tab, k[c], 1, shift);
    }
  }
}

template <bool kCluster>
__device__ __forceinline__ void sync_table() {
  if constexpr (kCluster) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

template <bool kCluster>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    histogram_kernel(const int* __restrict__ ids, int* __restrict__ counts,
                     Geometry g) {
  extern __shared__ int tab[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int shift = g.cluster_shift;
  const unsigned rank = kCluster ? cg::this_cluster().block_rank() : 0;
  const long long gtid = static_cast<long long>(blockIdx.x) * kThreads + tid;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  // The table as add() takes it.  On a cluster its generic address is held
  // in registers: the compiler would otherwise derive it anew from special
  // registers at every remote add.
  int* dst = tab;
  if constexpr (kCluster) asm("" : "+l"(dst));

  const int4* body = reinterpret_cast<const int4*>(ids + g.head);
  const int4 none = make_int4(-1, -1, -1, -1);
  for (int s = 0; s < g.slices; ++s) {
    for (int j = tid; j < g.block_bins; j += kThreads) tab[j] = 0;
    // No peer may add into this block's table before it is zero (and,
    // from the second slice on, before its last flush has read it).
    sync_table<kCluster>();
    const int lo = s * g.slice_bins;
    const int hi = min(lo + g.slice_bins, g.table_bins);
    const bool outside = s == 0;

    // Scalar head and tail, one id per thread, no aggregation.
    if (gtid < g.head) {
      const int k = key_of(__ldg(ids + gtid), lo, hi, g, outside, counts);
      if (k >= 0) add<kCluster>(dst, k, 1, shift);
    }
    if (gtid < g.tail) {
      const int k = key_of(__ldg(ids + g.head + 4 * g.n4 + gtid), lo, hi, g,
                           outside, counts);
      if (k >= 0) add<kCluster>(dst, k, 1, shift);
    }

    // The 16-byte body.  `i - lane` is the same for the 32 lanes of a
    // warp, so every lane runs the same iterations and the warp's
    // collectives see all 32 lanes; lanes past the end carry -1.
    long long i = gtid;
    int4 v = i < g.n4 ? __ldg(body + i) : none;
    for (; i - lane < g.n4; i += stride) {
      const long long nx = i + stride;
      const int4 next = nx < g.n4 ? __ldg(body + nx) : none;
      count4<kCluster>(key_of(v.x, lo, hi, g, outside, counts),
                       key_of(v.y, lo, hi, g, outside, counts),
                       key_of(v.z, lo, hi, g, outside, counts),
                       key_of(v.w, lo, hi, g, outside, counts), lane, dst,
                       shift);
      v = next;
    }

    // Every peer's adds into this block have landed.  After this barrier
    // no block touches another's shared memory until the next slice's
    // barrier, so each flushes its own bins, and after the last slice
    // each may exit.
    sync_table<kCluster>();
    for (int j = tid; j < g.block_bins; j += kThreads) {
      const int c = tab[j];
      if (c) atomicAdd(counts + lo + (j << shift) + static_cast<int>(rank), c);
    }
    if (s + 1 < g.slices) __syncthreads();
  }
}

struct Plan {
  Geometry g;
  int cluster;
  int blocks_per_sm;
  unsigned grid_x;
  size_t smem;
};

static long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

static cudaLaunchConfig_t launch_config(const Plan& p, dim3 grid,
                                        cudaStream_t s,
                                        cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = s;
  if (p.cluster > 1) {
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = p.cluster;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return cfg;
}

// What the occupancy queries say of one launch shape on one device: the
// SMs, the blocks one SM holds, and (on a cluster) the clusters that run
// at once.  The answers are kept: a series repeats a few shapes.
struct Occupancy {
  int dev;
  int cluster;
  size_t smem;
  int sms;
  int blocks_per_sm;
  int clusters;
};

constexpr int kMaxDevices = 64;
constexpr int kOccupancyCache = 32;

static cudaError_t query_occupancy(const Plan& p, int dev, Occupancy* o) {
  static std::mutex mu;
  static bool opted_in[kMaxDevices];
  static Occupancy cache[kOccupancyCache];
  static int kept = 0, next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int k = 0; k < kept; ++k) {
    const Occupancy& c = cache[k];
    if (c.dev == dev && c.cluster == p.cluster && c.smem == p.smem) {
      *o = c;
      return cudaSuccess;
    }
  }
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  cudaError_t e = cudaSuccess;
  if (!opted_in[dev]) {
    // The most a block may take, once per device: a lower cap set for one
    // shape would refuse a larger one taken from the cache.
    e = cudaFuncSetAttribute(histogram_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemPerBlockMax);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(histogram_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemPerBlockMax);
    }
    if (e != cudaSuccess) return e;
    opted_in[dev] = true;
  }
  Occupancy q = {dev, p.cluster, p.smem, 0, 0, 0};
  e = cudaDeviceGetAttribute(&q.sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (p.cluster > 1) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &q.blocks_per_sm, histogram_kernel<true>, kThreads, p.smem);
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        launch_config(p, dim3(p.cluster, 1, 1), nullptr, &attr);
    e = cudaOccupancyMaxActiveClusters(&q.clusters, histogram_kernel<true>,
                                       &cfg);
  } else {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &q.blocks_per_sm, histogram_kernel<false>, kThreads, p.smem);
  }
  if (e != cudaSuccess) return e;
  cache[next] = q;
  next = (next + 1) % kOccupancyCache;
  if (kept < kOccupancyCache) ++kept;
  *o = q;
  return cudaSuccess;
}

// The launch for n ids at `ids`: table, cluster and a one-wave grid.  A
// table that fits one block at two blocks per SM takes one block; a
// larger one the smallest cluster (2, 4, 8) whose blocks hold it at one
// block per SM, else eight blocks of up to 227 KB, else slices.
static cudaError_t make_plan(const void* ids, long long n, int max_bins,
                             int id_bound, Plan* p) {
  if (n < 0 || max_bins < 1) return cudaErrorInvalidValue;
  Geometry& g = p->g;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(ids);
  if (addr & 3) return cudaErrorMisalignedAddress;
  g.head = static_cast<long long>(((16 - (addr & 15)) & 15) >> 2);
  if (g.head > n) g.head = n;
  g.n4 = (n - g.head) >> 2;
  g.tail = n - g.head - 4 * g.n4;
  g.max_bins = max_bins;
  g.table_bins = id_bound < 1 ? 1 : (id_bound > max_bins ? max_bins : id_bound);

  int shift = 0;
  if (g.table_bins * 4LL > kSmemPerSM / kBlocksPerSM - 1024) {
    shift = 1;
    while (shift < kMaxClusterShift &&
           ceil_div(g.table_bins, 1LL << shift) * 4 > kSmemPerBlockMax) {
      ++shift;
    }
  }
  long long per = ceil_div(g.table_bins, 1LL << shift);
  if (per * 4 > kSmemPerBlockMax) per = kSmemPerBlockMax / 4;
  g.cluster_shift = shift;
  g.block_bins = static_cast<int>(per);
  g.slice_bins = static_cast<int>(per << shift);
  g.slices = static_cast<int>(ceil_div(g.table_bins, g.slice_bins));
  p->cluster = 1 << shift;
  p->smem = static_cast<size_t>(per * 4);

  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  Occupancy o;
  e = query_occupancy(*p, dev, &o);
  if (e != cudaSuccess) return e;
  p->blocks_per_sm = o.blocks_per_sm;
  const long long wave = p->cluster > 1
                             ? static_cast<long long>(o.clusters) * p->cluster
                             : static_cast<long long>(o.blocks_per_sm) * o.sms;
  if (wave < 1) return cudaErrorInvalidConfiguration;
  // Enough blocks for the work, at most one wave, whole clusters.
  long long need = ceil_div(n, static_cast<long long>(kThreads) *
                                   kMinIdsPerThread);
  need = ceil_div(need < 1 ? 1 : need, p->cluster) * p->cluster;
  p->grid_x = static_cast<unsigned>(need < wave ? need : wave);
  return cudaSuccess;
}

// `counts` (max_bins ints) need not be zero on entry: the launch zeroes
// it.  `id_bound` is a size hint: the table holds [0, id_bound) (clamped
// to [1, max_bins]); ids above it are still counted.
REPRO_EXPORT int histogram_i32(const void* ids, long long n, void* counts,
                               int max_bins, int id_bound, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  Plan p;
  cudaError_t e = make_plan(ids, n, max_bins, id_bound, &p);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = cudaMemsetAsync(counts, 0, static_cast<size_t>(max_bins) * 4, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(p, dim3(p.grid_x, 1, 1), s, &attr);
  const int* in = static_cast<const int*>(ids);
  int* out = static_cast<int*>(counts);
  e = p.cluster > 1
          ? cudaLaunchKernelEx(&cfg, histogram_kernel<true>, in, out, p.g)
          : cudaLaunchKernelEx(&cfg, histogram_kernel<false>, in, out, p.g);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The launch histogram_i32 would make, for logs: out[0..7] = grid,
// slices, threads, blocks per SM, cluster size, bins per block, dynamic
// shared bytes, table bins.  Launches nothing.
REPRO_EXPORT int histogram_plan(const void* ids, long long n, int max_bins,
                                int id_bound, int* out) {
  Plan p;
  const cudaError_t e = make_plan(ids, n, max_bins, id_bound, &p);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int v[8] = {static_cast<int>(p.grid_x), p.g.slices, kThreads,
                    p.blocks_per_sm, p.cluster, p.g.block_bins,
                    static_cast<int>(p.smem), p.g.table_bins};
  for (int k = 0; k < 8; ++k) out[k] = v[k];
  return 0;
}

REPRO_ERROR_STRING(hist)
