// Interleaved rANS of the device entropy stage: encode, decode, and the
// unpack of B-bit index blocks.  32-bit states, 16-bit renormalization,
// 12-bit frequencies (kernels/rans.py holds the format and the plain
// versions these kernels must equal bit for bit).
//
// Replaces: src/repro/kernels/rans.py encode_bytes_body (:424) and
// decode_scan_body (:688), both a lax.scan over the rows of a block group
// in the reference, not Pallas; rans_unpack replaces unpack_words (:650).
//
// The blob format fixes a block's lanes (L = 32..1024, lanes_for) and
// makes each lane a chain of m = ceil(n / L) dependent steps (1,024 for a
// 1 MB v1 block, 2,048 for v2 at B = 4).  So neither kernel is bound by
// bytes or operations on the H100: the time is m times one step's latency,
// and each design shortens that step and spreads the chains over the SMs.
//
//   encode  The lanes of a block are independent (lane l writes step j at
//           j*L + l), so a block's L lanes are split over L / Lc CTAs of Lc
//           threads (kernels/rans.py encode_lanes_per_cta chooses Lc): a
//           CMIP step's two blocks run on 16 SMs, not 2.  Each CTA holds its
//           block's fused table in shared memory beside a 32-bit
//           reciprocal of each frequency, so a step's u32 division becomes
//           a mul-hi and one remainder correction (div_by_freq).  The
//           symbols of the next kAhead steps are loaded a group ahead,
//           since their addresses do not depend on the state; what is left
//           on a lane's chain is the compare, the mul-hi and a few integer
//           operations.  Each step's u16 value and emit flag are written in
//           the decoder's order (row ascending, lane ascending); the caller
//           compacts the flagged values.
//   decode  One CTA per block (its lanes share one stream pointer), each
//           thread running 4 consecutive lanes (1 at L = 32), so that a
//           step's per-thread costs (the barrier, the block reduction, the
//           loop) are paid once for 4 lanes.  Each step a lane that needs a
//           word takes it at ptr + (the count of needing lanes before it):
//           one ballot per lane slot in the warp, the warp counts in shared
//           memory (double-buffered: one __syncthreads a step) and one
//           __reduce_add_sync of two counts packed into one word.  The word
//           comes from a ring of kStages chunks of the block's stream in
//           shared memory, filled by 1-D bulk async copies (TMA) that one
//           thread issues, one mbarrier a stage; a stage is refilled as
//           soon as the pointer has passed its chunk, at least (kStages - 1)
//           * kChunk words (14 worst-case steps at L = 1,024) ahead of the
//           pointer, and a step reads its words from the ring with no
//           branch.  So the step's chain holds shared loads only, where it
//           held a dependent load from L2 or HBM; that chain (the table
//           load, the ballots, the barrier, the reduction, the ring load)
//           now sets the time (PERF.md).  Reads at or past the block's
//           n_emit give 0; the final states and pointer go
//           back so that the host check is the reference's _check_decoded.
#include <cstdint>

#include "bitgroup.cuh"
#include "common.cuh"

namespace {

constexpr int kScaleBits = 12;
constexpr int kM = 1 << kScaleBits;
constexpr unsigned kStateLo = 1u << 16;

// ------------------------------------------------------------- encode

constexpr int kMaxLanesPerCta = 256;
constexpr int kAhead = 16;  // steps whose symbols are loaded a group ahead

// The reciprocal of a frequency f >= 1 for div_by_freq: R = floor(2^32 / f),
// or 2^32 - 1 for f = 1.  2^32 / f is an integer or at least 1/f >= 2^-13
// away from one, and the double quotient is within 2^-20 of it, so its
// floor is exact.  (f = 0, which no valid table holds, gives R = 0.)
__device__ __forceinline__ unsigned freq_reciprocal(unsigned f) {
  return f ? static_cast<unsigned>(
                 fmin(floor(4294967296.0 / static_cast<double>(f)),
                      4294967295.0))
           : 0u;
}

// floor(x / f) and x mod f for any u32 x, with R = freq_reciprocal(f):
// R * f <= 2^32 and 2^32 - R * f <= f.  So q0 = floor(x * R / 2^32) (one
// mul-hi) is at most x / f, and x / f - x * R / 2^32 = x * (2^32 - R * f) /
// (f * 2^32) <= x / 2^32 < 1: q0 is q or q - 1, and one correction of the
// remainder makes it exact.  No u32 division.
__device__ __forceinline__ unsigned div_by_freq(unsigned x, unsigned f,
                                                unsigned rcp, unsigned* r) {
  unsigned q = __umulhi(x, rcp);
  unsigned rem = x - q * f;
  if (rem >= f) {
    ++q;
    rem -= f;
  }
  *r = rem;
  return q;
}

// Grid: nb * (L / Lc) CTAs of Lc threads; CTA c of block b runs lanes
// [c * Lc, c * Lc + Lc) of that block.
template <typename Sym>
__global__ void __launch_bounds__(kMaxLanesPerCta)
    rans_encode_kernel(const Sym* __restrict__ syms, long long n,
                       const unsigned* __restrict__ fc, int A, int fc_row,
                       int m, int L, unsigned* __restrict__ states,
                       unsigned short* __restrict__ vals,
                       unsigned char* __restrict__ masks) {
  // Symbol s: its fused word (freq | cum << 13) and freq_reciprocal(freq).
  extern __shared__ uint2 s_tab[];
  const int Lc = blockDim.x;
  const int ctas = L / Lc;
  const long long b = blockIdx.x / ctas;
  const int lane = (blockIdx.x % ctas) * Lc + threadIdx.x;
  const unsigned* tab = fc + b * fc_row;
  for (int i = threadIdx.x; i < A; i += Lc) {
    const unsigned v = tab[i];
    s_tab[i] = make_uint2(v, freq_reciprocal(v & 0x1FFFu));
  }
  __syncthreads();
  const Sym* row = syms + b * n + lane;
  // Step j's value and flag go to (j * L + lane) of the block's rows.
  const long long last = static_cast<long long>(m - 1) * L;
  unsigned short* vp = vals + b * static_cast<long long>(m) * L + lane + last;
  unsigned char* mp = masks + b * static_cast<long long>(m) * L + lane + last;
  // Symbols of steps j0 - u, loaded one group ahead of their use and
  // clamped only then, so that the loads stay in flight for a group.
  int raw[kAhead];
  auto load = [&](int j0) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const long long pos = static_cast<long long>(j0 - u) * L;
      raw[u] = (j0 - u >= 0 && pos + lane < n) ? static_cast<int>(row[pos])
                                               : 0;
    }
  };
  load(m - 1);
  unsigned x = kStateLo;
  for (int j0 = m - 1; j0 >= 0; j0 -= kAhead) {
    uint2 v[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) v[u] = s_tab[max(0, min(raw[u], A - 1))];
    load(j0 - kAhead);
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (j0 - u < 0) break;
      const unsigned f = v[u].x & 0x1FFFu;
      const bool emit = (x >> (32 - kScaleBits)) >= f;
      *vp = static_cast<unsigned short>(x & 0xFFFFu);
      *mp = emit;
      vp -= L;
      mp -= L;
      if (emit) x >>= 16;
      unsigned r;
      const unsigned q = div_by_freq(x, f, v[u].y, &r);
      x = (q << kScaleBits) + r + (v[u].x >> 13);
    }
  }
  states[b * L + lane] = x;
}

__global__ void rans_divide_kernel(const unsigned* __restrict__ x,
                                   const unsigned* __restrict__ f,
                                   long long n, unsigned* __restrict__ q,
                                   unsigned* __restrict__ r) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    q[i] = div_by_freq(x[i], f[i], freq_reciprocal(f[i]), r + i);
}

// ------------------------------------------------------------- decode

constexpr int kChunk = 2048;               // u16 words a ring stage holds
constexpr int kStages = 8;
constexpr int kRing = kChunk * kStages;    // 32 KB of stream in flight

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Dynamic shared memory of the decode kernel: the ring first (the bulk
// copies need 16-byte aligned destinations), then the tables, the stage
// barriers and the warp counts.
template <bool kWide>
constexpr int decode_smem_bytes() {
  return kRing * 2 + kM * 4 * (kWide ? 2 : 1) + kStages * 8 + 2 * 32 * 4;
}

// kMode 0: write every decoded symbol as a byte, (nb, m*L).
// kMode 1: write the first n symbols as B-bit indices, (nb, n) int32, ids
//          >= n_sym - 1 mapped to `marker` (the v2 blob's marker symbol).
//
// A CTA decodes one block with L / K threads; thread t runs the K
// consecutive lanes K*t .. K*t + K - 1 (decode_lanes_per_thread), so the
// per-step costs of a thread (the barrier, the reduction, the loop) are
// paid once for K lanes.  A lane that needs a word takes it at gp + (the
// count of needing lanes before it): the lanes of the warp's threads before
// this one come from one ballot per lane slot, the warps before from one
// __reduce_add_sync over the warp counts in shared memory.
//
// The ring works in the stream's aligned word space g = p + h, where p is
// a word's index in the block's stream row and h the row's start mod 8
// words.  Chunk k holds g in [k * kChunk, (k + 1) * kChunk) and lives in
// stage k % kStages, at ring[g % kRing].  Its words in [a0, a1), the
// 16-byte aligned span below the block's n_emit, arrive by one bulk copy;
// the < 8 words before a0 (the head, chunk 0) and from a1 to n_emit (the
// tail, the last chunk) are stored into the ring with plain loads, the
// head before the loop and the tail by the thread that issues its chunk,
// before it arrives on the chunk's barrier.  So a step reads its words
// from the ring with no branch.  No copy reads past n_emit (<= S): rows
// need no padding, though kernels/rans.py _batch_group pads them to a
// multiple of 8 words, which makes every row of a group aligned and its
// head empty.
template <bool kWide, int kMode, int K>
__global__ void __launch_bounds__(1024 / K)
    rans_decode_kernel(const unsigned* __restrict__ dec,
                       const int* __restrict__ sym_tab,
                       const unsigned* __restrict__ states,
                       const unsigned short* __restrict__ stream,
                       long long S, const long long* __restrict__ n_emit,
                       int m, void* __restrict__ out, long long n, int n_sym,
                       int marker, unsigned* __restrict__ xf,
                       long long* __restrict__ ptrf) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned short* ring = reinterpret_cast<unsigned short*>(smem);
  unsigned* s_dec = reinterpret_cast<unsigned*>(smem + kRing * 2);
  int* s_sym = reinterpret_cast<int*>(s_dec + kM);  // kWide only
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(
      smem + kRing * 2 + kM * 4 * (kWide ? 2 : 1));
  int* s_warp = reinterpret_cast<int*>(bar + kStages);    // [2][32]

  const int T = blockDim.x;
  const int L = T * K;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wl = tid & 31;
  const int nwarps = T >> 5;
  const long long b = blockIdx.x;
  const unsigned short* st = stream + b * S;
  const int ne = static_cast<int>(max(0LL, min(n_emit[b], S)));
  const int h = static_cast<int>((reinterpret_cast<uintptr_t>(st) >> 1) & 7);
  const unsigned short* base = st - h;
  const int G = ne + h;                 // end of the block's words in g
  const int a0 = h ? 8 : 0;
  const int a1 = max(a0, G & ~7);
  const int nchunks = ne ? (G + kChunk - 1) / kChunk : 0;

  // Chunk k into its stage (thread 0 only), after every read of the
  // stage's previous chunk (ordered by a __syncthreads).
  auto issue = [&](int k) {
    const int g0 = max(k * kChunk, a0);
    const int g1 = min((k + 1) * kChunk, a1);
    const unsigned bytes = g1 > g0 ? static_cast<unsigned>(g1 - g0) * 2u : 0u;
    if (a1 >= k * kChunk && a1 < (k + 1) * kChunk)
      for (int g = a1; g < G; ++g) ring[g & (kRing - 1)] = base[g];
    const unsigned mb = smem_addr(bar + k % kStages);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(mb),
        "r"(bytes)
        : "memory");
    if (bytes)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(
              smem_addr(ring + (g0 & (kRing - 1)))),
          "l"(base + g0), "r"(bytes), "r"(mb)
          : "memory");
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(bar + s))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // Every thread keeps the same count of issued chunks; thread 0 issues.
  int issued = min(kStages, nchunks);
  if (tid == 0)
    for (int k = 0; k < issued; ++k) issue(k);
  // The tables, 16 bytes a load (the entry point checks their alignment).
  {
    const uint4* d4 = reinterpret_cast<const uint4*>(dec + b * kM);
    const uint4* s4 = reinterpret_cast<const uint4*>(sym_tab + b * kM);
    for (int i = tid; i < kM / 4; i += T) {
      reinterpret_cast<uint4*>(s_dec)[i] = d4[i];
      if (kWide) reinterpret_cast<uint4*>(s_sym)[i] = s4[i];
    }
  }
  if (tid >= h && tid < min(a0, G)) ring[tid] = base[tid];   // the head
  __syncthreads();

  unsigned x[K];
#pragma unroll
  for (int i = 0; i < K; ++i) x[i] = states[b * L + K * tid + i];
  unsigned char* out8 = static_cast<unsigned char*>(out) +
                        b * static_cast<long long>(m) * L + K * tid;
  int* out32 = static_cast<int*>(out) + b * n + K * tid;
  // Loop invariants, pinned in registers (volatile: not recomputed from
  // the special registers every step).
  unsigned below_mask;
  asm volatile("mov.u32 %0, %%lanemask_lt;" : "=r"(below_mask));
  int count_here = wl < nwarps, count_before = wl < warp;
  asm volatile("" : "+r"(count_here), "+r"(count_before));
  int* s_mine = s_warp + warp;                  // this warp's count
  const int* s_count = s_warp + wl;             // lane wl reads warp wl's
  int gp = h;        // the stream pointer in g (ptr + h), the same in all
  int ready = 0;     // chunks every thread has seen arrive
  // Uniform thresholds of gp: from wait_at on, the next chunk to arrive
  // holds one of the L words a step may read; from refill_at on, the
  // stage of the oldest chunk in flight has been read to its end.
  constexpr int kNever = 0x7FFFFFFF;
  int wait_at = nchunks ? 1 - L : kNever;
  int refill_at = issued < nchunks ? (issued - kStages + 1) * kChunk : kNever;
  for (int j = 0, buf = 0; j < m; ++j, buf ^= 32) {
    if (gp >= wait_at) {
      do {
        bar_wait(smem_addr(bar + ready % kStages), (ready / kStages) & 1);
        ++ready;
      } while (ready < nchunks && ready * kChunk <= gp + L - 1);
      wait_at = ready < nchunks ? ready * kChunk - L + 1 : kNever;
    }
    bool need[K];
    unsigned packed = 0;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const unsigned slot = x[i] & (kM - 1);
      const unsigned t = s_dec[slot];
      const int sym = kWide ? s_sym[slot] : static_cast<int>(t >> 24);
      if (kMode == 0) {
        packed |= static_cast<unsigned>(sym & 0xFF) << (8 * i);
      } else if (static_cast<long long>(j) * L + K * tid + i < n) {
        out32[i] = sym >= n_sym - 1 ? marker : sym;
      }
      x[i] = (t & 0xFFFu) * (x[i] >> kScaleBits) + ((t >> 12) & 0xFFFu);
      need[i] = x[i] < kStateLo;
    }
    if (kMode == 0) {
      if (K == 4)
        *reinterpret_cast<unsigned*>(out8) = packed;
      else
#pragma unroll
        for (int i = 0; i < K; ++i) out8[i] = (packed >> (8 * i)) & 0xFF;
      out8 += L;
    } else {
      out32 += L;
    }
    // Needing lanes of this warp's threads before this one, and of the
    // whole warp: one ballot per lane slot.
    int before_me = 0, warp_total = 0;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const unsigned v = __ballot_sync(0xFFFFFFFFu, need[i]);
      before_me += __popc(v & below_mask);
      warp_total += __popc(v);
    }
    if (wl == 0) s_mine[buf] = warp_total;
    __syncthreads();
    // The block's count (low half) and the count of the warps before this
    // one (high half) in one reduction: each is at most 1,024.
    const int c = count_here ? s_count[buf] : 0;
    const int both =
        __reduce_add_sync(0xFFFFFFFFu, c | (count_before ? c << 16 : 0));
    int g = gp + (both >> 16) + before_me;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const unsigned w = ring[g & (kRing - 1)];
      if (need[i]) x[i] = (x[i] << 16) | (g < G ? w : 0u);
      g += need[i];
    }
    // Every read of the earlier steps is done and this step reads at or
    // past gp: refill each stage whose chunk lies wholly below gp.
    if (gp >= refill_at) {
      do {
        if (tid == 0) issue(issued);
        ++issued;
      } while (issued < nchunks && gp >= (issued - kStages + 1) * kChunk);
      refill_at = issued < nchunks ? (issued - kStages + 1) * kChunk : kNever;
    }
    gp += both & 0xFFFF;
  }
  // No copy may still be writing when the CTA's shared memory is released
  // (a corrupt blob stops short of its stream).
  if (tid == 0)
    for (int k = ready; k < issued; ++k)
      bar_wait(smem_addr(bar + k % kStages), (k / kStages) & 1);
#pragma unroll
  for (int i = 0; i < K; ++i) xf[b * L + K * tid + i] = x[i];
  if (tid == 0) ptrf[b] = gp - h;
}

// Lanes per thread of the decode: 4 wherever a block has at least 4
// warps' worth of lanes (L >= 128), so that the CTA keeps whole warps.
constexpr int decode_lanes_per_thread(int L) { return L >= 128 ? 4 : 1; }

template <bool kWide, int kMode, int K>
cudaError_t launch_decode_k(unsigned nb, int L, cudaStream_t s,
                            const unsigned* d, const int* st,
                            const unsigned* x0, const unsigned short* w,
                            long long S, const long long* ne, int m,
                            void* out, long long n, int n_sym, int marker,
                            unsigned* x1, long long* p1) {
  constexpr int bytes = decode_smem_bytes<kWide>();
  // Above the 48 KB static limit: allowed once per instantiation.
  static const cudaError_t attr = cudaFuncSetAttribute(
      rans_decode_kernel<kWide, kMode, K>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  rans_decode_kernel<kWide, kMode, K><<<nb, L / K, bytes, s>>>(
      d, st, x0, w, S, ne, m, out, n, n_sym, marker, x1, p1);
  return cudaGetLastError();
}

template <bool kWide, int kMode>
cudaError_t launch_decode(unsigned nb, int L, cudaStream_t s,
                          const unsigned* d, const int* st,
                          const unsigned* x0, const unsigned short* w,
                          long long S, const long long* ne, int m, void* out,
                          long long n, int n_sym, int marker, unsigned* x1,
                          long long* p1) {
  if (decode_lanes_per_thread(L) == 4)
    return launch_decode_k<kWide, kMode, 4>(nb, L, s, d, st, x0, w, S, ne, m,
                                            out, n, n_sym, marker, x1, p1);
  return launch_decode_k<kWide, kMode, 1>(nb, L, s, d, st, x0, w, S, ne, m,
                                          out, n, n_sym, marker, x1, p1);
}

// ------------------------------------------------------------- unpack

// Replaces: src/repro/kernels/rans.py unpack_words (:650, jnp), the
// inverse of the bit-pack kernel: rows of packed B-bit words -> (nb, be)
// int32 indices (element i of a row is bits [j*B, j*B + B) of word group
// i / 32, j = i % 32; core/packing.py's layout).
//
// Bound on the H100: bytes (B/8 bytes read and 4 written an element, a
// few integer operations).  One thread an element, with B a runtime
// argument, spent more instructions than bytes: a 64-bit division by the
// row length, one or two dependent 4-byte loads with runtime shifts and
// a branch an element (34 % of the bound at the CMIP step, PERF.md).
// Here the grid is (tile within the row, row), so no thread divides; B is
// a template parameter (1..24, the bit-pack kernel's dispatch), so every
// shift and spill test is a constant; and a CTA streams each tile of
// kTileGroups groups through shared memory (bitgroup.cuh).  The tile's
// packed words come in as 16-byte loads where the address allows them
// (rows are only 4-byte aligned) and 4-byte loads for the 0-3 words on
// either side; each thread unpacks its group from the padded word layout
// in registers and leaves its 32 indices as swizzled 16-byte chunks; the
// tile's indices go out as 16-byte stores, four consecutive elements a
// thread and 512 contiguous bytes a warp.
template <int B>
__global__ void __launch_bounds__(kTileThreads)
    rans_unpack_kernel(const unsigned char* __restrict__ byts, long long row,
                       int nb, long long groups, int4* __restrict__ out) {
  constexpr int kLoads = (kTileGroups * B / 4 + kTileThreads - 1) /
                         kTileThreads;
  __shared__ unsigned words[tile_word_slots<B>()];
  __shared__ int4 chunks[kTileGroups * 8];
  const int t = threadIdx.x;
  for (int b = blockIdx.y; b < nb; b += gridDim.y) {
    const unsigned* row_words =
        reinterpret_cast<const unsigned*>(byts + b * row);
    int4* row_out = out + b * groups * 8;
    for (long long g0 = static_cast<long long>(blockIdx.x) * kTileGroups;
         g0 < groups; g0 += static_cast<long long>(gridDim.x) * kTileGroups) {
      const int gt = static_cast<int>(
          groups - g0 < kTileGroups ? groups - g0 : kTileGroups);
      const unsigned* src = row_words + g0 * B;
      const int nw = gt * B;
      // 0-3 head words up to the first 16-byte boundary, nv 16-byte
      // chunks, 0-3 tail words; every load in flight before the first
      // shared store.
      const int head = min(
          nw, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(src) & 15))
                               & 15) / 4);
      const int nv = (nw - head) / 4;
      const int tail = nw - head - 4 * nv;
      const uint4* body = reinterpret_cast<const uint4*>(src + head);
      uint4 v[kLoads];
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int c = i * kTileThreads + t;
        if (c < nv) v[i] = __ldg(body + c);
      }
      unsigned edge = 0u;
      const int e = t < head ? t : head + 4 * nv + (t - head);
      if (t < head + tail) edge = __ldg(src + e);
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int c = i * kTileThreads + t;
        if (c < nv) {
          const int w0 = head + 4 * c;
          words[word_slot(w0)] = v[i].x;
          words[word_slot(w0 + 1)] = v[i].y;
          words[word_slot(w0 + 2)] = v[i].z;
          words[word_slot(w0 + 3)] = v[i].w;
        }
      }
      if (t < head + tail) words[word_slot(e)] = edge;
      __syncthreads();
      if (t < gt) {
        unsigned w[B];
#pragma unroll
        for (int k = 0; k < B; ++k) w[k] = words[word_slot(t * B + k)];
#pragma unroll
        for (int q = 0; q < 8; ++q)
          chunks[chunk_slot(t * 8 + q)] = make_int4(
              group_index<B>(w, 4 * q), group_index<B>(w, 4 * q + 1),
              group_index<B>(w, 4 * q + 2), group_index<B>(w, 4 * q + 3));
      }
      __syncthreads();
      // The next tile writes `words` only after this tile's reads of it
      // (the barrier above) and `chunks` only after its own first barrier.
      int4* dst = row_out + g0 * 8;
      for (int c = t; c < gt * 8; c += kTileThreads)
        dst[c] = chunks[chunk_slot(c)];
    }
  }
}

template <int B>
void launch_unpack(const unsigned char* byts, long long row, int nb,
                   long long groups, int* out, cudaStream_t s) {
  // Tiles of a row on x and rows on y, about 16 CTAs an SM in all (as
  // the bit-pack kernel); each CTA loops over the tiles and rows its
  // index does not cover.
  constexpr long long kCtas = 132LL * 16;
  const unsigned rows = nb < 65535 ? nb : 65535;
  const long long tiles = (groups + kTileGroups - 1) / kTileGroups;
  const long long per_row = (kCtas + rows - 1) / rows;
  const dim3 grid(static_cast<unsigned>(tiles < per_row ? tiles : per_row),
                  rows);
  rans_unpack_kernel<B><<<grid, kTileThreads, 0, s>>>(
      byts, row, nb, groups, reinterpret_cast<int4*>(out));
}

bool lanes_ok(int L) { return L == 32 || L == 128 || L == 512 || L == 1024; }

template <typename Sym>
int encode(const void* syms, long long n, int nb, const void* fc, int A,
           int fc_row, int L, int Lc, void* states, void* vals, void* masks,
           void* stream) {
  if (nb <= 0 || n < 0 || A < 2 || A > kM || !lanes_ok(L) || Lc < 32 ||
      Lc > kMaxLanesPerCta || Lc % 32 != 0 || L % Lc != 0 ||
      (n + L - 1) / L > (1LL << 31) / L)
    return cudaErrorInvalidValue;
  const int m = static_cast<int>((n + L - 1) / L);
  rans_encode_kernel<Sym>
      <<<static_cast<unsigned>(nb) * (L / Lc), Lc, A * sizeof(uint2),
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const Sym*>(syms), n, static_cast<const unsigned*>(fc),
          A, fc_row, m, L, static_cast<unsigned*>(states),
          static_cast<unsigned short*>(vals),
          static_cast<unsigned char*>(masks));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// syms: (nb, n) symbols; fc: fused tables, row stride fc_row (0: one table
// for every block); states (nb, L) u32, vals (nb, m*L) u16, masks
// (nb, m*L) bool, m = ceil(n / L); Lc lanes per CTA (a multiple of 32 that
// divides L, at most 256).
REPRO_EXPORT int rans_encode_u8(const void* syms, long long n, int nb,
                                const void* fc, int A, int fc_row, int L,
                                int Lc, void* states, void* vals, void* masks,
                                void* stream) {
  return encode<unsigned char>(syms, n, nb, fc, A, fc_row, L, Lc, states,
                               vals, masks, stream);
}

REPRO_EXPORT int rans_encode_i32(const void* syms, long long n, int nb,
                                 const void* fc, int A, int fc_row, int L,
                                 int Lc, void* states, void* vals, void* masks,
                                 void* stream) {
  return encode<int>(syms, n, nb, fc, A, fc_row, L, Lc, states, vals, masks,
                     stream);
}

// The encode's division on its own, for the tests: q = x / f and r = x % f
// for n pairs of u32 (f >= 1).
REPRO_EXPORT int rans_divide(const void* x, const void* f, long long n,
                             void* q, void* r, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  constexpr int kThreads = 256;
  rans_divide_kernel<<<repro_grid(n, kThreads, 132LL * 16), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(x), static_cast<const unsigned*>(f), n,
      static_cast<unsigned*>(q), static_cast<unsigned*>(r));
  return static_cast<int>(cudaGetLastError());
}

// dec (nb, 4096) u32, sym_tab (nb, 4096) i32 or NULL, states (nb, L) u32,
// stream (nb, S) u16 (rows at any 2-byte alignment), n_emit (nb,) i64; out
// as `mode` says; xf (nb, L) u32 and ptrf (nb,) i64 receive the final
// states and stream pointers.
REPRO_EXPORT int rans_decode(const void* dec, const void* sym_tab,
                             const void* states, const void* stream_words,
                             long long S, const void* n_emit, int nb, int m,
                             int L, void* out, long long n, int n_sym,
                             int marker, int mode, void* xf, void* ptrf,
                             void* stream) {
  if (nb <= 0 || m < 0 || S < 1 || S > (1LL << 30) || !lanes_ok(L) ||
      m > (1 << 30) / L || (mode != 0 && mode != 1) ||
      reinterpret_cast<uintptr_t>(stream_words) % 2 != 0 ||
      reinterpret_cast<uintptr_t>(dec) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(sym_tab) % 16 != 0 ||
      (mode == 0 && reinterpret_cast<uintptr_t>(out) % 4 != 0))
    return cudaErrorInvalidValue;
  const unsigned* d = static_cast<const unsigned*>(dec);
  const int* st = static_cast<const int*>(sym_tab);
  const unsigned* x0 = static_cast<const unsigned*>(states);
  const unsigned short* w = static_cast<const unsigned short*>(stream_words);
  const long long* ne = static_cast<const long long*>(n_emit);
  unsigned* x1 = static_cast<unsigned*>(xf);
  long long* p1 = static_cast<long long*>(ptrf);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (st != nullptr)
    e = mode ? launch_decode<true, 1>(nb, L, s, d, st, x0, w, S, ne, m, out,
                                      n, n_sym, marker, x1, p1)
             : launch_decode<true, 0>(nb, L, s, d, st, x0, w, S, ne, m, out,
                                      n, n_sym, marker, x1, p1);
  else
    e = mode ? launch_decode<false, 1>(nb, L, s, d, st, x0, w, S, ne, m, out,
                                       n, n_sym, marker, x1, p1)
             : launch_decode<false, 0>(nb, L, s, d, st, x0, w, S, ne, m, out,
                                       n, n_sym, marker, x1, p1);
  return static_cast<int>(e);
}

// byts: (nb, row) packed bytes, 4-byte aligned rows; out (nb, be) int32,
// 16-byte aligned.
REPRO_EXPORT int rans_unpack(const void* byts, int nb, long long row, int B,
                             long long be, void* out, void* stream) {
  if (nb <= 0 || be <= 0 || be % 32 != 0 || row % 4 != 0 || B < 1 || B > 24 ||
      row * 8 < be * B || reinterpret_cast<uintptr_t>(byts) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return cudaErrorInvalidValue;
  const unsigned char* in = static_cast<const unsigned char*>(byts);
  int* idx = static_cast<int*>(out);
  const long long groups = be / 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (B) {
#define REPRO_UNPACK_CASE(B) \
  case B:                    \
    launch_unpack<B>(in, row, nb, groups, idx, s); \
    break;
    REPRO_UNPACK_CASE(1) REPRO_UNPACK_CASE(2) REPRO_UNPACK_CASE(3)
    REPRO_UNPACK_CASE(4) REPRO_UNPACK_CASE(5) REPRO_UNPACK_CASE(6)
    REPRO_UNPACK_CASE(7) REPRO_UNPACK_CASE(8) REPRO_UNPACK_CASE(9)
    REPRO_UNPACK_CASE(10) REPRO_UNPACK_CASE(11) REPRO_UNPACK_CASE(12)
    REPRO_UNPACK_CASE(13) REPRO_UNPACK_CASE(14) REPRO_UNPACK_CASE(15)
    REPRO_UNPACK_CASE(16) REPRO_UNPACK_CASE(17) REPRO_UNPACK_CASE(18)
    REPRO_UNPACK_CASE(19) REPRO_UNPACK_CASE(20) REPRO_UNPACK_CASE(21)
    REPRO_UNPACK_CASE(22) REPRO_UNPACK_CASE(23) REPRO_UNPACK_CASE(24)
#undef REPRO_UNPACK_CASE
  }
  return static_cast<int>(cudaGetLastError());
}

REPRO_ERROR_STRING(rans)
