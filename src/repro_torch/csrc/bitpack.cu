// B-bit index packing: each group of 32 indices becomes B uint32 words of
// the LSB-first little-endian bitstream of core/packing.py (element j of a
// group occupies stream bits [j*B, (j+1)*B) of the group's 32*B bits).
//
// Replaces: src/repro/kernels/bitpack.py pack_bits (Pallas `_kernel`,
// pallas_call at :54).  The TPU kernel unrolled the 32 element positions
// into vector shifts over a (rows, 32) tile; here one thread packs one
// group, with B a template parameter (1..24) so that every word index and
// shift is a compile-time constant and the B words stay in registers.
//
// Bound on the H100: bytes (128 B read and 4*B B written per group, a
// handful of integer ops), so the design is about access shape.  A thread
// that reads its own group and writes its own B words makes every warp
// instruction touch 32 lines (a 4-byte store at a stride of 4*B bytes),
// which held the first version of this kernel to 15 % of the bound at
// B = 24 (PERF.md).  Here a CTA streams tiles of kTileGroups groups
// through shared memory (bitgroup.cuh): the tile's indices come in as
// 16-byte loads, neighbouring threads on neighbouring addresses; each
// thread packs its group from the swizzled chunks into registers and
// leaves its B words in the padded word layout; the tile's
// kTileGroups*B words (a multiple of 16 bytes for every B) go out as
// contiguous 16-byte stores.  A ragged last tile loads, packs and stores
// only its groups (its last 1-3 words with 4-byte stores).  The grid
// covers the tiles, at most 16 CTAs an SM's worth (registers and shared
// memory let 4-11 run at once, by B; more than one wave of CTAs balances
// the tail better than one, PERF.md), each looping over tiles.
//
// The caller packs the whole marker-padded index table in one launch and
// slices it per block on the host: block_elems is a multiple of 32, so
// every block spans whole words.
#include <cstdint>

#include "bitgroup.cuh"
#include "common.cuh"

namespace {

template <int B>
__global__ void __launch_bounds__(kTileThreads)
    pack_bits_kernel(const int4* __restrict__ idx, uint4* __restrict__ out,
                     long long groups) {
  __shared__ int4 chunks[kTileGroups * 8];
  __shared__ unsigned words[tile_word_slots<B>()];
  const int t = threadIdx.x;
  for (long long g0 = static_cast<long long>(blockIdx.x) * kTileGroups;
       g0 < groups; g0 += static_cast<long long>(gridDim.x) * kTileGroups) {
    const int gt = static_cast<int>(
        groups - g0 < kTileGroups ? groups - g0 : kTileGroups);
    // The tile's indices: 8 16-byte chunks a group, all loads in flight
    // before the first shared store.
    const int4* src = idx + g0 * 8;
    int4 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = i * kTileThreads + t;
      if (c < gt * 8) v[i] = __ldg(src + c);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = i * kTileThreads + t;
      if (c < gt * 8) chunks[chunk_slot(c)] = v[i];
    }
    __syncthreads();
    if (t < gt) {
      unsigned w[B];
#pragma unroll
      for (int k = 0; k < B; ++k) w[k] = 0u;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        pack_chunk<B>(w, q, chunks[chunk_slot(t * 8 + q)]);
#pragma unroll
      for (int k = 0; k < B; ++k) words[word_slot(t * B + k)] = w[k];
    }
    __syncthreads();
    // gt * B words from word g0 * B on (16-byte aligned: g0 is a multiple
    // of kTileGroups, a multiple of 4).  The next tile writes `chunks`
    // only after this tile's reads of it (the barrier above) and `words`
    // only after its own first barrier.
    const int nw = gt * B;
    uint4* dst = out + g0 * B / 4;
    for (int c = t; c < nw / 4; c += kTileThreads) {
      const int w0 = 4 * c;
      dst[c] = make_uint4(words[word_slot(w0)], words[word_slot(w0 + 1)],
                          words[word_slot(w0 + 2)],
                          words[word_slot(w0 + 3)]);
    }
    if (t < nw % 4) {
      const int w = nw / 4 * 4 + t;
      reinterpret_cast<unsigned*>(dst)[w] = words[word_slot(w)];
    }
  }
}

template <int B>
void launch(const int* idx, unsigned* out, long long groups,
            cudaStream_t stream) {
  const long long tiles = (groups + kTileGroups - 1) / kTileGroups;
  pack_bits_kernel<B><<<repro_grid(tiles, 1, 132LL * 16), kTileThreads, 0,
                        stream>>>(reinterpret_cast<const int4*>(idx),
                                  reinterpret_cast<uint4*>(out), groups);
}

}  // namespace

// `n` must be a multiple of 32 and `idx` 16-byte aligned (the wrapper
// checks both); `out` (16-byte aligned) receives n / 32 * b_bits words.
REPRO_EXPORT int pack_bits_i32(const void* idx, long long n, void* out,
                               int b_bits, void* stream) {
  if (n <= 0 || n % 32 != 0 || reinterpret_cast<uintptr_t>(idx) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return cudaErrorInvalidValue;
  const int* in = static_cast<const int*>(idx);
  unsigned* words = static_cast<unsigned*>(out);
  const long long groups = n / 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (b_bits) {
#define REPRO_PACK_CASE(B) \
  case B:                  \
    launch<B>(in, words, groups, s); \
    break;
    REPRO_PACK_CASE(1) REPRO_PACK_CASE(2) REPRO_PACK_CASE(3)
    REPRO_PACK_CASE(4) REPRO_PACK_CASE(5) REPRO_PACK_CASE(6)
    REPRO_PACK_CASE(7) REPRO_PACK_CASE(8) REPRO_PACK_CASE(9)
    REPRO_PACK_CASE(10) REPRO_PACK_CASE(11) REPRO_PACK_CASE(12)
    REPRO_PACK_CASE(13) REPRO_PACK_CASE(14) REPRO_PACK_CASE(15)
    REPRO_PACK_CASE(16) REPRO_PACK_CASE(17) REPRO_PACK_CASE(18)
    REPRO_PACK_CASE(19) REPRO_PACK_CASE(20) REPRO_PACK_CASE(21)
    REPRO_PACK_CASE(22) REPRO_PACK_CASE(23) REPRO_PACK_CASE(24)
#undef REPRO_PACK_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

REPRO_ERROR_STRING(bitpack)
