// The B-bit group layout shared by the bit-pack kernel (bitpack.cu) and
// its inverse, the unpack of the rANS read path (rans.cu): each group of
// 32 indices is B uint32 words of an LSB-first bitstream, element j at
// stream bits [j*B, (j+1)*B) (core/packing.py).
//
// Both kernels stream a tile of kTileGroups groups through shared memory,
// one thread per group, so that device memory sees only coalesced 16-byte
// loads and stores while each thread shifts its group with B a template
// parameter (every word index, shift and spill test a constant).  The two
// shared-memory layouts below keep those accesses free of bank conflicts
// (at most 2-way for the packed words):
//
//   indices   a tile's 32-bit indices as 16-byte chunks, chunk q of group
//             g in slot g*8 + (q ^ (g & 7)): eight threads that copy one
//             group's chunks, and eight threads that each read chunk q of
//             their own group, hit eight different 16-byte bank groups.
//   words     a tile's packed words with one word of padding after every
//             32 (word w at w + w / 32): a thread reading word k of its
//             group (stride B between threads) and a thread copying four
//             consecutive words land in different banks.
#pragma once

constexpr int kTileThreads = 128;
constexpr int kTileGroups = kTileThreads;  // one group a thread

// Shared-memory slot of 16-byte index chunk c (4 indices) of a tile.
__device__ __forceinline__ int chunk_slot(int c) {
  return (c & ~7) | ((c ^ (c >> 3)) & 7);
}

// Shared-memory index of packed word w of a tile, and the words a tile
// of kTileGroups groups takes.
__device__ __forceinline__ int word_slot(int w) { return w + (w >> 5); }
template <int B>
__host__ __device__ constexpr int tile_word_slots() {
  return kTileGroups * B + kTileGroups * B / 32;
}

// Index j of a group, from the group's B words.  Callers unroll their
// loops over j, so that the word index, the shift and the spill test are
// constants and w[] stays in registers.
template <int B>
__device__ __forceinline__ int group_index(const unsigned (&w)[B], int j) {
  const int bit0 = j * B;
  const int wi = bit0 / 32;
  const int s = bit0 % 32;
  unsigned v = w[wi] >> s;
  if (s + B > 32) v |= w[wi + 1] << (32 - s);  // spilled into the next word
  return static_cast<int>(v & ((1u << B) - 1u));
}

// ORs indices 4q..4q+3 of a group (the chunk x) into its B words (q a
// constant after the caller's unroll, as j above).
template <int B>
__device__ __forceinline__ void pack_chunk(unsigned (&w)[B], int q, int4 x) {
  const int vals[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int bit0 = (q * 4 + t) * B;
    const int wi = bit0 / 32;
    const int s = bit0 % 32;
    const unsigned v = static_cast<unsigned>(vals[t]) & ((1u << B) - 1u);
    w[wi] |= v << s;
    if (s + B > 32) w[wi + 1] |= v >> (32 - s);  // spills into the next word
  }
}
