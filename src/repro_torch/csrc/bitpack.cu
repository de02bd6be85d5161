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
// handful of integer ops).  A thread reads its group as eight 16-byte
// loads; neighbouring threads read neighbouring 128-byte lines, which L1
// serves after the first load of each line.  Writes are 4-byte stores at a
// stride of B words; staging them through shared memory for full
// coalescing is left for a later change.
//
// The caller packs the whole marker-padded index table in one launch and
// slices it per block on the host: block_elems is a multiple of 32, so
// every block spans whole words.
#include "common.cuh"

template <int B>
__global__ void pack_bits_kernel(const int* __restrict__ idx,
                                 unsigned* __restrict__ out,
                                 long long groups) {
  constexpr unsigned kMask = (1u << B) - 1u;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < groups; g += stride) {
    unsigned w[B];
#pragma unroll
    for (int k = 0; k < B; ++k) w[k] = 0u;
    const int4* src = reinterpret_cast<const int4*>(idx + g * 32);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int4 v4 = __ldg(src + q);
      const int vals[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int bit0 = (q * 4 + t) * B;
        const int wi = bit0 / 32;
        const int s = bit0 % 32;
        const unsigned v = static_cast<unsigned>(vals[t]) & kMask;
        w[wi] |= v << s;
        if (s + B > 32) w[wi + 1] |= v >> (32 - s);  // spills into the next word
      }
    }
    unsigned* dst = out + g * B;
#pragma unroll
    for (int k = 0; k < B; ++k) dst[k] = w[k];
  }
}

template <int B>
static void launch(const int* idx, unsigned* out, long long groups,
                   cudaStream_t stream) {
  constexpr int kThreads = 128;
  pack_bits_kernel<B><<<repro_grid(groups, kThreads, 132LL * 64), kThreads,
                        0, stream>>>(idx, out, groups);
}

// `n` must be a multiple of 32 and `idx` 16-byte aligned (the wrapper
// checks both); `out` receives n / 32 * b_bits words.
REPRO_EXPORT int pack_bits_i32(const void* idx, long long n, void* out,
                               int b_bits, void* stream) {
  if (n <= 0 || n % 32 != 0) return cudaErrorInvalidValue;
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
