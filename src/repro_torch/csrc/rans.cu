// Interleaved rANS of the device entropy stage: encode, decode, and the
// unpack of B-bit index blocks.  32-bit states, 16-bit renormalization,
// 12-bit frequencies (kernels/rans.py holds the format and the plain
// versions these kernels must equal bit for bit).
//
// Replaces: src/repro/kernels/rans.py encode_bytes_body (:424) and
// decode_scan_body (:688), both a lax.scan over the rows of a block group
// in the reference, not Pallas; rans_unpack replaces unpack_words (:650).
//
// Design.  One CTA per block, one thread per lane (L = 32..1024, fixed by
// the blob format through lanes_for).  A lane's state lives in a register
// for the whole block; the fused table (encode: freq | cum << 13; decode:
// freq | offset << 12 | symbol << 24, plus a slot->symbol table for
// alphabets wider than 256) sits in shared memory.
//
//   encode  walks the rows from m-1 down to 0 and writes each step's u16
//           value and emit flag in the decoder's order (row ascending,
//           lane ascending); the caller compacts the flagged values.
//   decode  walks the rows forward; each step a lane that needs a word
//           takes it at ptr + (its rank among the needing lanes): a
//           __ballot_sync/__popc inside the warp and the 32 warp counts in
//           shared memory (double-buffered, so one __syncthreads a step).
//           Every stream read is guarded by the block's n_emit; the final
//           states and pointer go back so that the host check is the
//           reference's _check_decoded.
//
// Bound on the H100: not bytes or operations but the format's
// parallelism.  A 1 MB v1 block is 1,024 lanes x m = 1,024 dependent
// steps (v2 at B = 4: 2,048 steps); the CMIP step has two blocks, so two
// of the 132 SMs work and each step's latency chain (a shared load, a
// u32 division in encode; a shared load, a block scan, a dependent stream
// load in decode) sets the time.  Prefetching the stream into shared
// memory is left for a later change.
#include "common.cuh"

namespace {

constexpr int kScaleBits = 12;
constexpr int kM = 1 << kScaleBits;
constexpr unsigned kStateLo = 1u << 16;

template <typename Sym>
__global__ void __launch_bounds__(1024)
    rans_encode_kernel(const Sym* __restrict__ syms, long long n,
                       const unsigned* __restrict__ fc, int A, int fc_row,
                       int m, unsigned* __restrict__ states,
                       unsigned short* __restrict__ vals,
                       unsigned char* __restrict__ masks) {
  extern __shared__ unsigned s_fc[];
  const int L = blockDim.x;
  const int lane = threadIdx.x;
  const long long b = blockIdx.x;
  const unsigned* tab = fc + b * fc_row;
  for (int i = lane; i < A; i += L) s_fc[i] = tab[i];
  __syncthreads();
  const Sym* row = syms + b * n;
  const long long base = b * static_cast<long long>(m) * L;
  unsigned x = kStateLo;
#pragma unroll 4
  for (int j = m - 1; j >= 0; --j) {
    const long long pos = static_cast<long long>(j) * L + lane;
    int s = 0;
    if (pos < n) s = max(0, min(static_cast<int>(row[pos]), A - 1));
    const unsigned v = s_fc[s];
    const unsigned f = v & 0x1FFFu;
    const bool emit = (x >> (32 - kScaleBits)) >= f;
    vals[base + pos] = static_cast<unsigned short>(x & 0xFFFFu);
    masks[base + pos] = emit;
    if (emit) x >>= 16;
    const unsigned q = x / f;
    x = (q << kScaleBits) + (x - q * f) + (v >> 13);
  }
  states[b * L + lane] = x;
}

// mode 0: write every decoded symbol as a byte, (nb, m*L).
// mode 1: write the first n symbols as B-bit indices, (nb, n) int32, ids
//         >= n_sym - 1 mapped to `marker` (the v2 blob's marker symbol).
template <bool kWide>
__global__ void __launch_bounds__(1024)
    rans_decode_kernel(const unsigned* __restrict__ dec,
                       const int* __restrict__ sym_tab,
                       const unsigned* __restrict__ states,
                       const unsigned short* __restrict__ stream,
                       long long S, const long long* __restrict__ n_emit,
                       int m, int mode, void* __restrict__ out, long long n,
                       int n_sym, int marker, unsigned* __restrict__ xf,
                       long long* __restrict__ ptrf) {
  __shared__ unsigned s_dec[kM];
  __shared__ int s_sym[kWide ? kM : 1];
  __shared__ int s_warp[2][32];
  const int L = blockDim.x;
  const int lane = threadIdx.x;
  const int warp = lane >> 5;
  const int wl = lane & 31;
  const int nwarps = L >> 5;
  const long long b = blockIdx.x;
  for (int i = lane; i < kM; i += L) {
    s_dec[i] = dec[b * kM + i];
    if (kWide) s_sym[i] = sym_tab[b * kM + i];
  }
  __syncthreads();
  const unsigned short* st = stream + b * S;
  const long long ne = min(n_emit[b], S);
  unsigned char* out8 =
      static_cast<unsigned char*>(out) + b * static_cast<long long>(m) * L;
  int* out32 = static_cast<int*>(out) + b * n;
  const unsigned below_mask = (1u << wl) - 1u;
  unsigned x = states[b * L + lane];
  long long ptr = 0;
  for (int j = 0; j < m; ++j) {
    const unsigned slot = x & (kM - 1);
    const unsigned t = s_dec[slot];
    const int sym = kWide ? s_sym[slot] : static_cast<int>(t >> 24);
    const long long pos = static_cast<long long>(j) * L + lane;
    if (mode == 0) {
      out8[pos] = static_cast<unsigned char>(sym);
    } else if (pos < n) {
      out32[pos] = sym >= n_sym - 1 ? marker : sym;
    }
    x = (t & 0xFFFu) * (x >> kScaleBits) + ((t >> 12) & 0xFFFu);
    const bool need = x < kStateLo;
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, need);
    if (wl == 0) s_warp[j & 1][warp] = __popc(ballot);
    __syncthreads();
    const int c = wl < nwarps ? s_warp[j & 1][wl] : 0;
    const int total = __reduce_add_sync(0xFFFFFFFFu, c);
    const int before = __reduce_add_sync(0xFFFFFFFFu, wl < warp ? c : 0);
    if (need) {
      const long long p = ptr + before + __popc(ballot & below_mask);
      x = (x << 16) | (p < ne ? static_cast<unsigned>(st[p]) : 0u);
    }
    ptr += total;
  }
  xf[b * L + lane] = x;
  if (lane == 0) ptrf[b] = ptr;
}

// Element i of row b is bits [j*B, j*B + B) of word group i / 32 of the
// row's little-endian words, j = i % 32 (core/packing.py's layout).
__global__ void rans_unpack_kernel(const unsigned char* __restrict__ byts,
                                   long long row, int B, long long be,
                                   long long total, int* __restrict__ out) {
  const unsigned mask = (1u << B) - 1u;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += stride) {
    const long long b = i / be;
    const long long e = i - b * be;
    const unsigned* words =
        reinterpret_cast<const unsigned*>(byts + b * row) + (e >> 5) * B;
    const int bit0 = static_cast<int>(e & 31) * B;
    const int w = bit0 >> 5;
    const int s = bit0 & 31;
    unsigned v = __ldg(words + w) >> s;
    if (s + B > 32) v |= __ldg(words + w + 1) << (32 - s);
    out[i] = static_cast<int>(v & mask);
  }
}

bool lanes_ok(int L) { return L == 32 || L == 128 || L == 512 || L == 1024; }

template <typename Sym>
int encode(const void* syms, long long n, int nb, const void* fc, int A,
           int fc_row, int L, void* states, void* vals, void* masks,
           void* stream) {
  if (nb <= 0 || n < 0 || A < 2 || A > kM || !lanes_ok(L))
    return cudaErrorInvalidValue;
  const int m = static_cast<int>((n + L - 1) / L);
  rans_encode_kernel<Sym><<<nb, L, A * sizeof(unsigned),
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Sym*>(syms), n, static_cast<const unsigned*>(fc), A,
      fc_row, m, static_cast<unsigned*>(states),
      static_cast<unsigned short*>(vals), static_cast<unsigned char*>(masks));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// syms: (nb, n) symbols; fc: fused tables, row stride fc_row (0: one table
// for every block); states (nb, L) u32, vals (nb, m*L) u16, masks
// (nb, m*L) bool, m = ceil(n / L).
REPRO_EXPORT int rans_encode_u8(const void* syms, long long n, int nb,
                                const void* fc, int A, int fc_row, int L,
                                void* states, void* vals, void* masks,
                                void* stream) {
  return encode<unsigned char>(syms, n, nb, fc, A, fc_row, L, states, vals,
                               masks, stream);
}

REPRO_EXPORT int rans_encode_i32(const void* syms, long long n, int nb,
                                 const void* fc, int A, int fc_row, int L,
                                 void* states, void* vals, void* masks,
                                 void* stream) {
  return encode<int>(syms, n, nb, fc, A, fc_row, L, states, vals, masks,
                     stream);
}

// dec (nb, 4096) u32, sym_tab (nb, 4096) i32 or NULL, states (nb, L) u32,
// stream (nb, S) u16, n_emit (nb,) i64; out as `mode` says; xf (nb, L)
// u32 and ptrf (nb,) i64 receive the final states and stream pointers.
REPRO_EXPORT int rans_decode(const void* dec, const void* sym_tab,
                             const void* states, const void* stream_words,
                             long long S, const void* n_emit, int nb, int m,
                             int L, void* out, long long n, int n_sym,
                             int marker, int mode, void* xf, void* ptrf,
                             void* stream) {
  if (nb <= 0 || m < 0 || S < 1 || !lanes_ok(L) || (mode != 0 && mode != 1))
    return cudaErrorInvalidValue;
  const unsigned* d = static_cast<const unsigned*>(dec);
  const int* st = static_cast<const int*>(sym_tab);
  const unsigned* x0 = static_cast<const unsigned*>(states);
  const unsigned short* w = static_cast<const unsigned short*>(stream_words);
  const long long* ne = static_cast<const long long*>(n_emit);
  unsigned* x1 = static_cast<unsigned*>(xf);
  long long* p1 = static_cast<long long*>(ptrf);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (st != nullptr) {
    rans_decode_kernel<true><<<nb, L, 0, s>>>(d, st, x0, w, S, ne, m, mode,
                                              out, n, n_sym, marker, x1, p1);
  } else {
    rans_decode_kernel<false><<<nb, L, 0, s>>>(d, st, x0, w, S, ne, m, mode,
                                               out, n, n_sym, marker, x1, p1);
  }
  return static_cast<int>(cudaGetLastError());
}

// byts: (nb, row) packed bytes, 4-byte aligned rows; out (nb, be) int32.
REPRO_EXPORT int rans_unpack(const void* byts, int nb, long long row, int B,
                             long long be, void* out, void* stream) {
  if (nb <= 0 || be <= 0 || be % 32 != 0 || row % 4 != 0 || B < 1 || B > 24 ||
      row * 8 < be * B)
    return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(nb) * be;
  constexpr int kThreads = 256;
  rans_unpack_kernel<<<repro_grid(total, kThreads, 132LL * 16), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(byts), row, B, be, total,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

REPRO_ERROR_STRING(rans)
