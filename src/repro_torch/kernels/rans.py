"""Block-parallel interleaved rANS coder: the device entropy stage.

The port's counterpart of the reference's ``kernels/rans.py``.  Each
index-table block is coded independently by L interleaved rANS lanes
(lane l owns symbols l, l+L, l+2L, ...), 32-bit states, 16-bit
renormalization and 12-bit frequencies, so every symbol emits exactly 0
or 1 u16 and the decoder replays the emission schedule without per-lane
lengths.  Blob layout (little-endian), self-describing per block:

  v1 (rANS):  u32 raw_len | u8 1 | u8 scale_bits | u16 L |
              256*u16 freq | u32 n_emit | L*u32 states | n_emit*u16 stream
  v0 (raw):   u32 raw_len | u8 0 | raw bytes   (store fallback)
  v2 (symbol rANS): u32 n_elems | u8 2 | u8 scale_bits | u8 b_bits |
              u16 L | u16 n_sym | n_sym*u16 freq | u32 n_emit |
              L*u32 states | n_emit*u16 stream

The host part -- tables, the NumPy coder (``encode_np``/``decode_np``),
blob assembly and parsing, ``compress``/``decompress`` -- is a copy of
the reference's and the oracle of everything below it.

The device part runs the lane loops as hand-written CUDA (``csrc/rans.cu``):

  ``rans_encode``  replaces the reference's ``encode_bytes_body``
                   (src/repro/kernels/rans.py:424, a ``lax.scan``)
  ``rans_decode``  replaces ``decode_scan_body`` (:688, a ``lax.scan``),
                   with the v2 marker map of ``decode_idx_group_syms``
  ``rans_unpack``  replaces ``unpack_words`` (:650): packed bytes back
                   to B-bit indices (v1 and v0 index blocks)

Bound on the H100: neither bytes nor operations.  ``lanes_for`` is part
of the blob format, so a block offers at most 1,024 lanes, each a chain
of m = ceil(n / L) dependent steps (1,024 for a 1 MB v1 block, 2,048 for
v2 at B = 4), and a kernel's time is m times one step's latency.  The
encode's lanes are independent, so a block's lanes are spread over
L / Lc CTAs (``encode_lanes_per_cta``; a CMIP step's two blocks run on
16 SMs) and its division is a mul-hi by a reciprocal held in shared
memory.  The decode's lanes share one stream pointer, so a block stays
one CTA, each thread running four lanes; its stream arrives by bulk
async copies into a ring in shared memory ahead of the pointer, so a
step waits on shared loads, a barrier and a block reduction, not on L2
or HBM.

Beside each kernel is its plain PyTorch version: the same lane loop as
vectors of nb*L lanes, in int64 masked to 32 bits (CPU ``torch.uint32``
has no shifts or adds).  ``kernels.ops`` takes the plain version for CPU
tensors and the kernel for CUDA tensors, with no fallback.  u32 words
cross the kernels' interface as int32 tensors and u16 stream words as
int16 tensors, holding the same bits.

Telemetry of the device entropy stage: each blocking call is a ``sync.*``
span of its own (``sync.samples``, ``sync.freq_up``, the masked select
and the three copies of the coded streams ``sync.stream_select``,
``sync.stream_states``, ``sync.stream_words``, ``sync.stream_counts``,
and ``sync.raw_block`` for a block that codes larger than raw), the host
tables are ``entropy.tables`` and the blob loop ``entropy.assemble``.
"""
from __future__ import annotations

import ctypes
import struct
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.kernels._build import Kernel, check_cuda
from repro_torch.obs import telemetry

SCALE_BITS = 12
M = 1 << SCALE_BITS                 # total frequency budget per table
STATE_LO = 1 << 16                  # renormalization lower bound
_HDR = struct.Struct("<IBBH")       # raw_len, version, scale_bits, lanes
_RAW_HDR = struct.Struct("<IB")     # raw_len, version=0
# v2 symbol-level header: n_elems, version, scale_bits, b_bits, lanes, n_sym
_HDR2 = struct.Struct("<IBBBHH")
_V_RANS = 1
_V_RAW = 0
_V_SYM = 2

# Below this raw payload (total packed bytes of a step) the drivers keep
# the host coder.  The value is the reference's, so both packages route
# the same steps; it is not tuned for the card, where the device route is
# a few launches and one copy back.  chip_smoke.py times both routes at
# small payloads (PERF.md gives the crossover).  Blobs are byte-identical
# either way, so this is pure routing.
DEVICE_MIN_BYTES = 256 << 10


def lanes_for(n: int) -> int:
    """Interleave width for an n-byte block (deterministic: part of the
    format -- encoder and decoder must agree).  More lanes amortize the
    scan length; each lane costs 4 bytes of final state."""
    if n >= 512 << 10:
        return 1024
    if n >= 64 << 10:
        return 512
    if n >= 8 << 10:
        return 128
    return 32


def encode_lanes_per_cta(nb: int, L: int) -> int:
    """Lanes of one CTA of the encode kernel for ``nb`` blocks of ``L``
    lanes (the launch, not the format: each lane writes the same
    positions whichever CTA runs it).  At most four warps, one per
    scheduler of an SM, and at least two CTAs per block wherever a block
    has more than one warp; L = 32 is a single warp.  The block count does
    not enter: 64 and 128 lanes ran within 2 % of each other from 2 to 16
    blocks, 256 up to 25 % slower (scripts/rans_bench.py, PERF.md)."""
    del nb
    return max(32, min(128, L // 2))


def sample_stride(n: int) -> int:
    """Byte-sampling stride for the frequency tables (deterministic, part
    of the format contract between the host and device encoders)."""
    return 16 if n >= 256 << 10 else 1


# ------------------------------------------------------------- tables

def freq_from_counts(counts: np.ndarray) -> np.ndarray:
    """(A,) counts -> (A,) uint16 frequencies summing to M, every symbol
    >= 1 (so unsampled symbols stay encodable).  A <= M required.

    Deterministic largest-quota allocation: each symbol gets 1 plus its
    share of the remaining budget via cumulative integer boundaries --
    one vector pass, no data-dependent iteration, identical results on
    every path.  The byte coders use A=256; the symbol-level v2 coder
    passes the dense rank alphabet (A = k_eff + 1).
    """
    counts = np.asarray(counts, np.uint64)
    A = counts.size
    if A > M:
        raise ValueError(f"alphabet {A} exceeds frequency budget {M}")
    total = int(counts.sum())
    if total == 0:
        base = np.full(A, M // A, np.uint64)
        base[: M - int(base.sum())] += 1      # exact sum for A not | M
        return base.astype(np.uint16)
    budget = np.uint64(M - A)
    bounds = (np.cumsum(counts) * budget) // np.uint64(total)
    extra = np.diff(np.concatenate([[np.uint64(0)], bounds]))
    return (1 + extra).astype(np.uint16)


def freq_table(raw: np.ndarray) -> np.ndarray:
    """Frequency table of a raw byte block (strided sample + normalize)."""
    raw = np.asarray(raw, np.uint8)
    if raw.size == 0:
        return freq_from_counts(np.zeros(256, np.uint64))
    sample = raw[:: sample_stride(raw.size)]
    return freq_from_counts(np.bincount(sample, minlength=256))


def _cum(freq: np.ndarray) -> np.ndarray:
    f = np.asarray(freq, np.uint64)
    return np.concatenate([[np.uint64(0)], np.cumsum(f)[:-1]])


def pack_fc(freq: np.ndarray) -> np.ndarray:
    """Fuse freq+cumfreq into one u32 table (freq in bits 0..12, cum in
    13..24) so the scan body does a single gather per symbol."""
    return (np.asarray(freq, np.uint32)
            | (_cum(freq).astype(np.uint32) << np.uint32(13)))


# ------------------------------------------------- NumPy coder (oracle)

def encode_np(raw: np.ndarray, freq: np.ndarray):
    """Encode one block: (L,) u32 final states + (n_emit,) u16 stream.

    ``raw`` is a symbol array (uint8 bytes, or any int array of ids <
    ``freq.size`` for the symbol-level coder).  Lanes interleave by
    stride L; symbols are visited in reverse row order (standard rANS
    encodes backwards); the emitted stream is laid out in the decoder's
    read order (row ascending, lane ascending).
    """
    raw = np.asarray(raw)
    if raw.dtype != np.uint8:
        raw = raw.astype(np.int64)
    n = raw.size
    L = lanes_for(n)
    m = -(-n // L) if n else 0
    sy = np.zeros(m * L, raw.dtype)
    sy[:n] = raw
    sy = sy.reshape(m, L)
    f64 = np.asarray(freq, np.uint64)
    c64 = _cum(freq)
    f_rows = f64[sy]                    # (m, L) gathered once
    c_rows = c64[sy]
    x = np.full(L, STATE_LO, np.uint64)
    vals = np.zeros((m, L), np.uint16)
    masks = np.zeros((m, L), bool)
    for j in range(m - 1, -1, -1):
        f = f_rows[j]
        mask = x >= (f << np.uint64(32 - SCALE_BITS))
        vals[j] = (x & np.uint64(0xFFFF)).astype(np.uint16)
        masks[j] = mask
        x = np.where(mask, x >> np.uint64(16), x)
        q = x // f
        x = (q << np.uint64(SCALE_BITS)) + (x - q * f) + c_rows[j]
    return x.astype(np.uint32), vals[masks]


def decode_np(states: np.ndarray, stream: np.ndarray, freq: np.ndarray,
              n: int, L: int) -> np.ndarray:
    """Inverse of encode_np (lane-vectorized; validates stream integrity).

    Returns uint8 symbols for byte alphabets (freq.size <= 256), int32
    symbol ids for wider (symbol-level) alphabets.
    """
    m = -(-n // L) if n else 0
    A = np.asarray(freq).size
    f64 = np.asarray(freq, np.uint64)
    c64 = _cum(freq)
    sdt = np.uint8 if A <= 256 else np.int32
    slot2sym = np.repeat(np.arange(A, dtype=sdt),
                         np.asarray(freq, np.int64))
    if slot2sym.size != M:
        raise ValueError("corrupt rANS table: frequencies sum != 2^scale")
    x = np.asarray(states, np.uint64).copy()
    if x.size != L:
        raise ValueError("corrupt rANS blob: state count != lanes")
    out = np.zeros((m, L), sdt)
    ptr = 0
    for j in range(m):
        slot = x & np.uint64(M - 1)
        s = slot2sym[slot]
        out[j] = s
        x = f64[s] * (x >> np.uint64(SCALE_BITS)) + slot - c64[s]
        need = x < STATE_LO
        k = int(need.sum())
        if k:
            nxt = stream[ptr:ptr + k]
            if nxt.size != k:
                raise ValueError("corrupt rANS blob: stream underrun")
            x[need] = (x[need] << np.uint64(16)) | nxt.astype(np.uint64)
            ptr += k
    if ptr != stream.size or (x != STATE_LO).any():
        raise ValueError("corrupt rANS blob: stream not consumed cleanly")
    return out.reshape(-1)[:n]


# ------------------------------------------------------- blob assembly

def blob_nbytes(n_emit: int, L: int) -> int:
    return _HDR.size + 512 + 4 + 4 * L + 2 * n_emit


def assemble_blob(raw_len: int, freq: np.ndarray, states: np.ndarray,
                  stream: np.ndarray,
                  raw_bytes: Optional[Callable[[], bytes]] = None) -> bytes:
    """Assemble the self-describing block blob; falls back to the v0 raw
    container when rANS would not beat store (``raw_bytes`` supplies the
    payload lazily -- only fetched for losing blocks)."""
    L = int(states.size)
    if raw_bytes is not None and \
            blob_nbytes(stream.size, L) >= raw_len + _RAW_HDR.size:
        return _RAW_HDR.pack(raw_len, _V_RAW) + raw_bytes()
    return b"".join([
        _HDR.pack(raw_len, _V_RANS, SCALE_BITS, L),
        np.ascontiguousarray(freq, np.uint16).tobytes(),
        struct.pack("<I", int(stream.size)),
        np.ascontiguousarray(states, np.uint32).tobytes(),
        np.ascontiguousarray(stream, np.uint16).tobytes(),
    ])


def blob_nbytes_sym(n_emit: int, L: int, n_sym: int) -> int:
    return _HDR2.size + 2 * n_sym + 4 + 4 * L + 2 * n_emit


def assemble_symbol_blob(n_elems: int, b_bits: int, freq: np.ndarray,
                         states: np.ndarray, stream: np.ndarray,
                         raw_bytes: Optional[Callable[[], bytes]] = None
                         ) -> bytes:
    """Assemble a v2 symbol-level blob; ``raw_bytes`` supplies the packed
    byte payload lazily for the v0 store fallback (compared against the
    packed size, exactly like the byte coder)."""
    L = int(states.size)
    n_sym = int(np.asarray(freq).size)
    packed_len = n_elems * b_bits // 8
    if raw_bytes is not None and \
            blob_nbytes_sym(stream.size, L, n_sym) >= \
            packed_len + _RAW_HDR.size:
        return _RAW_HDR.pack(packed_len, _V_RAW) + raw_bytes()
    return b"".join([
        _HDR2.pack(n_elems, _V_SYM, SCALE_BITS, b_bits, L, n_sym),
        np.ascontiguousarray(freq, np.uint16).tobytes(),
        struct.pack("<I", int(stream.size)),
        np.ascontiguousarray(states, np.uint32).tobytes(),
        np.ascontiguousarray(stream, np.uint16).tobytes(),
    ])


def symbol_freq(counts_ranks: np.ndarray, k_eff: int,
                total_elems: int) -> np.ndarray:
    """v2 frequency table from the analyze stage's exact global histogram:
    symbol r < k_eff counts ``counts_ranks[r]`` occurrences; the marker
    symbol (id k_eff) absorbs the rest, including block padding."""
    counts = np.zeros(k_eff + 1, np.uint64)
    counts[:k_eff] = np.asarray(counts_ranks[:k_eff], np.uint64)
    used = int(counts[:k_eff].sum())
    counts[k_eff] = max(total_elems - used, 0)
    return freq_from_counts(counts)


def compress_symbols(idx: np.ndarray, b_bits: int,
                     freq: np.ndarray) -> bytes:
    """Host (NumPy) flavor of the symbol-level coder: one block of B-bit
    index values -> self-describing v2 blob (the oracle the device group
    encoder is byte-identical to)."""
    idx = np.asarray(idx, np.int64)
    k_eff = int(np.asarray(freq).size) - 1
    syms = np.minimum(idx, k_eff)
    states, stream = encode_np(syms, freq)

    def raw_bytes() -> bytes:
        nbytes = idx.size * b_bits // 8
        return packing.pack_indices_np(idx, b_bits).tobytes()[:nbytes]

    return assemble_symbol_blob(idx.size, b_bits, freq, states, stream,
                                raw_bytes=raw_bytes)


def compress(raw: bytes) -> bytes:
    """Host (NumPy) flavor: bytes -> self-describing rANS blob."""
    arr = np.frombuffer(raw, np.uint8)
    freq = freq_table(arr)
    states, stream = encode_np(arr, freq)
    return assemble_blob(arr.size, freq, states, stream,
                         raw_bytes=lambda: bytes(raw))


def blob_version(blob: bytes) -> int:
    """Self-described version byte of a block blob (v0/v1/v2)."""
    if len(blob) < _RAW_HDR.size:
        raise ValueError("rANS blob too short")
    return blob[4]


def _parse_v1(blob: bytes):
    """v1 blob -> (n_bytes, L, freq (256,) u16, states, stream)."""
    n, _, sb, L = _HDR.unpack_from(blob)
    if sb != SCALE_BITS:
        raise ValueError(f"unsupported rANS scale_bits {sb}")
    off = _HDR.size
    freq = np.frombuffer(blob, np.uint16, 256, off)
    off += 512
    (n_emit,) = struct.unpack_from("<I", blob, off)
    off += 4
    states = np.frombuffer(blob, np.uint32, L, off)
    off += 4 * L
    stream = np.frombuffer(blob, np.uint16, n_emit, off)
    return n, L, freq, states, stream


def _parse_v2(blob: bytes):
    """v2 blob -> (n_elems, b_bits, L, freq (n_sym,) u16, states, stream)."""
    n, _, sb, b_bits, L, n_sym = _HDR2.unpack_from(blob)
    if sb != SCALE_BITS:
        raise ValueError(f"unsupported rANS scale_bits {sb}")
    off = _HDR2.size
    freq = np.frombuffer(blob, np.uint16, n_sym, off)
    off += 2 * n_sym
    (n_emit,) = struct.unpack_from("<I", blob, off)
    off += 4
    states = np.frombuffer(blob, np.uint32, L, off)
    off += 4 * L
    stream = np.frombuffer(blob, np.uint16, n_emit, off)
    return n, b_bits, L, freq, states, stream


def decompress(blob: bytes) -> bytes:
    """Decode a block blob back to its raw *packed* bytes.

    v0 returns the stored payload, v1 decodes the byte stream, v2 decodes
    the symbol stream and re-packs the B-bit values -- so every consumer
    of packed bytes (``blocks.inflate_block``, partial reads, the host
    decompressors) works unchanged whatever the blob flavor.
    """
    version = blob_version(blob)
    if version == _V_RAW:
        (n, _) = _RAW_HDR.unpack_from(blob)
        out = blob[_RAW_HDR.size:_RAW_HDR.size + n]
        if len(out) != n:
            raise ValueError("corrupt raw blob: truncated payload")
        return out
    if version == _V_RANS:
        n, L, freq, states, stream = _parse_v1(blob)
        return decode_np(states, stream, freq, n, L).tobytes()
    if version == _V_SYM:
        n, b_bits, L, freq, states, stream = _parse_v2(blob)
        syms = decode_np(states, stream, freq, n, L).astype(np.int64)
        marker = (1 << b_bits) - 1
        k_eff = freq.size - 1
        vals = np.where(syms >= k_eff, marker, syms)
        nbytes = n * b_bits // 8
        return packing.pack_indices_np(vals, b_bits).tobytes()[:nbytes]
    raise ValueError(f"unknown rANS blob version {version}")


def tables_from_samples(samples: np.ndarray):
    """Per-block (freq (nb, 256) u16, fused fc (nb, 256) u32) from the
    sampled bytes of each block."""
    freqs = np.stack([freq_from_counts(np.bincount(row, minlength=256))
                      for row in np.asarray(samples, np.uint8)])
    fcs = np.stack([pack_fc(f) for f in freqs])
    return freqs, fcs


def _decode_tables(freq: np.ndarray):
    """Per-slot decode tables for one frequency table: a fused u32
    ``freq | offset<<12 | symbol<<24`` (alphabets <= 256) or the fused
    freq/offset word plus a separate int32 slot->symbol table (wider
    symbol-level alphabets).  Raises ValueError on corrupt tables, like
    ``decode_np``."""
    f64 = np.asarray(freq, np.int64)
    A = f64.size
    slot2sym = np.repeat(np.arange(A, dtype=np.int64), f64)
    if A < 2 or slot2sym.size != M:
        raise ValueError("corrupt rANS table: frequencies sum != 2^scale")
    f_slot = f64[slot2sym].astype(np.uint32)
    cum = np.concatenate([[0], np.cumsum(f64)[:-1]])
    off = (np.arange(M, dtype=np.int64) - cum[slot2sym]).astype(np.uint32)
    fused = f_slot | (off << np.uint32(12))
    if A <= 256:
        return fused | (slot2sym.astype(np.uint32) << np.uint32(24)), None
    return fused, slot2sym.astype(np.int32)


def _check_decoded(xf: np.ndarray, ptrf: np.ndarray,
                   n_emit: np.ndarray) -> None:
    """Host-side stream-integrity check of a decoded group (mirrors
    ``decode_np`` validation)."""
    if (np.asarray(ptrf, np.int64) != np.asarray(n_emit, np.int64)).any() \
            or (np.asarray(xf) != np.uint32(STATE_LO)).any():
        raise ValueError("corrupt rANS blob: stream not consumed cleanly")


def _batch_group(parsed: List[dict]):
    """Stack a homogeneous parsed-blob group for one kernel launch: fused
    decode tables (cached per distinct frequency table), states,
    zero-padded stream matrix and per-block emission counts.  Rows are
    padded with zeros to a multiple of 8 words, so that every row starts
    on a 16-byte boundary, where the decode kernel's bulk copies can
    begin; the padding lies past each row's ``n_emit``, where every
    decoder reads 0."""
    g = len(parsed)
    smax = -(-max(1, max(p["stream"].size for p in parsed)) // 8) * 8
    states = np.stack([p["states"] for p in parsed]).astype(np.uint32)
    stream = np.zeros((g, smax), np.uint16)
    dec = np.empty((g, M), np.uint32)
    sym = None
    cache: dict = {}
    for i, p in enumerate(parsed):
        stream[i, :p["stream"].size] = p["stream"]
        key = p["freq"].tobytes()
        if key not in cache:
            cache[key] = _decode_tables(p["freq"])
        d, s = cache[key]
        dec[i] = d
        if s is not None:
            if sym is None:
                sym = np.empty((g, M), np.int32)
            sym[i] = s
    n_emit = np.array([p["stream"].size for p in parsed], np.int64)
    return dec, sym, states, stream, n_emit


# ------------------------------------------------------------ the kernels

ENCODE = Kernel("rans_encode", replaces="src/repro/kernels/rans.py:424",
                lib="rans")
DECODE = Kernel("rans_decode", replaces="src/repro/kernels/rans.py:688",
                lib="rans")
UNPACK = Kernel("rans_unpack", replaces="src/repro/kernels/rans.py:650",
                lib="rans")

_U32 = 0xFFFFFFFF
_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bits -> int64 values in [0, 2^32)."""
    return t.to(torch.int64) & _U32


def _bits32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 holding the same 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _bits16(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 1 << 15, x - (1 << 16), x).to(torch.int16)


def encode_plain(syms: torch.Tensor, fc: torch.Tensor, *, L: int):
    """Encode every row of ``syms`` (nb, n) -- u8 bytes, or int32 ids
    clamped to the alphabet ``fc.shape[1]`` -- with its fused table row
    of ``fc`` (nb or 1, A) int32 (``freq | cum << 13`` bits).

    Returns (states (nb, L) int32, vals (nb, m*L) int16, masks (nb, m*L)
    bool): u32 and u16 bits, each block's emissions in the decoder's
    order (j ascending, lane ascending), as ``encode_bytes_body``."""
    nb, n = syms.shape
    A = fc.shape[1]
    m = -(-n // L) if n else 0
    dev = syms.device
    sy = torch.zeros((nb, m * L), dtype=torch.int64, device=dev)
    sy[:, :n] = syms.to(torch.int64).clamp(0, A - 1)
    v = torch.gather(_u32(fc).expand(nb, A), 1, sy).view(nb, m, L)
    f_all, c_all = v & 0x1FFF, v >> 13
    lim = f_all << (32 - SCALE_BITS)    # (x >> 20) >= f  <=>  x >= f << 20
    g_all = M - f_all                   # (q << 12) + x - q*f = x + q*(M-f)
    x = torch.full((nb, L), STATE_LO, dtype=torch.int64, device=dev)
    pre = torch.empty((nb, m, L), dtype=torch.int64, device=dev)
    for j in range(m - 1, -1, -1):
        pre[:, j] = x                   # step j's state before renorm
        x = torch.where(x >= lim[:, j], x >> 16, x)
        q = x // f_all[:, j]
        x = (x + q * g_all[:, j] + c_all[:, j]) & _U32
    masks = (pre >= lim).view(nb, m * L)
    return _bits32(x), _bits16(pre.view(nb, m * L) & 0xFFFF), masks


def encode_cuda(syms: torch.Tensor, fc: torch.Tensor, *, L: int):
    """``encode_plain`` as one launch of ``rans_encode``: each block's
    lanes over ``L / encode_lanes_per_cta(nb, L)`` CTAs, one thread per
    lane, the fused table and the reciprocals in shared memory."""
    check_cuda("syms", syms, (torch.uint8, torch.int32))
    check_cuda("fc", fc, (torch.int32,))
    nb, n = syms.shape
    A = fc.shape[1]
    if fc.shape[0] not in (1, nb) or not 2 <= A <= M:
        raise ValueError(f"fc must be (1 or {nb}, A <= {M}), got "
                         f"{tuple(fc.shape)}")
    if L not in (32, 128, 512, 1024):
        raise ValueError(f"L={L} is not a lane count of the format")
    m = -(-n // L) if n else 0
    dev = syms.device
    states = torch.empty((nb, L), dtype=torch.int32, device=dev)
    vals = torch.empty((nb, m * L), dtype=torch.int16, device=dev)
    masks = torch.empty((nb, m * L), dtype=torch.bool, device=dev)
    if nb:
        sym = ("rans_encode_u8" if syms.dtype == torch.uint8
               else "rans_encode_i32")
        ENCODE.launch(sym, (_P, _LL, _I, _P, _I, _I, _I, _I, _P, _P, _P),
                      syms.data_ptr(), n, nb, fc.data_ptr(), A,
                      A if fc.shape[0] == nb else 0, L,
                      encode_lanes_per_cta(nb, L), states.data_ptr(),
                      vals.data_ptr(), masks.data_ptr())
    return states, vals, masks


# The encode kernel's division on its own (tests only; not on any path).
_DIVIDE = Kernel("rans_divide", replaces="src/repro/kernels/rans.py:424",
                 lib="rans")


def divide_cuda(x: torch.Tensor, f: torch.Tensor):
    """floor(x / f) and x mod f as ``rans_encode`` computes them, for int32
    tensors holding u32 bits, f >= 1: (q, r) int32."""
    check_cuda("x", x, (torch.int32,))
    check_cuda("f", f, (torch.int32,), x.numel())
    q, r = torch.empty_like(x), torch.empty_like(x)
    if x.numel():
        _DIVIDE.launch("rans_divide", (_P, _P, _LL, _P, _P), x.data_ptr(),
                       f.data_ptr(), x.numel(), q.data_ptr(), r.data_ptr())
    return q, r


def _decode_loop(dec, sym_tab, states, stream, n_emit, m, L):
    """The plain lane loop of ``decode_scan_body`` over tables from
    ``_decode_tables`` (their frequencies sum to M, so states stay below
    2^32).  Returns the symbols (nb, m*L) int64, final states (nb, L)
    int32 and pointers (nb,) int64.  Stream reads at or past a block's
    ``n_emit`` give 0 (they only happen in blobs that then fail
    ``_check_decoded``)."""
    nb = dec.shape[0]
    S = stream.shape[1]
    d = _u32(dec)
    f_tab, off_tab = d & 0xFFF, (d >> 12) & 0xFFF
    st = stream.to(torch.int64) & 0xFFFF
    x = _u32(states)
    ne = n_emit.to(torch.int64).view(nb, 1)
    last = torch.full((nb, 1), -1, dtype=torch.int64, device=dec.device)
    slots = torch.empty((nb, m, L), dtype=torch.int64, device=dec.device)
    for j in range(m):
        slot = x & (M - 1)
        slots[:, j] = slot
        x = (torch.gather(f_tab, 1, slot) * (x >> SCALE_BITS)
             + torch.gather(off_tab, 1, slot))
        need = x < STATE_LO
        pos = last + need.cumsum(1)     # stream position of each read
        nxt = torch.gather(st, 1, pos.clamp(0, S - 1))
        nxt = torch.where(pos < ne, nxt, 0)
        x = torch.where(need, (x << 16) | nxt, x)
        last = pos[:, -1:]
    slots = slots.view(nb, m * L)
    syms = (d >> 24) if sym_tab is None else sym_tab.to(torch.int64)
    return torch.gather(syms, 1, slots), _bits32(x), last.view(nb) + 1


def decode_bytes_plain(dec, states, stream, n_emit, *, m: int, L: int):
    """Decode a group of byte-alphabet blocks: dec (nb, 4096) int32 fused
    tables, states (nb, L) int32, stream (nb, S) int16 zero-padded,
    n_emit (nb,) int64 -> (bytes (nb, m*L) uint8, final states (nb, L)
    int32, final pointers (nb,) int64)."""
    syms, xf, ptrf = _decode_loop(dec, None, states, stream, n_emit, m, L)
    return syms.to(torch.uint8), xf, ptrf


def decode_syms_plain(dec, sym_tab, states, stream, n_emit, *, m: int,
                      L: int, n: int, n_sym: int, b_bits: int):
    """Decode a group of v2 symbol blocks straight to B-bit indices:
    symbol ids >= n_sym - 1 become the marker 2^B - 1; ``sym_tab``
    (nb, 4096) int32 is the slot->symbol table of alphabets wider than
    256 (None otherwise).  Returns (idx (nb, n) int32, final states,
    final pointers)."""
    syms, xf, ptrf = _decode_loop(dec, sym_tab, states, stream, n_emit, m,
                                  L)
    syms = syms[:, :n]
    idx = torch.where(syms >= n_sym - 1, (1 << b_bits) - 1, syms)
    return idx.to(torch.int32), xf, ptrf


def _check_decode_args(dec, sym_tab, states, stream, n_emit, L):
    check_cuda("dec", dec, (torch.int32,))
    nb = dec.shape[0]
    if dec.shape != (nb, M):
        raise ValueError(f"dec must be (nb, {M}), got {tuple(dec.shape)}")
    if sym_tab is not None:
        check_cuda("sym_tab", sym_tab, (torch.int32,), nb * M)
    check_cuda("states", states, (torch.int32,), nb * L)
    check_cuda("stream", stream, (torch.int16,))
    check_cuda("n_emit", n_emit, (torch.int64,), nb)
    if stream.dim() != 2 or stream.shape[0] != nb or stream.shape[1] < 1:
        raise ValueError("stream must be (nb, S >= 1)")
    if L not in (32, 128, 512, 1024):
        raise ValueError(f"L={L} is not a lane count of the format")
    if any(t is not None and t.data_ptr() % 16 for t in (dec, sym_tab)):
        raise ValueError("dec and sym_tab must start on a 16-byte boundary")
    return nb


_DEC_ARGS = (_P, _P, _P, _P, _LL, _P, _I, _I, _I, _P, _LL, _I, _I, _I, _P,
             _P)


def _decode_launch(mode, dec, sym_tab, states, stream, n_emit, m, L, out,
                   n, n_sym, marker):
    nb = dec.shape[0]
    xf = torch.empty((nb, L), dtype=torch.int32, device=dec.device)
    ptrf = torch.empty(nb, dtype=torch.int64, device=dec.device)
    if nb:
        DECODE.launch("rans_decode", _DEC_ARGS, dec.data_ptr(),
                      None if sym_tab is None else sym_tab.data_ptr(),
                      states.data_ptr(), stream.data_ptr(),
                      stream.shape[1], n_emit.data_ptr(), nb, m, L,
                      out.data_ptr(), n, n_sym, marker, mode, xf.data_ptr(),
                      ptrf.data_ptr())
    return xf, ptrf


def decode_bytes_cuda(dec, states, stream, n_emit, *, m: int, L: int):
    """``decode_bytes_plain`` as one launch of ``rans_decode``."""
    nb = _check_decode_args(dec, None, states, stream, n_emit, L)
    out = torch.empty((nb, m * L), dtype=torch.uint8, device=dec.device)
    xf, ptrf = _decode_launch(0, dec, None, states, stream, n_emit, m, L,
                              out, m * L, 0, 0)
    return out, xf, ptrf


def decode_syms_cuda(dec, sym_tab, states, stream, n_emit, *, m: int,
                     L: int, n: int, n_sym: int, b_bits: int):
    """``decode_syms_plain`` as one launch of ``rans_decode``."""
    nb = _check_decode_args(dec, sym_tab, states, stream, n_emit, L)
    if not (0 < n <= m * L and 2 <= n_sym <= M and 1 <= b_bits <= 24):
        raise ValueError(f"bad v2 shape n={n} n_sym={n_sym} B={b_bits}")
    if (n_sym > 256) != (sym_tab is not None):
        raise ValueError("sym_tab comes with alphabets wider than 256 only")
    out = torch.empty((nb, n), dtype=torch.int32, device=dec.device)
    xf, ptrf = _decode_launch(1, dec, sym_tab, states, stream, n_emit, m, L,
                              out, n, n_sym, (1 << b_bits) - 1)
    return out, xf, ptrf


def unpack_plain(byts: torch.Tensor, *, b_bits: int, be: int):
    """Rows of packed bytes (nb, row) uint8, row >= be*B/8, -> (nb, be)
    int32 B-bit indices (the inverse of the bit-pack kernel)."""
    nb = byts.shape[0]
    nbytes = be * b_bits // 8
    b4 = byts[:, :nbytes].to(torch.int64).reshape(nb, -1, 4)
    words = (b4[..., 0] | (b4[..., 1] << 8) | (b4[..., 2] << 16)
             | (b4[..., 3] << 24))
    g = words.reshape(nb, -1, b_bits)
    cols = []
    for j in range(packing.GROUP):
        w, s = divmod(j * b_bits, 32)
        v = g[:, :, w] >> s
        if s + b_bits > 32:
            v = v | (g[:, :, w + 1] << (32 - s))
        cols.append(v & ((1 << b_bits) - 1))
    return torch.stack(cols, dim=-1).reshape(nb, be).to(torch.int32)


def unpack_cuda(byts: torch.Tensor, *, b_bits: int, be: int):
    """``unpack_plain`` as one launch of ``rans_unpack``."""
    check_cuda("byts", byts, (torch.uint8,))
    nb, row = byts.shape
    if be % packing.GROUP or row % 4 or row < be * b_bits // 8 \
            or not 1 <= b_bits <= 24 or byts.data_ptr() % 4:
        raise ValueError(f"cannot unpack B={b_bits} x {be} from rows of "
                         f"{row} bytes")
    out = torch.empty((nb, be), dtype=torch.int32, device=byts.device)
    if nb and be:
        UNPACK.launch("rans_unpack", (_P, _I, _LL, _I, _LL, _P),
                      byts.data_ptr(), nb, row, b_bits, be, out.data_ptr())
    return out


# ------------------------------------------------- the device entropy stage

def _run_encode(syms2d, fc):
    """One encode launch (kernel or plain version, by the tensor's device)
    and the on-device compaction of each block's emissions; one copy to
    the host of states, streams and emission counts."""
    from repro_torch.kernels import ops as kops
    L = lanes_for(syms2d.shape[1])
    states, vals, masks = kops.rans_encode(syms2d, fc, L=L)
    n_emit = masks.sum(dim=1)
    with telemetry.span("sync.stream_select"):
        stream = vals[masks]              # block order: rows contiguous
    with telemetry.span("sync.stream_states"):
        states = states.cpu()
    with telemetry.span("sync.stream_words"):
        stream = stream.cpu()
    with telemetry.span("sync.stream_counts"):
        n_emit = n_emit.cpu()
    states = states.numpy().view(np.uint32)
    stream = stream.numpy().view(np.uint16)
    n_emit = n_emit.numpy()
    bounds = np.concatenate([[0], np.cumsum(n_emit)])
    return states, [stream[bounds[k]:bounds[k + 1]]
                    for k in range(len(n_emit))]


def compress_blocks_device(idx_dev: torch.Tensor, b_bits: int, nblocks: int,
                           block_elems: int) -> List[bytes]:
    """Device entropy stage, v1 blobs: marker-padded indices
    (nblocks * block_elems,) int32 on the device -> one self-describing
    blob per block, byte-identical to ``compress`` of the packed bytes.

    The bit-pack kernel packs the table; the frequency tables come from
    a strided sample of its bytes (``sample_stride``, a host bincount);
    one ``rans_encode`` launch codes every block."""
    from repro_torch.kernels import ops as kops
    nbytes = block_elems * b_bits // 8
    words = kops.pack_bits(idx_dev, b_bits=b_bits)
    byts = words.view(torch.uint8).view(nblocks, nbytes)
    # Frequency tables are built host-side from the strided samples.
    with telemetry.span("sync.samples"):
        # repro-lint: disable=host-sync-in-device-path
        samples = byts[:, ::sample_stride(nbytes)].cpu().numpy()
    with telemetry.span("entropy.tables"):
        freqs, fcs = tables_from_samples(samples)
    with telemetry.span("sync.freq_up"):
        fc = torch.from_numpy(fcs.view(np.int32)).to(idx_dev.device)
    states, streams = _run_encode(byts, fc)

    def raw_bytes(k):
        # only for a block that codes larger than raw
        with telemetry.span("sync.raw_block"):
            return byts[k].cpu().numpy().tobytes()

    with telemetry.span("entropy.assemble"):
        return [assemble_blob(nbytes, freqs[k], states[k], streams[k],
                              raw_bytes=lambda k=k: raw_bytes(k))
                for k in range(nblocks)]


def compress_blocks_device_symbols(idx_dev: torch.Tensor, b_bits: int,
                                   k_eff: int, nblocks: int,
                                   block_elems: int,
                                   counts_ranks: np.ndarray) -> List[bytes]:
    """Device entropy stage, v2 blobs: code the B-bit indices directly
    over the dense {rank 0..k_eff-1, marker} alphabet with one table from
    the analyze stage's exact histogram -- no pack, no sample.
    Byte-identical to ``compress_symbols``."""
    be = block_elems
    nbytes = be * b_bits // 8
    with telemetry.span("entropy.tables"):
        # counts_ranks is already a host array (analyze-boundary metadata).
        # repro-lint: disable=host-sync-in-device-path
        freq = symbol_freq(np.asarray(counts_ranks), k_eff, nblocks * be)
        fc = pack_fc(freq).view(np.int32)[None, :]
    with telemetry.span("sync.freq_up"):
        fc = torch.from_numpy(fc).to(idx_dev.device)
    idx2d = idx_dev.view(nblocks, be)
    states, streams = _run_encode(idx2d, fc)

    def raw_bytes(k):
        with telemetry.span("sync.raw_block"):
            idx_h = idx2d[k].cpu().numpy().astype(np.int64)
        return packing.pack_indices_np(idx_h, b_bits).tobytes()[:nbytes]

    with telemetry.span("entropy.assemble"):
        return [assemble_symbol_blob(be, b_bits, freq, states[k], streams[k],
                                     raw_bytes=lambda k=k: raw_bytes(k))
                for k in range(nblocks)]


def _upload_group(parsed, device):
    dec, sym, states, stream, n_emit = _batch_group(parsed)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return (t(dec.view(np.int32)), None if sym is None else t(sym),
            t(states.view(np.int32)), t(stream.view(np.int16)), t(n_emit),
            n_emit)


def _checked(xf, ptrf, n_emit) -> None:
    _check_decoded(xf.cpu().numpy().view(np.uint32), ptrf.cpu().numpy(),
                   n_emit)


def decode_blocks_device(blobs: Sequence[bytes], b_bits: int,
                         block_elems: int, device) -> torch.Tensor:
    """Device entropy decode of a step's index blocks: self-describing
    blobs (v0/v1/v2, freely mixed) -> (nblocks, block_elems) int32 index
    values on ``device``.  Blobs are parsed and grouped by
    (version, L, n_sym) on the host; each group is one kernel launch
    (``rans_decode``, then ``rans_unpack`` for v1; v0 payloads upload and
    unpack).  Raises ValueError on corrupt blobs, as ``decompress``."""
    from repro_torch.kernels import ops as kops
    be = block_elems
    nbytes = be * b_bits // 8
    groups: dict = {}
    for i, blob in enumerate(blobs):
        v = blob_version(blob)
        if v == _V_RAW:
            n, _ = _RAW_HDR.unpack_from(blob)
            payload = blob[_RAW_HDR.size:_RAW_HDR.size + n]
            if n != nbytes or len(payload) != n:
                raise ValueError("corrupt raw blob: payload size mismatch")
            key, rec = ("raw",), {"payload": payload}
        elif v == _V_RANS:
            n, L, freq, states, stream = _parse_v1(blob)
            if n != nbytes:
                raise ValueError("rANS blob does not match block shape")
            key = ("v1", L)
            rec = {"freq": freq, "states": states, "stream": stream}
        elif v == _V_SYM:
            n, bb, L, freq, states, stream = _parse_v2(blob)
            if n != be or bb != b_bits:
                raise ValueError("rANS blob does not match block shape")
            key = ("v2", L, freq.size)
            rec = {"freq": freq, "states": states, "stream": stream}
        else:
            raise ValueError(f"unknown rANS blob version {v}")
        groups.setdefault(key, ([], []))
        groups[key][0].append(i)
        groups[key][1].append(rec)

    order, parts = [], []
    for key, (idxs, parsed) in groups.items():
        if key[0] == "raw":
            byts = torch.from_numpy(np.stack(
                [np.frombuffer(p["payload"], np.uint8) for p in parsed]
            )).to(device)
            idx = kops.rans_unpack(byts, b_bits=b_bits, be=be)
        elif key[0] == "v1":
            dec, _, states, stream, n_emit_t, n_emit = _upload_group(
                parsed, device)
            L = key[1]
            byts, xf, ptrf = kops.rans_decode_bytes(
                dec, states, stream, n_emit_t, m=-(-nbytes // L), L=L)
            _checked(xf, ptrf, n_emit)
            idx = kops.rans_unpack(byts, b_bits=b_bits, be=be)
        else:
            _, L, n_sym = key
            dec, sym, states, stream, n_emit_t, n_emit = _upload_group(
                parsed, device)
            idx, xf, ptrf = kops.rans_decode_syms(
                dec, sym, states, stream, n_emit_t, m=-(-be // L), L=L,
                n=be, n_sym=n_sym, b_bits=b_bits)
            _checked(xf, ptrf, n_emit)
        order += idxs
        parts.append(idx)
    cat = torch.cat(parts) if len(parts) > 1 else parts[0]
    # host-side block-order bookkeeping: `order` is a list of host ints
    # repro-lint: disable=host-sync-in-device-path
    perm = np.argsort(np.asarray(order, np.int64), kind="stable")
    if not np.array_equal(perm, np.arange(len(blobs))):
        cat = cat[torch.from_numpy(perm).to(device)]
    return cat


def decode_bytes_blocks_device(blobs: Sequence[bytes],
                               device) -> torch.Tensor:
    """Device entropy decode of anchor byte blocks (possibly ragged) ->
    one flat (total_bytes,) uint8 tensor on ``device`` in block order.
    v0 payloads upload as they are; v1 groups, keyed by exact byte length
    and lane count, are one ``rans_decode`` launch each."""
    from repro_torch.kernels import ops as kops
    pieces: List = [None] * len(blobs)
    groups: dict = {}
    for i, blob in enumerate(blobs):
        v = blob_version(blob)
        if v == _V_RAW:
            n, _ = _RAW_HDR.unpack_from(blob)
            payload = blob[_RAW_HDR.size:_RAW_HDR.size + n]
            if len(payload) != n:
                raise ValueError("corrupt raw blob: payload size mismatch")
            pieces[i] = torch.from_numpy(
                np.frombuffer(payload, np.uint8).copy()).to(device)
        elif v == _V_RANS:
            n, L, freq, states, stream = _parse_v1(blob)
            groups.setdefault((n, L), ([], []))
            groups[(n, L)][0].append(i)
            groups[(n, L)][1].append(
                {"freq": freq, "states": states, "stream": stream})
        else:
            raise ValueError(f"unknown rANS blob version {v}")
    for (n, L), (idxs, parsed) in groups.items():
        dec, _, states, stream, n_emit_t, n_emit = _upload_group(parsed,
                                                                 device)
        byts, xf, ptrf = kops.rans_decode_bytes(dec, states, stream,
                                                n_emit_t, m=-(-n // L), L=L)
        _checked(xf, ptrf, n_emit)
        for k, i in enumerate(idxs):
            pieces[i] = byts[k, :n]
    if not pieces:
        return torch.zeros(0, dtype=torch.uint8, device=device)
    return torch.cat(pieces)


__all__ = ["SCALE_BITS", "M", "STATE_LO", "DEVICE_MIN_BYTES", "lanes_for",
           "encode_lanes_per_cta", "sample_stride", "freq_from_counts", "freq_table", "pack_fc",
           "encode_np", "decode_np", "blob_nbytes", "assemble_blob",
           "blob_nbytes_sym", "assemble_symbol_blob", "symbol_freq",
           "compress_symbols", "blob_version", "compress", "decompress",
           "tables_from_samples", "ENCODE", "DECODE", "UNPACK",
           "encode_plain", "encode_cuda", "divide_cuda", "decode_bytes_plain",
           "decode_bytes_cuda", "decode_syms_plain", "decode_syms_cuda",
           "unpack_plain", "unpack_cuda", "compress_blocks_device",
           "compress_blocks_device_symbols", "decode_blocks_device",
           "decode_bytes_blocks_device"]
