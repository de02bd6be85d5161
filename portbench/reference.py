"""Plain reference of NUMARCK's temporal encode and of its stored format.

Written from the algorithm (arXiv:1703.02438, Sec. III-IV) and the
documented blob layout, in plain torch and NumPy; it imports nothing of
the program under test and takes nothing the program made except the
outputs it judges.

Encode of one step against the reconstructed previous state (top-k
binning, the REF_RECONSTRUCTED chain):

  r      = (curr - prev) / prev, valid where prev != 0 and r, curr finite
  domain = [min r, ...) in bins of width 2E when max - min fits max_bins
           bins, else max_bins bins centred on zero
  bin    = floor((r - domain_lo) / 2E), kept when in [0, max_bins)
  B      = argmin over B of 2^B * s + n * B / 8 + n * alpha(B) * s (Eq. 6),
           alpha(B) the share outside the 2^B - 1 fullest bins
  index  = rank of the element's bin among the 2^B - 1 fullest (ties by
           lower bin), or the marker 2^B - 1 (an exception, stored as is)
  R      = prev * (1 + center[index]), or curr at an exception

Every float operation is one correctly rounded IEEE operation, in the
order written, so a device run of this file gives the same bits as a host
run.  Scalars that divide a device tensor are 0-d tensors on that device:
torch divides a CUDA tensor by a Python number through its reciprocal.

``dtype`` picks the arithmetic: float32, as the configurations state, or a
lower precision for the control that a sound comparison has to fail.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional

import numpy as np
import torch

SCALE_BITS = 12
M = 1 << SCALE_BITS
STATE_LO = 1 << 16


def choose_b(counts_desc: np.ndarray, n: int, elem_bytes: int,
             b_max: int) -> int:
    """Eq. (6) in float32, first minimum.  The prefix of the sorted counts
    is exact in float32 while n < 2^24, which the configurations keep."""
    if n >= 1 << 24:
        raise ValueError("the reference's B model is exact below 2^24 "
                         f"elements a step, not at {n}")
    m = counts_desc.size
    cum = np.cumsum(counts_desc.astype(np.int64)).astype(np.float32)
    bs = np.arange(1, b_max + 1, dtype=np.float32)
    pow2 = np.exp2(bs).astype(np.float32)
    ks = np.minimum(pow2 - np.float32(1), np.float32(m)).astype(np.int64)
    covered = cum[np.clip(ks - 1, 0, m - 1)]
    nf = np.float32(n)
    incompressible = np.maximum(nf - covered, np.float32(0))
    eb = np.float32(elem_bytes)
    sizes = pow2 * eb + nf * bs / np.float32(8) + incompressible * eb
    return int(np.argmin(sizes)) + 1


def encode_step(prev: torch.Tensor, curr: torch.Tensor, *,
                error_bound: float, max_bins: int, b_max: int,
                elem_bytes: int) -> Dict[str, object]:
    """One step of the top-k encode in ``prev``'s dtype and device.

    Returns ``b`` (int), ``centers`` (float32 ndarray of 2^B - 1), ``idx``
    ((n,) int32 on the device), ``marker`` and ``exc`` (the exception
    mask on the device)."""
    dt, dev = prev.dtype, prev.device
    n = prev.numel()

    def s(x):       # a scalar of the arithmetic's dtype, on the device
        return torch.tensor(float(x), dtype=dt, device=dev)

    ok = prev != 0
    safe = torch.where(ok, prev, s(1))
    r = (curr - safe) / safe
    valid = ok & torch.isfinite(r) & torch.isfinite(curr)
    r = torch.where(valid, r, s(0))
    lo, hi = torch.stack([torch.where(valid, r, s(float("inf"))).amin(),
                          torch.where(valid, r, s(float("-inf"))).amax()]
                         ).cpu()
    if bool(lo > hi):                       # no valid ratio
        lo = hi = torch.tensor(0.0, dtype=dt)
    width = torch.tensor(2.0, dtype=dt) * torch.tensor(error_bound, dtype=dt)
    coverage = width * torch.tensor(float(max_bins), dtype=dt)
    domain_lo = lo if bool(hi - lo <= coverage) else \
        torch.tensor(-0.5, dtype=dt) * coverage
    raw = torch.floor((r - domain_lo.to(dev)) / width.to(dev))
    inside = valid & (raw >= 0) & (raw < s(max_bins))
    bins = torch.where(inside, raw, s(max_bins)).to(torch.int64)
    counts = torch.bincount(bins, minlength=max_bins + 1)[:max_bins]
    counts_desc, bins_desc = torch.sort(counts, descending=True, stable=True)
    b = choose_b(counts_desc.cpu().numpy(), n, elem_bytes, b_max)
    marker = (1 << b) - 1
    k = min(marker, max_bins)
    top = bins_desc[:k]
    centers64 = (np.float64(float(domain_lo))
                 + (top.cpu().numpy().astype(np.float64) + 0.5)
                 * np.float64(float(width)))
    centers = torch.from_numpy(centers64).to(dt).float().numpy()
    rank = torch.full((max_bins + 1,), marker, dtype=torch.int64,
                      device=dev)
    rank[top] = torch.arange(k, device=dev)
    idx = rank[bins]
    return dict(b=b, centers=centers, idx=idx.to(torch.int32), marker=marker,
                exc=idx == marker)


def advance(prev: torch.Tensor, curr: torch.Tensor, enc: dict
            ) -> torch.Tensor:
    """The reconstruction R = prev * (1 + center[index]); curr at the
    exceptions."""
    c = torch.from_numpy(enc["centers"]).to(prev.device).to(prev.dtype)
    idx = enc["idx"].to(torch.int64)
    safe = torch.where(enc["exc"], 0, idx)
    step = prev * (1 + torch.where(enc["exc"], 0, c[safe]))
    return torch.where(enc["exc"], curr, step)


def stated(config: dict) -> dict:
    """The encode's parameters as a configuration states them."""
    p = config["params"]
    return dict(error_bound=p["error_bound"], max_bins=p["max_bins"],
                b_max=p["b_max"])


def follow(pool: List[torch.Tensor], order: List[int], *,
           error_bound: float, max_bins: int, b_max: int,
           dtype: torch.dtype = torch.float32):
    """Walk the chain over ``pool[order[0]]`` (the anchor, stored exactly)
    and the deltas ``pool[order[1:]]``; yield ``(t, enc, curr, R)`` for
    each delta step ``t`` (1-based), R being the reconstruction after it.
    ``curr`` and R are in ``dtype``."""
    elem = pool[0].element_size()
    state = pool[order[0]].reshape(-1).to(dtype)
    for t in range(1, len(order)):
        curr = pool[order[t]].reshape(-1).to(dtype)
        enc = encode_step(state, curr, error_bound=error_bound,
                          max_bins=max_bins, b_max=b_max, elem_bytes=elem)
        state = advance(state, curr, enc)
        yield t, enc, curr, state


# ------------------------------------------------ the stored index table

def _decode_v1(blob: bytes) -> bytes:
    """One v1 block: u32 n | u8 1 | u8 scale | u16 L | 256 x u16 freq |
    u32 n_emit | L x u32 states | n_emit x u16 stream.  Lane l holds bytes
    l, l + L, ...; each decode step takes the slot's symbol, advances the
    state and, where it fell under 2^16, shifts in the next stream word,
    lanes in ascending order."""
    n, _, scale, lanes = struct.unpack_from("<IBBH", blob)
    if scale != SCALE_BITS:
        raise ValueError(f"rANS scale {scale}, expected {SCALE_BITS}")
    off = 8
    freq = np.frombuffer(blob, np.uint16, 256, off).astype(np.uint64)
    off += 512
    (n_emit,) = struct.unpack_from("<I", blob, off)
    off += 4
    x = np.frombuffer(blob, np.uint32, lanes, off).astype(np.uint64)
    off += 4 * lanes
    stream = np.frombuffer(blob, np.uint16, n_emit, off).astype(np.uint64)
    if stream.size != n_emit:
        raise ValueError("rANS stream truncated")
    cum = np.concatenate([[0], np.cumsum(freq)[:-1]]).astype(np.uint64)
    sym = np.repeat(np.arange(256, dtype=np.uint8), freq.astype(np.int64))
    if sym.size != M:
        raise ValueError("rANS frequencies do not sum to 2^scale")
    rows = -(-n // lanes)
    out = np.empty((rows, lanes), np.uint8)
    ptr = 0
    for j in range(rows):
        slot = x & np.uint64(M - 1)
        c = sym[slot]
        out[j] = c
        x = freq[c] * (x >> np.uint64(SCALE_BITS)) + slot - cum[c]
        need = np.flatnonzero(x < STATE_LO)
        if need.size:
            x[need] = (x[need] << np.uint64(16)) | stream[ptr:ptr + need.size]
            ptr += need.size
    if ptr != n_emit or (x != STATE_LO).any():
        raise ValueError("rANS stream not consumed cleanly")
    return out.reshape(-1)[:n].tobytes()


def decode_block(blob: bytes) -> bytes:
    """A block blob back to its packed bytes (v0 stored, v1 rANS)."""
    version = blob[4]
    if version == 0:
        (n,) = struct.unpack_from("<I", blob)
        return bytes(blob[5:5 + n])
    if version == 1:
        return _decode_v1(blob)
    raise ValueError(f"index block version {version} is not v0 or v1")


def index_table(blobs: List[bytes], n: int, b: int) -> np.ndarray:
    """The first ``n`` B-bit indices of a step's blocks: bytes in order,
    bits least significant first."""
    raw = np.frombuffer(b"".join(decode_block(x) for x in blobs), np.uint8)
    bits = np.unpackbits(raw, bitorder="little")[: n * b]
    if bits.size != n * b:
        raise ValueError(f"index table holds {bits.size} bits, not {n * b}")
    weights = (1 << np.arange(b, dtype=np.int64))
    return (bits.reshape(n, b).astype(np.int64) @ weights).astype(np.int32)


def index_mismatch(blobs: List[bytes], n: int, b: int,
                   want: torch.Tensor) -> int:
    """Entries of the stored index table that differ from ``want``."""
    got = torch.from_numpy(index_table(blobs, n, b))
    return int((got != want.cpu()).sum())


def bits_differ(a: np.ndarray, b: Optional[np.ndarray]) -> int:
    """Elements whose bits differ (a length mismatch counts the longer)."""
    a = np.ascontiguousarray(a, np.float32).reshape(-1)
    b = np.zeros(0, np.float32) if b is None else \
        np.ascontiguousarray(b, np.float32).reshape(-1)
    if a.size != b.size:
        return max(a.size, b.size)
    return int((a.view(np.uint32) != b.view(np.uint32)).sum())
