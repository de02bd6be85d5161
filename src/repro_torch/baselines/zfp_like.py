"""ZFP-like baseline (Lindstrom, 2014) -- fixed-accuracy transform coder.

Per 4-element 1-D block: align to the block's common exponent, convert to
fixed point, apply ZFP's orthogonal lifting transform, and keep only the
bit planes above the absolute-error threshold; per-block bit widths are
stored so blocks pack densely.

Simplifications vs real ZFP (documented in DESIGN.md): 1-D 4-blocks on the
flattened array (real ZFP uses 4^d blocks and negabinary group testing);
entropy coding is per-block minimal-width packing.  Absolute error bound
only -- exactly the limitation the paper discusses (Sec. II): the bench
sets tol = mean(|data|) * rel_bound the same way the paper does.

The port of the reference's ``baselines/zfp_like.py``: the same blob and
payload bytes, the arithmetic in torch on the device (CUDA unless the
caller asks for another), zlib on the host.  The transform runs on int64
with arithmetic shifts and the zigzag words stay in int64 (their bits
are the reference's uint64).  The variable-width bit pack places each
word's low `width` bits at its stream offset in 64-bit words
(``index_add_`` of disjoint bits is their OR), whose little-endian bytes
are ``np.packbits(bitorder="little")``'s.  The reference's
``ceil(log2(.))`` and ``floor(log2(.))`` round log2 to a double first,
and near a power of two that rounding decides the integer: ``_ceil_log2``
and ``_floor_log2`` compute numpy's integers exactly from the exponent
(``frexp``) and the distance to the next double, never from a device
``log2`` that may differ by an ulp.  Powers of two are built from their
bits (``_exp2``), and a float cast to an integer takes x86's value for
NaN and overflow (``_int_x86``), as numpy's ``astype`` does.
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.chain import resolve_device

_Q = 26                       # fixed-point fraction bits
_INV_LN2 = 1.0 / math.log(2.0)


@dataclass
class ZfpBlob:
    n: int
    payload: bytes
    meta: dict

    @property
    def nbytes(self) -> int:
        return len(self.payload) + 16


def _transform(q):
    """Forward transform per block (q int64 (nb, 4))."""
    x, y, z, w = q.unbind(1)
    # zfp's non-orthogonal lifted transform (decorrelates smooth data)
    x = (x + w) >> 1
    w = w - x
    z = (z + y) >> 1
    y = y - z
    x = (x + z) >> 1
    z = z - x
    w = (w + y) >> 1
    y = y - w
    w = w + (y >> 1)
    y = y - (w >> 1)
    return torch.stack([x, z, w, y], dim=-1)


def _inv_transform(t):
    x, z, w, y = t.unbind(1)
    y = y + (w >> 1)
    w = w - (y >> 1)
    y = y + w
    w = (w << 1) - y
    z = z + x
    x = (x << 1) - z
    y = y + z
    z = (z << 1) - y
    w = w + x
    x = (x << 1) - w
    return torch.stack([x, y, z, w], dim=-1)


def _exp2(k):
    """2.0**k (float64) of int64 `k`, built from its bits: exact, as
    ``np.exp2`` of an integer is (0 below the subnormals, inf above)."""
    k = torch.clamp(k, -1100, 1100)
    normal = ((k + 1023).clamp(1, 2046) << 52).view(torch.float64)
    sub = (torch.ones_like(k) << (k + 1074).clamp(0, 51)).view(torch.float64)
    out = torch.where(k >= -1022, normal, sub)
    out = torch.where(k < -1074, 0.0, out)
    return torch.where(k > 1023, torch.inf, out)


def _half_gap(a, toward_zero: bool):
    """Half the distance from the integer-valued doubles `a` > 0 to the
    next double away from zero, or toward zero (half that again at a
    power of two)."""
    m, e = torch.frexp(a)              # a = m * 2**e, m in [0.5, 1)
    k = e.to(torch.int64) - 54
    if toward_zero:
        k = k - (m == 0.5).to(torch.int64)
    return _exp2(k)


def _int_x86(v, dtype):
    """``astype(dtype)`` of float64 `v` as numpy does it on x86-64: NaN,
    infinities and values out of range become the type's minimum."""
    info = torch.iinfo(dtype)
    ok = torch.isfinite(v) & (v > -2.0 ** (info.bits - 1) - 1) & (
        v < 2.0 ** (info.bits - 1))
    return torch.where(ok, v, 0.0).to(dtype).masked_fill(~ok, info.min)


def _ceil_log2(x, dtype=torch.int32):
    """``np.ceil(np.log2(x)).astype(dtype)`` for float64 `x` > 0, with
    log2 rounded to the nearest double first, as numpy's is: at x =
    2**j * (1 + d) (d tiny) it is j when log2(1 + d) is under half the
    gap from j to the next double up."""
    m, e = torch.frexp(x)
    j = e.to(torch.int64) - 1
    r = m * 2.0                        # x = r * 2**j, r in [1, 2)
    g = torch.log1p(r - 1.0) * _INV_LN2
    ja = j.abs().to(torch.float64).clamp_min(1.0)
    h = torch.where(j > 0, _half_gap(ja, toward_zero=False),
                    _half_gap(ja, toward_zero=True))
    h = torch.where(j == 0, 0.0, h)
    out = torch.where((r == 1.0) | (g < h), j, j + 1).to(torch.float64)
    return _int_x86(torch.where(torch.isfinite(x), out, x), dtype)


def _floor_log2(x, dtype=torch.int64):
    """``np.floor(np.log2(x)).astype(dtype)`` for float64 `x` >= 1: j at
    x = 2**j * r, or j + 1 where log2 rounds up to it (r next to 2)."""
    m, e = torch.frexp(x)
    j = e.to(torch.int64) - 1
    below = -torch.log1p(m - 1.0) * _INV_LN2      # j + 1 - log2(x)
    h = _half_gap((j + 1).to(torch.float64), toward_zero=True)
    out = torch.where(below < h, j + 1, j).to(torch.float64)
    return _int_x86(torch.where(torch.isfinite(x), out, x), dtype)


def _pack_widths(vals, widths):
    """Each int64 word's low `widths` bits, concatenated LSB first in
    order -> the stream's bytes (``np.packbits(bitorder="little")`` of
    the reference's bit array)."""
    total = int(widths.sum())
    starts = torch.cumsum(widths, 0) - widths
    keep = torch.where(widths >= 64, -1,
                       (torch.ones_like(widths) << widths.clamp(max=63)) - 1)
    vals = vals & keep
    word, off = starts >> 6, starts & 63
    words = torch.zeros(total // 64 + 2, dtype=torch.int64,
                        device=vals.device)
    words.index_add_(0, word, vals << off)
    spill = (off + widths) > 64
    hi = (vals >> (64 - off).clamp(max=63)) & (
        (torch.ones_like(off) << off) - 1)
    words.index_add_(0, word + 1, torch.where(spill, hi, 0))
    return words.view(torch.uint8)[: (total + 7) // 8].cpu().numpy()


def compress(data: np.ndarray, tol_abs: float, device=None) -> ZfpBlob:
    dev = resolve_device(device)
    data = np.asarray(data)
    flat = torch.from_numpy(np.ascontiguousarray(data).reshape(-1)).to(
        dev).to(torch.float64)
    n = flat.numel()
    pad = (-n) % 4
    blocks = torch.nn.functional.pad(flat, (0, pad)).view(-1, 4)
    f64 = dict(dtype=torch.float64, device=dev)

    # common exponent per block
    amax = blocks.abs().amax(dim=1)
    e = torch.where(amax > 0,
                    _ceil_log2(torch.maximum(
                        amax, torch.tensor(1e-300, **f64))),
                    0).to(torch.int32)
    scale = _exp2(_Q - e.to(torch.int64))
    q = _int_x86(torch.round(blocks * scale[:, None]), torch.int64)
    t = _transform(q)

    # drop bit planes below the error threshold: keep `bits` such that the
    # dropped quantum 2^(e-Q) * 2^drop <= tol
    quantum = _exp2(e.to(torch.int64) - _Q)        # value of 1 LSB
    ratio = torch.full_like(quantum, float(tol_abs)) / torch.maximum(
        quantum, torch.tensor(1e-300, **f64))
    drop = _floor_log2(torch.maximum(ratio, torch.tensor(1.0, **f64)))
    drop = torch.clamp(drop, 0, _Q + 8)
    tq = t >> drop[:, None]

    # per-block bit width of the shifted coefficients (+1 sign, +1 ceil)
    mag = tq.abs().amax(dim=1)
    width = torch.where(mag > 0, _floor_log2(
        torch.clamp_min(mag, 1).to(torch.float64)) + 2, 1)

    # serialize: e (int8 via offset), drop (uint8), width (uint8),
    # then coeffs packed at `width` bits each (zigzag, held in int64)
    zig = (tq << 1) ^ (tq >> 63)
    parts = [torch.clamp(e + 128, 0, 255).to(torch.uint8),
             drop.to(torch.uint8), width.to(torch.uint8)]
    parts = [p.cpu().numpy().tobytes() for p in parts]
    parts.append(_pack_widths(zig.reshape(-1),
                              width.repeat_interleave(4)).tobytes())
    payload = zlib.compress(b"".join(parts), 1)
    return ZfpBlob(n=n, payload=payload,
                   meta={"e": e.cpu().numpy(), "drop": drop.cpu().numpy(),
                         "width": width.cpu().numpy(),
                         "tq": tq.cpu().numpy(),
                         "dtype": str(data.dtype),
                         "shape": tuple(np.shape(data))})


def decompress(blob: ZfpBlob, device=None) -> np.ndarray:
    dev = resolve_device(device)
    m = blob.meta
    drop = torch.from_numpy(np.asarray(m["drop"], np.int64)).to(dev)
    t = torch.from_numpy(np.asarray(m["tq"], np.int64)).to(dev) << \
        drop[:, None]
    q = _inv_transform(t)
    e = torch.from_numpy(np.asarray(m["e"])).to(dev).to(torch.int64)
    vals = q.to(torch.float64) * _exp2(e - _Q)[:, None]
    dt = torch.from_numpy(np.empty(0, m["dtype"])).dtype
    out = vals.reshape(-1)[: blob.n].to(dt)
    return out.cpu().numpy().reshape(m["shape"])


__all__ = ["compress", "decompress", "ZfpBlob"]
