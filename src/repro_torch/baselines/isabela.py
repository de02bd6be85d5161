"""ISABELA-like baseline (Lakshminarasimhan et al., Euro-Par 2011).

In-situ Sort-And-B-spline Error-bounded Lossy Abatement, three stages as in
the original:
  1. SORT each window (the pre-conditioner: high-entropy data becomes a
     monotone curve); store the permutation at log2(W) bits/element.
  2. Fit the monotone curve with a small coefficient vector (knots).
  3. ERROR QUANTIZATION: per-element relative correction ratios
     e = v/fit cluster tightly around 1, so they are quantized into
     width-2E bins and entropy-coded (this is what achieves the bound; the
     original stores these as small ints too).
Elements whose correction can't be expressed (sign flip / zero fit /
|bin| > 2^15) are exceptions stored exactly.

Simplification vs the original (DESIGN.md): monotone linear interpolation
between knots instead of cubic B-splines -- stage 3 absorbs the difference.

The port of the reference's ``baselines/isabela.py``: the same blob,
meta and payload bytes, the arithmetic in torch on the device (CUDA
unless the caller asks for another), zlib on the host.  The reference's
loop over windows runs as one batch of (n_windows, window) rows, the
short last window as a batch of its own.  What keeps the bytes:

- the sort orders int64 keys (``_sort_keys``) in which -0.0 equals +0.0
  and every NaN comes last, as ``np.argsort(kind="stable")`` orders the
  floats, with ``torch.sort(stable=True)``;
- the knot positions are ``np.linspace``'s, and the interpolation plan
  (each position's segment, offsets and the exact-hit cases of
  ``np.interp``) is computed on the host; ``_interp`` does numpy's
  ``slope * (x - xp[j]) + fp[j]`` as separate multiply and add ops
  (never a fused one), with its NaN fallbacks;
- divisions are tensor by tensor (a CUDA tensor divided by a Python
  float is multiplied by its reciprocal), rounding is half to even, and
  ``bins * 2 * E`` keeps its order.

The permutations (B = ceil(log2 window) bits, 1 to 24) are packed by the
bit-pack kernel (kernel 3, ``kernels.ops.pack_bits``) over the largest
multiple of 32 elements, and the rest by its plain version; 32 indices
of B bits fill whole bytes, so the two parts' bytes are
``packing.pack_indices_np`` of the whole.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core.chain import resolve_device
from repro_torch.kernels import bitpack, ops

_F64 = torch.float64


@dataclass
class IsabelaBlob:
    window: int
    n: int
    n_knots: int
    payload: bytes          # zlib'd: knots + perms + corrections + excs
    meta: dict

    @property
    def nbytes(self) -> int:
        return len(self.payload) + 32


def _perm_bits(window: int) -> int:
    return max(1, int(np.ceil(np.log2(window))))


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _sort_keys(w):
    """int64 keys of float64 `w` in np.sort's order: -0.0 == +0.0, NaN
    after +inf."""
    bits = torch.where(w == 0, 0.0, w).view(torch.int64)
    keys = torch.where(bits < 0, bits ^ 0x7FFFFFFFFFFFFFFF, bits)
    return keys.masked_fill(torch.isnan(w), torch.iinfo(torch.int64).max)


def _interp_plan(x: np.ndarray, xp: np.ndarray, dev):
    """What ``np.interp(x, xp, fp)`` does at each x, for any fp: the
    segment j (xp[j] <= x < xp[j + 1]), whether x takes fp[j] as it is
    (an exact hit, the last point, or outside xp), and the offsets and
    widths of the slope formula, on `dev`."""
    n = xp.size
    j = np.searchsorted(xp, x, side="right") - 1
    jc = np.clip(j, 0, n - 1)
    j1 = np.minimum(jc + 1, n - 1)
    exact = (j < 0) | (j >= n - 1) | (xp[jc] == x)
    den = np.where(exact, 1.0, xp[j1] - xp[jc])
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (jc, j1, exact, x - xp[jc], x - xp[j1], den))


def _interp(fp, plan):
    """np.interp over each row of float64 `fp` (rows, len(xp))."""
    j, j1, exact, d_lo, d_hi, den = plan
    y0, y1 = fp[:, j], fp[:, j1]
    slope = (y1 - y0) / den
    res = slope * d_lo + y0
    # If we get nan in one direction, try the other
    alt = slope * d_hi + y1
    alt = torch.where(torch.isnan(alt) & (y0 == y1), y0, alt)
    res = torch.where(torch.isnan(res), alt, res)
    return torch.where(exact, y0, res)


def _fit(knots, size: int, n_knots: int, dev):
    """The knots' piecewise-linear curve over a window of `size`."""
    pos = np.arange(size, dtype=np.float64)
    knot_pos = np.linspace(0, size - 1, min(n_knots, size))
    return _interp(knots.to(_F64), _interp_plan(pos, knot_pos, dev))


def _windows(flat, window: int):
    """(first element, (rows, size) view) of the full windows and of the
    short last one."""
    n = flat.numel()
    full = n // window * window
    out = []
    if full:
        out.append((0, flat[:full].view(-1, window)))
    if n > full:
        out.append((full, flat[full:].view(1, -1)))
    return out


def _compress_rows(rows, start: int, E: float, n_knots: int, dt):
    """Stages 1-3 on (r, size) float64 windows -> (knots (r, m) f32,
    order (r, size) int32, bins (r, size) int16, exception indices and
    values, exceptions per row), on the device."""
    dev = rows.device
    r, size = rows.shape
    order = torch.sort(_sort_keys(rows), dim=1, stable=True).indices
    sw = torch.gather(rows, 1, order)
    m = min(n_knots, size)
    knot_pos = np.linspace(0, size - 1, m)
    knots = _interp(sw, _interp_plan(knot_pos, np.arange(
        size, dtype=np.float64), dev)).to(torch.float32)
    fit = _fit(knots, size, n_knots, dev)
    # stage 3: quantized correction ratios, bins of width 2E around 1
    ok = ((fit != 0) & torch.isfinite(sw) & ~torch.isnan(fit)
          & (torch.sign(fit) == torch.sign(sw)))
    ratio = torch.where(ok, sw / torch.where(fit == 0, 1.0, fit), 1.0)
    bins = torch.round((ratio - 1.0) / torch.tensor(2 * E, dtype=_F64,
                                                    device=dev))
    ok &= bins.abs() < 32767
    # verify the bound on the decoded value (f32 storage included)
    dec = (fit * (1.0 + bins * 2 * E)).to(dt).to(_F64)
    denom = torch.maximum(sw.abs(), torch.tensor(1e-30, dtype=_F64,
                                                 device=dev))
    ok &= (dec - sw).abs() / denom <= E
    bins = torch.where(ok, bins, 0.0).to(torch.int16)
    bad_r, bad_c = torch.nonzero(~ok, as_tuple=True)
    exc_idx = order[bad_r, bad_c] + start + bad_r * size
    exc_val = sw[bad_r, bad_c].to(dt)
    counts = torch.bincount(bad_r, minlength=r)
    return knots, order.to(torch.int32), bins, exc_idx, exc_val, counts


def _pack_perm(perm, bits: int) -> bytes:
    """``packing.pack_indices_np(perm, bits)``: kernel 3 over the largest
    multiple of 32 elements, its plain version over the rest."""
    n = perm.numel()
    head = n // packing.GROUP * packing.GROUP
    out = b""
    if head:
        out = ops.pack_bits(perm[:head], b_bits=bits).view(
            torch.uint8).cpu().numpy().tobytes()
    if n > head:
        tail = torch.zeros(packing.GROUP, dtype=torch.int32,
                           device=perm.device)
        tail[: n - head] = perm[head:]
        words = bitpack.pack_bits_plain(tail, b_bits=bits)
        out += words.view(torch.uint8).cpu().numpy().tobytes()[
            : packing.packed_nbytes(n - head, bits)]
    return out


def compress(data: np.ndarray, error_bound: float = 1e-3,
             window: int = 1024, n_knots: int = 32,
             device=None) -> IsabelaBlob:
    dev = resolve_device(device)
    data = np.asarray(data)
    dt = _torch_dtype(data.dtype)
    flat = torch.from_numpy(np.ascontiguousarray(data).reshape(-1)).to(
        dev).to(_F64)
    n = flat.numel()
    E = float(error_bound)
    knots_all: List[np.ndarray] = []
    perm_all: List[np.ndarray] = []
    corr_all: List[np.ndarray] = []
    exc_idx_all: List[np.ndarray] = []
    exc_val_all: List[np.ndarray] = []
    perms, knots_b, corr_b, idx_b, val_b = [], [], [], [], []
    for start, rows in _windows(flat, window):
        knots, order, bins, exc_idx, exc_val, counts = _compress_rows(
            rows, start, E, n_knots, dt)
        perms.append(order.reshape(-1))
        knots, order_h, bins = (knots.cpu().numpy(), order.cpu().numpy(),
                                bins.cpu().numpy())
        exc_idx, exc_val = exc_idx.cpu().numpy(), exc_val.cpu().numpy()
        cuts = np.cumsum(counts.cpu().numpy())[:-1]
        knots_all += list(knots)
        perm_all += list(order_h)
        corr_all += list(bins)
        exc_idx_all += np.split(exc_idx, cuts)
        exc_val_all += np.split(exc_val, cuts)
        knots_b.append(knots.tobytes())
        corr_b.append(bins.tobytes())
        idx_b.append(exc_idx.tobytes())
        val_b.append(exc_val.tobytes())

    bits = _perm_bits(window)
    perm = (torch.cat(perms) if perms
            else torch.zeros(0, dtype=torch.int32, device=dev))
    payload = zlib.compress(
        b"".join(knots_b) + _pack_perm(perm, bits) + b"".join(corr_b)
        + b"".join(idx_b) + b"".join(val_b), 6)
    n_exc = int(sum(len(e) for e in exc_idx_all))
    return IsabelaBlob(window=window, n=n, n_knots=n_knots, payload=payload,
                       meta={"n_exceptions": n_exc,
                             "exception_ratio": n_exc / max(n, 1),
                             "error_bound": E,
                             "knots": knots_all, "perms": perm_all,
                             "corr": corr_all,
                             "exc_idx": exc_idx_all,
                             "exc_val": exc_val_all,
                             "dtype": str(data.dtype),
                             "shape": tuple(np.shape(data))})


def decompress(blob: IsabelaBlob, device=None) -> np.ndarray:
    dev = resolve_device(device)
    m = blob.meta
    E = m["error_bound"]
    dt = _torch_dtype(np.dtype(m["dtype"]))
    out = torch.empty(blob.n, dtype=_F64, device=dev)
    sizes = np.array([p.size for p in m["perms"]], np.int64)
    starts = np.cumsum(sizes) - sizes
    for size in dict.fromkeys(sizes.tolist()):      # windows by size
        wins = np.flatnonzero(sizes == size)

        def rows(key, dtype):
            return torch.from_numpy(np.stack([m[key][i] for i in wins])).to(
                dev).to(dtype)

        fit = _fit(rows("knots", torch.float32), size, blob.n_knots, dev)
        dec = (fit * (1.0 + rows("corr", _F64) * 2 * E)).to(dt).to(_F64)
        w = torch.empty_like(dec).scatter_(1, rows("perms", torch.int64),
                                           dec)
        pos = torch.from_numpy(starts[wins][:, None] + np.arange(size))
        out[pos.to(dev).reshape(-1)] = w.reshape(-1)
    if m["exc_idx"]:
        idx = torch.from_numpy(np.concatenate(m["exc_idx"]).astype(np.int64))
        val = torch.from_numpy(np.concatenate(m["exc_val"]))
        out[idx.to(dev)] = val.to(dev).to(_F64)
    return out.to(dt).cpu().numpy().reshape(m["shape"])


__all__ = ["compress", "decompress", "IsabelaBlob"]
