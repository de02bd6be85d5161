"""XLA CPU's float32 ``linspace``, ``exp`` and ``log``, bit for bit, on
the host.

The log-scale binning strategy (``binning.log_scale_centers``) must give
the reference's centers exactly, and the reference computes them with
XLA CPU's own float32 routines.  Those are not correctly rounded, and
neither torch's nor numpy's agree with them, so this module evaluates the
same operations in the same order with numpy:

  linspace(a, b, num)  rc = 1/(num-1); u = 1 - i*rc (one fma or two
                       roundings, by entry); out[i] = fma(i, b*rc, a*u);
                       out[num-1] = b
  exp(x)               Cephes/Eigen ``pexp``: x clamped to [-87.8, 88.8],
                       m = floor(fma(x, log2e, 0.5)) clamped to
                       [-127, 127], a two-step Cody-Waite reduction, a
                       degree-5 Horner polynomial, times 2^m built from
                       the exponent bits
  log(x)               Cephes/Eigen ``plog``: frexp, the sqrt(1/2) fold,
                       an estrin-split degree-8 polynomial; denormals
                       read as zero

with every multiply-add that LLVM contracts on the way to the machine
code taken as one ``fma32`` (a single rounding).  These forms were read
from the LLVM IR that XLA CPU emits for ``jnp.linspace``, ``jnp.exp``
and ``jnp.log`` and agree with them on every value the tests draw.
Only a handful of scalars per step go through here, so speed does not
matter.

``fma32_tensor`` is ``fma32`` in torch float64 operations on any device,
for the contractions XLA CPU makes in code that runs on the card
(gradient compression's bin centers).
"""
from __future__ import annotations

import numpy as np
import torch

_F32 = np.float32
_F64 = np.float64


def fma32(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` with one rounding (IEEE fusedMultiplyAdd).

    The product of two float32 values is exact in float64; TwoSum then
    splits ``p + c`` into its float64 sum ``s`` and the exact error
    ``e``.  Rounding ``s`` to float32 is the right answer unless ``s``
    sits exactly halfway between two float32 values, where the sign of
    ``e`` says which way the exact sum lies.
    """
    a, b, c = (np.asarray(v, _F32).astype(_F64) for v in (a, b, c))
    a, b, c = np.broadcast_arrays(a, b, c)
    with np.errstate(over="ignore", invalid="ignore"):
        p = a * b
        s = p + c
        bv = s - p
        e = (p - (s - bv)) + (c - bv)
        r = s.astype(_F32)
        up = np.nextafter(r, _F32(np.inf))
        dn = np.nextafter(r, _F32(-np.inf))
        r64 = r.astype(_F64)
        tie_up = (up.astype(_F64) - s) == (s - r64)
        tie_dn = (s - dn.astype(_F64)) == (r64 - s)
    out = np.where(tie_up & (e > 0), up, r)
    out = np.where(tie_dn & (e < 0), dn, out)
    return np.asarray(out, _F32)


def fma32_tensor(a: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor) -> torch.Tensor:
    """``fma32`` on float32 tensors of one device, with no host sync:
    the same float64 product, TwoSum and tie correction."""
    a, b, c = (t.to(torch.float64) for t in (a, b, c))
    p = a * b
    s = p + c
    bv = s - p
    e = (p - (s - bv)) + (c - bv)
    r = s.to(torch.float32)
    up = torch.nextafter(r, torch.full_like(r, float("inf")))
    dn = torch.nextafter(r, torch.full_like(r, float("-inf")))
    r64 = r.to(torch.float64)
    tie_up = (up.to(torch.float64) - s) == (s - r64)
    tie_dn = (s - dn.to(torch.float64)) == (r64 - s)
    out = torch.where(tie_up & (e > 0), up, r)
    return torch.where(tie_dn & (e < 0), dn, out)


def _fused_u_stop(num: int) -> int:
    """How many leading linspace entries have ``u = 1 - i*rc`` computed
    as one fma (XLA CPU's vectorized loop); the rest round ``i*rc``
    first (entries that LLVM unrolled and constant-folded).

    LLVM's choice depends on the trip count num - 1, so this is a table
    read off XLA CPU (jax 0.9.0, x86-64 with FMA), checked at every num
    the log-scale strategy uses (num = 2^(B-1) - 1, B = 2..24): up to 255
    entries the loop is unrolled; from 511 on it is vectorized 32 entries
    at a time with an unrolled tail of (num - 1) % 32 entries; at 8191
    and 16383 XLA splits it into parallel chunks whose tails are
    vectorized too.  The chunking follows XLA's own cost model.
    """
    if num <= 255:
        return 0
    if num in (8191, 16383):
        return num - 1
    return (num - 1) // 32 * 32


def linspace(a, b, num: int) -> np.ndarray:
    """``jnp.linspace(a, b, num)`` for float32 scalars ``a``, ``b``:
    ``out[i] = fma(i, b*rc, a*u)`` with ``rc = 1/(num-1)``,
    ``u = 1 - i*rc`` (``_fused_u_stop`` says where that is one fma), and
    ``out[num-1] = b``.  Where the loop is unrolled and num <= 32, LLVM
    folds ``b*rc*1`` at i = 1 and fuses ``a*u`` instead."""
    a, b = _F32(a), _F32(b)
    if num == 1:
        return np.array([a], _F32)
    rc = _F32(_F32(1) / _F32(num - 1))
    i = np.arange(num, dtype=_F32)
    u = _F32(1) - i * rc
    stop = _fused_u_stop(num)
    u[:stop] = fma32(-i[:stop], rc, _F32(1))
    out = fma32(i, b * rc, a * u)
    if num <= 32:
        out[1] = fma32(a, u[1], b * rc)
    out[num - 1] = b
    return out


_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
             4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def exp(x) -> np.ndarray:
    """``jnp.exp`` of float32 values."""
    x = np.clip(np.asarray(x, _F32), _F32(-87.8), _F32(88.8))
    m = np.clip(np.floor(fma32(x, _F32(1.44269504088896341), _F32(0.5))),
                -127, 127).astype(_F32)
    r = fma32(m, _F32(-0.693359375), x)
    r = fma32(m, _F32(2.12194440e-4), r)
    y = np.asarray(_F32(_EXP_POLY[0]))
    for c in _EXP_POLY[1:]:
        y = fma32(y, r, _F32(c))
    y = fma32(y, r * r, r) + _F32(1)
    scale = ((m.astype(np.int32) + 127) << 23).astype(np.int32).view(_F32)
    return np.asarray(y * scale, _F32)


_LOG_POLY = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
             -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
             2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def log(x) -> np.ndarray:
    """``jnp.log`` of float32 values (x <= 0 and inf as IEEE says)."""
    x_in = np.asarray(x, _F32)
    x = np.maximum(x_in, _F32(2.0 ** -126))
    m, e = np.frexp(x)
    m, e = m.astype(_F32), e.astype(_F32)
    fold = m < _F32(0.707106781186547524)
    e = np.where(fold, e - _F32(1), e).astype(_F32)
    x = np.where(fold, (m - _F32(1)) + m, m - _F32(1)).astype(_F32)
    x2 = x * x
    x3 = x2 * x
    p = [_F32(c) for c in _LOG_POLY]
    y = fma32(p[0], x, p[1])
    y1 = fma32(p[3], x, p[4])
    y2 = fma32(p[6], x, p[7])
    y = fma32(y, x, p[2])
    y1 = fma32(y1, x, p[5])
    y2 = fma32(y2, x, p[8])
    y = fma32(y, x3, y1)
    y = fma32(y, x3, y2)
    y = fma32(y, x3, _F32(-2.12194440e-4) * e)
    x = fma32(x2, _F32(-0.5), x)
    out = fma32(e, _F32(0.693359375), x + y)
    with np.errstate(invalid="ignore"):
        out = np.where(x_in < _F32(2.0 ** -126), _F32(-np.inf), out)
        out = np.where(x_in < 0, _F32(np.nan), out)
        out = np.where(x_in == _F32(np.inf), _F32(np.inf), out)
        out = np.where(np.isnan(x_in), _F32(np.nan), out)
    return np.asarray(out, _F32)


__all__ = ["fma32", "fma32_tensor", "linspace", "exp", "log"]
