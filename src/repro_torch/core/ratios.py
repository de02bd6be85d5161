"""Phase 1: element-wise change-ratio calculation (paper Sec. III-A / IV-A).

    dD[i,j] = (D[i,j] - D[i-1,j]) / D[i-1,j]                     (Eq. 1)

A ratio is *valid* (candidate for binning) iff the previous value is nonzero
and the ratio is finite.  All ratio math is float32, for f64 data too,
exactly as in the reference's ``core/ratios.py``.

On a CUDA tensor PyTorch computes ``tensor / python_scalar`` as a multiply
by the reciprocal, which is not correctly rounded; every division here is
therefore tensor by tensor, with scalars held as 0-d tensors on the data's
device.

The two host copies of the range pass are the ``sync.range`` and
``sync.signed_zero`` telemetry spans.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.obs import telemetry


def change_ratios(prev: torch.Tensor, curr: torch.Tensor):
    """Return (ratios f32, valid bool), flattened to 1-D."""
    prev = prev.reshape(-1).to(torch.float32)
    curr = curr.reshape(-1).to(torch.float32)
    denom_ok = prev != 0.0
    safe_prev = torch.where(denom_ok, prev, torch.ones_like(prev))
    ratios = (curr - safe_prev) / safe_prev
    valid = denom_ok & torch.isfinite(ratios) & torch.isfinite(curr)
    ratios = torch.where(valid, ratios, torch.zeros_like(ratios))
    return ratios, valid


def valid_ends(ratios: torch.Tensor, valid: torch.Tensor):
    """(min, max) over valid ratios as host floats, each zero end signed
    as XLA's min and max sign it; (inf, -inf) when none are valid.  One
    device-to-host copy (two when an end is zero)."""
    ends = valid_ends_device(ratios, valid)
    with telemetry.span("sync.range"):
        lo, hi = ends.tolist()
    if lo == 0 or hi == 0:
        lo, hi = _signed_zero_ends(ratios, valid, lo, hi)
    return lo, hi


def valid_ends_device(ratios: torch.Tensor, valid: torch.Tensor):
    """``valid_ends``' device part: (2,) float32 on the ratios' device,
    the min and max over valid ratios (inf, -inf when none are valid),
    zeros unsigned."""
    lo = torch.where(valid, ratios, float("inf")).amin()
    hi = torch.where(valid, ratios, float("-inf")).amax()
    return torch.stack([lo, hi])


def ratio_range(ratios: torch.Tensor, valid: torch.Tensor):
    """(min, max) over valid ratios as host float32; (0, 0) when none are
    valid."""
    lo, hi = valid_ends(ratios, valid)
    if lo > hi:
        return np.float32(0.0), np.float32(0.0)
    return np.float32(lo), np.float32(hi)


def _signed_zero_ends(ratios, valid, lo: float, hi: float):
    """XLA's min and max order -0 below +0: the reference's minimum is
    -0 when any valid ratio is -0 (x / negative prev with x == prev), its
    maximum +0 when any is +0; torch's amin and amax keep either zero.
    Both ends are recorded in the step (domain_lo, meta ratio_min/max)."""
    zero = valid & (ratios == 0)
    neg = torch.signbit(ratios)
    flags = torch.stack([(zero & neg).any(), (zero & ~neg).any()])
    with telemetry.span("sync.signed_zero"):
        neg_zero, pos_zero = flags.tolist()
    if lo == 0:
        lo = -0.0 if neg_zero else 0.0
    if hi == 0:
        hi = 0.0 if pos_zero else -0.0
    return lo, hi


def histogram_domain(lo: np.float32, hi: np.float32, error_bound: float,
                     max_bins: int):
    """(domain_lo, width, id_bound) of the candidate-bin histogram.

    domain_lo and width are float32 as in the reference: bins of width 2E
    anchored at the global minimum when the range fits in max_bins bins,
    else centred on zero.  id_bound is an exclusive upper bound on the
    step's candidate-bin ids, which sizes the histogram kernel's table:
    ``floor((hi - domain_lo) / width) + 1``, clamped to [1, max_bins], when
    the range fits, else max_bins.  numpy float32 scalars round each step
    as the change-ratio kernel's ``__fsub_rn`` and ``__fdiv_rn`` do, and
    the id is monotone in the ratio, so the largest id of the step is the
    id of ``hi``: the bound is exact, for f64 data too, since the range
    pass and the kernel both round the data to float32 once before any
    arithmetic.
    """
    lo, hi = np.float32(lo), np.float32(hi)
    width = np.float32(2.0) * np.float32(error_bound)
    coverage = width * np.float32(max_bins)
    if not hi - lo <= coverage:
        return np.float32(np.float32(-0.5) * coverage), width, int(max_bins)
    top = np.floor((hi - lo) / width)
    bound = int(min(max(top + np.float32(1), np.float32(1)), max_bins))
    return lo, width, bound


def candidate_bin_ids(ratios: torch.Tensor, valid: torch.Tensor, domain_lo,
                      width, max_bins: int):
    """Map each ratio to its candidate histogram bin; -1 if not binnable."""
    dev = ratios.device
    lo_t = torch.tensor(float(domain_lo), dtype=torch.float32, device=dev)
    w_t = torch.tensor(float(width), dtype=torch.float32, device=dev)
    m_t = torch.tensor(float(max_bins), dtype=torch.float32, device=dev)
    raw = torch.floor((ratios - lo_t) / w_t)
    ok = valid & (raw >= 0) & (raw < m_t)
    ids = torch.where(ok, raw, torch.full_like(raw, -1.0))
    return ids.to(torch.int32), ok


__all__ = ["change_ratios", "valid_ends", "valid_ends_device", "ratio_range",
           "histogram_domain",
           "candidate_bin_ids"]
