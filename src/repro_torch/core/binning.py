"""Phase 2: bin construction (paper Sec. III-B / IV-B).

The port's counterpart of the reference's ``core/binning.py``: the top-k
strategy's histogram, sort and rank LUT, and the three earlier strategies
(equal-width, log-scale, k-means), whose sorted float32 centers feed
``assign_nearest``.

The centers of the earlier strategies are a few hundred values computed
from a handful of scalars (equal-width, log-scale) or from the 65,536-bin
histogram (k-means), so they are computed on the host in numpy float32,
one correctly rounded operation at a time as the reference's eager jnp
calls do.  Where the reference's arithmetic is not correctly rounded
(XLA CPU's ``linspace``, ``exp``, ``log`` and its chunked ``cumsum``) the
host emulates it (``core.xla_f32``, ``select_b.cumsum_f32``); its float32
scatter-adds sum in index order, as ``np.add.at`` does.  A CUDA
``index_add_`` would sum with atomics and lose that order.
``assign_nearest`` is element-wise and runs on the ratios' device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import xla_f32
from repro_torch.core.select_b import cumsum_f32

_F32 = np.float32


def local_histogram(bin_ids: torch.Tensor, ok: torch.Tensor, max_bins: int):
    """Count valid ratios per candidate bin (int32); the histogram
    kernel's plain version takes ``ok = bin_ids >= 0``."""
    ids = bin_ids.clamp(0, max_bins - 1).to(torch.int64)
    counts = torch.zeros(max_bins, dtype=torch.int32, device=bin_ids.device)
    return counts.index_add_(0, ids, ok.to(torch.int32))


def sort_histogram(counts: torch.Tensor):
    """Full descending sort of the histogram: (counts_desc, bin_ids_desc).

    The reference takes ``jax.lax.top_k``, which breaks ties by lower bin
    id first; a stable descending sort does the same (``torch.topk`` does
    not).  Tie order decides which bins are kept at the k boundary and
    the order of the centers.
    """
    return torch.sort(counts, descending=True, stable=True)


def rank_lut(selected_bins: torch.Tensor, k: int, max_bins: int):
    """LUT: candidate bin id -> index rank in [0,k), else k (incompressible)."""
    dev = selected_bins.device
    lut = torch.full((max_bins,), k, dtype=torch.int32, device=dev)
    lut[selected_bins.to(torch.int64)] = torch.arange(k, dtype=torch.int32,
                                                      device=dev)
    return lut


# ---------------------------------------------------------------------------
# Earlier strategies (parallelized in Sec. IV-B-3).
# ---------------------------------------------------------------------------

def equal_width_centers(lo, hi, k: int) -> np.ndarray:
    """Evenly split [lo, hi] into k chunks; float32 centers of the chunks."""
    lo, hi = _F32(lo), _F32(hi)
    w = (hi - lo) / _F32(k)
    return lo + (np.arange(k, dtype=_F32) + _F32(0.5)) * w


def log_range(ratios: torch.Tensor, valid: torch.Tensor, eps: float = 1e-12):
    """(min |r| over valid |r| > eps, max |r| over valid) as host float32,
    NaN ratios skipped as ``nanmin``/``nanmax`` skip them, NaN where no
    ratio qualifies; both exact on any device.  One device-to-host copy."""
    absr = ratios.abs()
    valid = valid & ~torch.isnan(absr)
    inf = torch.tensor(float("inf"), dtype=absr.dtype, device=absr.device)
    above = valid & (absr > torch.tensor(eps, dtype=absr.dtype,
                                         device=absr.device))
    amin = torch.where(above, absr, inf).amin()
    amax = torch.where(valid, absr, -inf).amax()
    amin, amax, n_above, n_valid = torch.stack(
        [amin, amax, above.any().float(), valid.any().float()]).tolist()
    return (_F32(amin if n_above else np.nan),
            _F32(amax if n_valid else np.nan))


def log_scale_centers(amin, amax, k: int, eps: float = 1e-12) -> np.ndarray:
    """Log-scale bins over |ratio|, sign-symmetric (float32, sorted).

    Half the budget covers negative ratios, half positive; each side
    splits [log(max(eps, min|r|)), log(max|r|)] evenly in log space.
    ``amin``/``amax`` come from ``log_range``; ``linspace``, ``exp`` and
    ``log`` are XLA CPU's own (``core.xla_f32``), as the reference's.
    """
    amin, amax = _F32(amin), _F32(amax)
    if not np.isfinite(amin):
        amin = _F32(eps)
    if not (np.isfinite(amax) and amax > amin):
        amax = amin * _F32(10.0)
    kh = max(k // 2, 1)
    lg = xla_f32.linspace(xla_f32.log(amin), xla_f32.log(amax), kh)
    pos = xla_f32.exp(lg)
    cs = np.concatenate([-pos[::-1], np.zeros(k - 2 * kh + 1, _F32),
                         pos])[:k]
    return np.sort(cs)


def kmeans_centers(counts: np.ndarray, domain_lo, width, k: int,
                   iters: int = 20) -> np.ndarray:
    """Weighted 1-D k-means over candidate-bin centers (Lloyd iterations).

    Clusters the histogram, O(m * k * I), as the reference does, with its
    float32 operations in its order: the weighted quantile init over the
    chunked cumsum, then per iteration a sort, the midpoints, a
    searchsorted and two scatter-adds in index order.
    """
    counts = np.asarray(counts)
    m = counts.shape[0]
    xs = _F32(domain_lo) + (np.arange(m, dtype=_F32) + _F32(0.5)) \
        * _F32(width)
    w = counts.astype(_F32)
    cw = cumsum_f32(w)
    targets = (np.arange(k, dtype=_F32) + _F32(0.5)) / _F32(k) * cw[-1]
    init_idx = np.searchsorted(cw, targets, side="left")
    centers = xs[np.clip(init_idx, 0, m - 1)]
    wx = w * xs
    for _ in range(iters):
        centers = np.sort(centers)
        mids = _F32(0.5) * (centers[1:] + centers[:-1])
        assign = np.searchsorted(mids, xs, side="left")
        sw = np.zeros(k, _F32)
        sx = np.zeros(k, _F32)
        np.add.at(sw, assign, w)
        np.add.at(sx, assign, wx)
        centers = np.where(sw > 0, sx / np.maximum(sw, _F32(1.0)), centers)
    return np.sort(centers)


def assign_nearest(ratios: torch.Tensor, valid: torch.Tensor,
                   centers_sorted: torch.Tensor, error_bound) -> torch.Tensor:
    """Index = nearest center if within E, else k (incompressible).

    Used by equal/log/kmeans, whose bins may be wider than 2E.  Runs on
    the ratios' device; every operation is exact or correctly rounded,
    and ``torch.searchsorted(side="left")`` is ``jnp.searchsorted``'s
    default, so CPU and CUDA give the reference's indices.  Invalid
    ratios, NaN included, come out as k.
    """
    k = centers_sorted.numel()
    mids = 0.5 * (centers_sorted[1:] + centers_sorted[:-1])
    idx = torch.searchsorted(mids.contiguous(), ratios.contiguous(),
                             side="left").to(torch.int64)
    err = (ratios - centers_sorted[idx.clamp(0, k - 1)]).abs()
    e = torch.tensor(float(_F32(error_bound)), dtype=ratios.dtype,
                     device=ratios.device)
    ok = valid & (err <= e)
    return torch.where(ok, idx, k).to(torch.int32)


__all__ = ["local_histogram", "sort_histogram", "rank_lut",
           "equal_width_centers", "log_range", "log_scale_centers",
           "kmeans_centers", "assign_nearest"]
