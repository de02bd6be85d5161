"""Phase 2: bin construction, top-k strategy (paper Sec. III-B / IV-B).

The port's counterpart of the reference's ``core/binning.py`` for the
top-k strategy; equal-width, log-scale and k-means binning follow in a
later slice (ROADMAP.md).
"""
from __future__ import annotations

import torch


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


__all__ = ["local_histogram", "sort_histogram", "rank_lut"]
