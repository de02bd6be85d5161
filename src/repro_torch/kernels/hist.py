"""Kernel 2: candidate-bin histogram (``csrc/hist.cu``).

Replaces the reference's Pallas ``histogram`` (src/repro/kernels/hist.py:45,
pallas_call at :56).  Any ``max_bins >= 1`` works (the Pallas kernel needs
a multiple of 1024).  ``histogram_plain`` is the same function in plain
PyTorch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import binning
from repro_torch.kernels._build import Kernel, check_cuda

KERNEL = Kernel("hist", replaces="src/repro/kernels/hist.py:56")
_ARGTYPES = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_int)


def histogram_plain(bin_ids, *, max_bins):
    """(n,) int32 in [-1, max_bins) -> (max_bins,) int32 counts."""
    return binning.local_histogram(bin_ids, bin_ids >= 0, max_bins)


def histogram_cuda(bin_ids, *, max_bins):
    check_cuda("bin_ids", bin_ids, (torch.int32,))
    if max_bins < 1:
        raise ValueError("max_bins must be >= 1")
    counts = torch.zeros(max_bins, dtype=torch.int32, device=bin_ids.device)
    n = bin_ids.numel()
    if n:
        KERNEL.launch("histogram_i32", _ARGTYPES, bin_ids.data_ptr(), n,
                      counts.data_ptr(), int(max_bins))
    return counts


__all__ = ["KERNEL", "histogram_plain", "histogram_cuda"]
