"""Kernel 2: candidate-bin histogram (``csrc/hist.cu``).

Replaces the reference's Pallas ``histogram`` (src/repro/kernels/hist.py:45,
pallas_call at :56).  Any ``max_bins >= 1`` works (the Pallas kernel needs
a multiple of 1024).  ``histogram_plain`` is the same function in plain
PyTorch.

``id_bound`` is a size hint for the kernel's shared-memory table: the
caller expects every id below it (the main path computes it with
``core.ratios.histogram_domain``).  It never changes the result: an id at or above
it, below ``max_bins``, is still counted.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import binning
from repro_torch.kernels._build import Kernel, check_cuda, library

KERNEL = Kernel("hist", replaces="src/repro/kernels/hist.py:56")
_ARGTYPES = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int)
_PLAN_KEYS = ("grid_x", "slices", "threads", "blocks_per_sm", "cluster",
              "block_bins", "smem_bytes", "table_bins")


def histogram_plain(bin_ids, *, max_bins, id_bound=None):
    """(n,) int32 in [-1, max_bins) -> (max_bins,) int32 counts.
    ``id_bound`` is the kernel's size hint and changes nothing here."""
    del id_bound
    return binning.local_histogram(bin_ids, bin_ids >= 0, max_bins)


def _bound(max_bins, id_bound):
    if max_bins < 1:
        raise ValueError("max_bins must be >= 1")
    return int(max_bins if id_bound is None else min(id_bound, max_bins))


def histogram_cuda(bin_ids, *, max_bins, id_bound=None):
    check_cuda("bin_ids", bin_ids, (torch.int32,))
    bound = _bound(max_bins, id_bound)
    n = bin_ids.numel()
    if not n:
        return torch.zeros(max_bins, dtype=torch.int32,
                           device=bin_ids.device)
    # histogram_i32 zeroes the counts (cudaMemsetAsync ahead of the kernel).
    counts = torch.empty(max_bins, dtype=torch.int32, device=bin_ids.device)
    KERNEL.launch("histogram_i32", _ARGTYPES, bin_ids.data_ptr(), n,
                  counts.data_ptr(), int(max_bins), bound)
    return counts


def launch_plan(bin_ids, *, max_bins, id_bound=None) -> dict:
    """The launch ``histogram_cuda`` makes for these arguments (grid,
    blocks per SM, cluster size, table), for logs.  Launches
    nothing and counts no launch."""
    check_cuda("bin_ids", bin_ids, (torch.int32,))
    fn = library(KERNEL.name).histogram_plan
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(_PLAN_KEYS))()
    rc = fn(bin_ids.data_ptr(), bin_ids.numel(), int(max_bins),
            _bound(max_bins, id_bound), ctypes.addressof(out))
    if rc:
        raise RuntimeError(f"hist: histogram_plan failed with CUDA error "
                           f"{rc}")
    return dict(zip(_PLAN_KEYS, out))


__all__ = ["KERNEL", "histogram_plain", "histogram_cuda", "launch_plan"]
