"""Kernel 1: fused change ratio + candidate-bin id (``csrc/change_ratio.cu``).

Replaces the reference's Pallas ``change_ratio_bins``
(src/repro/kernels/change_ratio.py:44, pallas_call at :67).
``change_ratio_bins_plain`` is the same function in plain PyTorch: the CPU
path, and what the kernel is held against on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import ratios
from repro_torch.kernels._build import Kernel, check_cuda

KERNEL = Kernel("change_ratio",
                replaces="src/repro/kernels/change_ratio.py:67")
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float,
             ctypes.c_float, ctypes.c_int)
_SYMBOL = {torch.float32: "change_ratio_bins_f32",
           torch.float64: "change_ratio_bins_f64"}


def change_ratio_bins_plain(prev, curr, domain_lo, width, *, max_bins):
    """(n,) x2 -> (ratios f32 (n,), bin_ids i32 (n,))."""
    r, valid = ratios.change_ratios(prev, curr)
    ids, _ = ratios.candidate_bin_ids(r, valid, domain_lo, width, max_bins)
    return r, ids


def change_ratio_bins_cuda(prev, curr, domain_lo, width, *, max_bins):
    """The kernel: f32 or f64 CUDA tensors of one length (f64 is rounded
    to f32 inside the kernel, before any arithmetic)."""
    check_cuda("prev", prev, tuple(_SYMBOL))
    check_cuda("curr", curr, (prev.dtype,), prev.numel())
    n = prev.numel()
    r = torch.empty(n, dtype=torch.float32, device=prev.device)
    ids = torch.empty(n, dtype=torch.int32, device=prev.device)
    if n:
        KERNEL.launch(_SYMBOL[prev.dtype], _ARGTYPES, prev.data_ptr(),
                      curr.data_ptr(), r.data_ptr(), ids.data_ptr(), n,
                      float(domain_lo), float(width), int(max_bins))
    return r, ids


__all__ = ["KERNEL", "change_ratio_bins_plain", "change_ratio_bins_cuda"]
