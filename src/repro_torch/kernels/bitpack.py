"""Kernel 3: B-bit index packing (``csrc/bitpack.cu``).

Replaces the reference's Pallas ``pack_bits``
(src/repro/kernels/bitpack.py:40, pallas_call at :54).  The plain version
is ``core.packing.pack_indices``: the same uint32 words, whose
little-endian bytes equal ``packing.pack_indices_np``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import packing
from repro_torch.kernels._build import Kernel, check_cuda

KERNEL = Kernel("bitpack", replaces="src/repro/kernels/bitpack.py:54")
_ARGTYPES = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_int)


def pack_bits_plain(idx, *, b_bits):
    """(n,) int32, n % 32 == 0 -> (n // 32 * B,) uint32 words."""
    return packing.pack_indices(idx, b_bits)


def pack_bits_cuda(idx, *, b_bits):
    check_cuda("idx", idx, (torch.int32,))
    n = idx.numel()
    if n % packing.GROUP:
        raise ValueError(f"pack_bits needs n % 32 == 0, got n={n}")
    if not 1 <= b_bits <= 24:
        raise ValueError(f"b_bits must be in [1, 24], got {b_bits}")
    if idx.data_ptr() % 16:
        raise ValueError("idx must be 16-byte aligned (the kernel reads "
                         "each 32-index group as 16-byte vectors)")
    words = torch.empty(n // packing.GROUP * b_bits, dtype=torch.uint32,
                        device=idx.device)
    if n:
        KERNEL.launch("pack_bits_i32", _ARGTYPES, idx.data_ptr(), n,
                      words.data_ptr(), int(b_bits))
    return words


__all__ = ["KERNEL", "pack_bits_plain", "pack_bits_cuda"]
