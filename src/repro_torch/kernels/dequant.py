"""Kernel 4: dequantize and the fused chain advance (``csrc/dequant.cu``).

Replaces the reference's Pallas ``dequantize``
(src/repro/kernels/dequant.py:54, pallas_call at :78) together with
``dequant.patch_exceptions`` (:109) and the marker patch of
``ops.chain_advance_core`` (src/repro/kernels/ops.py:88): one kernel, in
float32 and float64, that either patches the marker lanes from ``curr``
(chain advance) or sets them to 0 (``dequantize``).

The plain versions gather ``c = centers[idx]`` for ``idx < k`` and 0
otherwise, then compute ``prev * (1 + c)``: no 2^B lookup table.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import Kernel, check_cuda

KERNEL = Kernel("dequant", replaces="src/repro/kernels/dequant.py:78")
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_longlong)
_SYMBOL = {torch.float32: "dequant_f32", torch.float64: "dequant_f64"}


def _plain(idx, prev, curr, centers, b_bits):
    marker = (1 << b_bits) - 1
    k = centers.numel()
    idx = idx.to(torch.int64)
    inside = (idx >= 0) & (idx < k)
    if k:
        c = torch.where(inside, centers[idx.clamp(0, k - 1)],
                        torch.zeros((), dtype=prev.dtype,
                                    device=prev.device))
    else:
        c = torch.zeros_like(prev)
    out = prev * (1 + c)
    fill = curr if curr is not None else torch.zeros_like(out)
    return torch.where(idx == marker, fill, out)


def dequantize_plain(idx, prev, centers, *, b_bits):
    """(n,) i32 idx, (n,) prev, (k,) centers -> (n,) in prev's dtype;
    marker lanes (idx == 2^B - 1) are 0."""
    return _plain(idx, prev, None, centers.to(prev.dtype), b_bits)


def chain_advance_plain(idx, prev, curr, centers, *, b_bits):
    """R_i = prev * (1 + centers[idx]); R_i[idx == marker] = curr."""
    return _plain(idx, prev, curr.to(prev.dtype), centers.to(prev.dtype),
                  b_bits)


def _launch(idx, prev, curr: Optional[torch.Tensor], centers, b_bits):
    check_cuda("prev", prev, tuple(_SYMBOL))
    n = prev.numel()
    check_cuda("idx", idx, (torch.int32,), n)
    check_cuda("centers", centers, (prev.dtype,))
    if curr is not None:
        check_cuda("curr", curr, (prev.dtype,), n)
    marker = (1 << b_bits) - 1
    if centers.numel() > marker:
        raise ValueError(f"{centers.numel()} centers do not fit B={b_bits}")
    out = torch.empty_like(prev)
    if n:
        KERNEL.launch(_SYMBOL[prev.dtype], _ARGTYPES, idx.data_ptr(),
                      prev.data_ptr(),
                      curr.data_ptr() if curr is not None else None,
                      centers.data_ptr(), centers.numel(), marker,
                      out.data_ptr(), n)
    return out


def dequantize_cuda(idx, prev, centers, *, b_bits):
    return _launch(idx, prev, None, centers, b_bits)


def chain_advance_cuda(idx, prev, curr, centers, *, b_bits):
    return _launch(idx, prev, curr, centers, b_bits)


def patch_exceptions(recon, idx, exc_values, *, b_bits):
    """Scatter the compacted exception table over the marker lanes, in
    stream order (the reference's ``dequant.patch_exceptions``).  Plain
    PyTorch on any device: an index copy, not a kernel of the reference."""
    marker = (1 << b_bits) - 1
    pos = torch.nonzero(idx.reshape(-1) == marker).reshape(-1)
    m = min(pos.numel(), exc_values.numel())
    out = recon.clone()
    out[pos[:m]] = exc_values[:m].to(recon.dtype)
    return out


__all__ = ["KERNEL", "dequantize_plain", "dequantize_cuda",
           "chain_advance_plain", "chain_advance_cuda", "patch_exceptions"]
