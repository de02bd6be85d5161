"""Dispatch over the port's kernels: a CPU tensor goes to the plain
PyTorch version, a CUDA tensor to the hand-written kernel, and any other
device raises.  There is no other switch and no fallback.

Also the encode stage's exception compaction, which needs no kernel (as
in the reference's ``kernels/ops.py``: a nonzero plus per-block counts).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import bitpack, change_ratio, dequant, hist, rans
from repro_torch.obs import telemetry

# Every kernel of the main paths, for build checks and launch counts: the
# four of the compress path, then the rANS encode, decode and unpack.
KERNELS = (change_ratio.KERNEL, hist.KERNEL, bitpack.KERNEL, dequant.KERNEL,
           rans.ENCODE, rans.DECODE, rans.UNPACK)


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def change_ratio_bins(prev, curr, domain_lo, width, *, max_bins):
    fn = (change_ratio.change_ratio_bins_cuda if _on_cuda(prev)
          else change_ratio.change_ratio_bins_plain)
    return fn(prev, curr, domain_lo, width, max_bins=max_bins)


def histogram(bin_ids, *, max_bins, id_bound=None):
    fn = hist.histogram_cuda if _on_cuda(bin_ids) else hist.histogram_plain
    return fn(bin_ids, max_bins=max_bins, id_bound=id_bound)


def pack_bits(idx, *, b_bits):
    fn = (bitpack.pack_bits_cuda if _on_cuda(idx)
          else bitpack.pack_bits_plain)
    return fn(idx, b_bits=b_bits)


def dequantize(idx, prev, centers, *, b_bits):
    fn = (dequant.dequantize_cuda if _on_cuda(prev)
          else dequant.dequantize_plain)
    return fn(idx, prev, centers, b_bits=b_bits)


def chain_advance(idx, prev, curr, centers, *, b_bits):
    """Fused REF_RECONSTRUCTED chain advance:
    R_i = prev * (1 + centers[idx]);  R_i[idx == marker] = curr."""
    fn = (dequant.chain_advance_cuda if _on_cuda(prev)
          else dequant.chain_advance_plain)
    return fn(idx, prev, curr, centers, b_bits=b_bits)


def rans_encode(syms, fc, *, L):
    fn = rans.encode_cuda if _on_cuda(syms) else rans.encode_plain
    return fn(syms, fc, L=L)


def rans_decode_bytes(dec, states, stream, n_emit, *, m, L):
    fn = (rans.decode_bytes_cuda if _on_cuda(dec)
          else rans.decode_bytes_plain)
    return fn(dec, states, stream, n_emit, m=m, L=L)


def rans_decode_syms(dec, sym_tab, states, stream, n_emit, *, m, L, n,
                     n_sym, b_bits):
    fn = rans.decode_syms_cuda if _on_cuda(dec) else rans.decode_syms_plain
    return fn(dec, sym_tab, states, stream, n_emit, m=m, L=L, n=n,
              n_sym=n_sym, b_bits=b_bits)


def rans_unpack(byts, *, b_bits, be):
    fn = rans.unpack_cuda if _on_cuda(byts) else rans.unpack_plain
    return fn(byts, b_bits=b_bits, be=be)


def exception_compact(idx, n, marker, block_elems):
    """Incompressible compaction for the encode stage: (per-block marker
    counts (nblocks,) int64, ascending marker positions (k,) int64), both
    on the host.  The ``nonzero`` and the two copies are the
    ``sync.exc_nonzero``, ``sync.exc_counts`` and ``sync.exc_positions``
    spans."""
    mask = idx.reshape(-1)[:n] == marker
    nblocks = -(-n // block_elems)
    padded = torch.zeros(nblocks * block_elems, dtype=torch.int32,
                         device=mask.device)
    padded[:n] = mask
    counts = padded.view(nblocks, block_elems).sum(dim=1)
    with telemetry.span("sync.exc_nonzero"):
        pos = torch.nonzero(mask).reshape(-1)
    with telemetry.span("sync.exc_counts"):
        counts = counts.cpu()
    with telemetry.span("sync.exc_positions"):
        pos = pos.cpu()
    return (counts.numpy().astype(np.int64), pos.numpy().astype(np.int64))


__all__ = ["KERNELS", "change_ratio_bins", "histogram", "pack_bits",
           "dequantize", "chain_advance", "rans_encode", "rans_decode_bytes",
           "rans_decode_syms", "rans_unpack", "exception_compact"]
