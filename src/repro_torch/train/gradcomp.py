"""NUMARCK-binning gradient compression with error feedback (the port of
the reference's ``train/gradcomp.py``).

Per tensor, gradients are binned into 2^B - 1 value bins chosen by
histogram top-k (values, not ratios -- gradients have no temporal base),
values outside the top-k bins pass through exactly, and the residual
(quantization error) is accumulated locally and re-injected next step
(error feedback, a la 1-bit Adam / EF-SGD).

The value-bin counts are the reference's ``.at[ids].add(1)``, the same
function as kernel 2: ``kernels.ops.histogram`` runs the hand-written
histogram kernel on a CUDA tensor (the table is ``max_bins`` = 16 * 2^B
bins, 1,024 at B = 6) and its plain version on a CPU one.  The top-k is
``core.binning.sort_histogram``, with ``lax.top_k``'s lower-index-first
tie order.  Every step but ``alpha`` (a float32 mean) is exact on the
same input: min, max, ``(flat - lo) / width`` (a 0-d device divisor),
the int32 cast, the counts, the top-k, the LUT and the centers (one
fma, as XLA CPU contracts them; ``core.xla_f32.fma32_tensor``); so
``g_hat`` equals the reference's on the CPU and the card's equals the
CPU's.

Unlike the reference, ``compress_grads`` updates the residual in place
(the same values; it saves a second residual, 4.9 GB at Llama-3.2-1B's
full width).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core import binning, xla_f32
from repro_torch.core.tree import leaves_with_keys, map_with_keys
from repro_torch.kernels import ops as kops


class GradCompState(NamedTuple):
    residual: Any          # error-feedback accumulator (like grads), f32


def quantize_dequantize(g: torch.Tensor, b_bits: int = 6,
                        max_bins: int = 0):
    """Top-k value-binning round trip (what the wire would carry).

    Returns (g_hat, {"alpha"}) with g_hat the dequantized gradient in
    g's dtype; values outside the top-k bins pass through exactly, and
    constant tensors pass through whole.  `max_bins` defaults to
    16 * 2^B: gradients are heavy-tailed, not clustered, so the candidate
    grid stays within a small multiple of the codebook.
    """
    if not max_bins:
        max_bins = min(16 * (1 << b_bits), 1 << 16)
    flat = g.reshape(-1).to(torch.float32)
    lo = torch.amin(flat)
    hi = torch.amax(flat)
    width = torch.clamp_min((hi - lo) / torch.tensor(
        float(max_bins), dtype=torch.float32, device=flat.device), 1e-20)
    ids = torch.clamp(((flat - lo) / width).to(torch.int32), 0,
                      max_bins - 1)
    counts = kops.histogram(ids, max_bins=max_bins, id_bound=max_bins)
    k = (1 << b_bits) - 1
    top_ids = binning.sort_histogram(counts)[1][:k]
    ranks = binning.rank_lut(top_ids, k, max_bins)[ids]
    # XLA CPU contracts the reference's lo + (top + 0.5) * width to an fma
    centers = xla_f32.fma32_tensor(top_ids.to(torch.float32) + 0.5, width,
                                   lo)
    centers_pad = torch.cat([centers, centers.new_zeros(1)])
    compressible = (ranks < k) & (hi > lo)
    g_hat = torch.where(compressible, centers_pad[ranks], flat)
    alpha = torch.mean((~compressible).to(torch.float32))
    return g_hat.reshape(g.shape).to(g.dtype), {"alpha": alpha}


def init_state(grads_like) -> GradCompState:
    return GradCompState(residual=map_with_keys(
        lambda _, g: torch.zeros(g.shape, dtype=torch.float32,
                                 device=g.device), grads_like))


@torch.no_grad()
def compress_grads(grads, state: GradCompState, b_bits: int = 6,
                   max_bins: int = 0):
    """Error-feedback compression: g_hat = Q(g + r);  r' = g + r - g_hat.
    Returns (g_hat in each gradient's dtype, GradCompState(r')) with r'
    the state's residual tensors, updated in place."""
    resid = dict(leaves_with_keys(state.residual))

    def one(key, g):
        r = resid[key]
        corrected = r.add_(g.to(torch.float32))  # g.f32 + r, into r
        g_hat, _ = quantize_dequantize(corrected, b_bits=b_bits,
                                       max_bins=max_bins)
        r.sub_(g_hat)                            # corrected - g_hat
        return g_hat.to(g.dtype)

    return map_with_keys(one, grads), state


def wire_bits(g: torch.Tensor, b_bits: int, alpha: float) -> float:
    """Estimated wire size vs raw f32 (Eq. 6 adapted to gradients)."""
    n = g.numel()
    return (n * b_bits + alpha * n * 32) / (n * 32)


__all__ = ["GradCompState", "quantize_dequantize", "init_state",
           "compress_grads", "wire_bits"]
