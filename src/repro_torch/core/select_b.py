"""Auto-selection of the index length B (paper Sec. IV-B-2, Eq. 6).

    file_size(B) = 2^B * L  +  n * B / 8  +  n * alpha(B) * L

where alpha(B) is the incompressible ratio when keeping the top (2^B - 1)
candidate bins.  Computed in float32 on the host, as the reference does on
its device: the model is a 65,536-entry prefix sum and a few dozen flops.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.obs import telemetry

_CHUNK = 16


def cumsum_f32(x: np.ndarray) -> np.ndarray:
    """Inclusive float32 prefix sum in XLA CPU's order, bit for bit.

    XLA CPU lowers ``jnp.cumsum`` to a ``reduce_window`` that it computes
    as a chunked scan with base 16: pad to a multiple of 16, take a
    sequential float32 prefix inside each chunk of 16, take the same scan
    recursively over the chunk totals, and add each chunk's exclusive
    carry in float32.  Every prefix is exact while the total is below
    2^24; above it the rounding follows this order, which a sequential or
    an int64 sum does not reproduce.
    """
    x = np.asarray(x, np.float32).reshape(-1)
    n = x.size
    if n <= _CHUNK:
        return np.cumsum(x, dtype=np.float32)
    chunks = np.zeros(-(-n // _CHUNK) * _CHUNK, np.float32)
    chunks[:n] = x
    chunks = np.cumsum(chunks.reshape(-1, _CHUNK), axis=1, dtype=np.float32)
    carry = np.zeros(chunks.shape[0], np.float32)
    carry[1:] = cumsum_f32(chunks[:-1, -1])
    return (chunks + carry[:, None]).reshape(-1)[:n]


def estimated_file_sizes(counts_desc: torch.Tensor, n: int, elem_bytes: int,
                         b_max: int) -> torch.Tensor:
    """Eq. (6) for B in [1, b_max].  Returns float32 (b_max,) byte sizes.

    The prefix of the counts is the reference's float32 cumsum, summed in
    XLA CPU's order (``cumsum_f32``), so the sizes agree bit for bit above
    2^24 elements too.
    """
    counts_desc = counts_desc.cpu()
    m = counts_desc.shape[0]
    cum = torch.from_numpy(cumsum_f32(counts_desc.numpy()))
    bs = torch.arange(1, b_max + 1, dtype=torch.float32)
    pow2 = torch.exp2(bs)
    ks = torch.minimum(pow2 - 1.0, torch.tensor(float(m))).to(torch.int32)
    covered = cum[(ks - 1).clamp(0, m - 1).to(torch.int64)]
    covered = torch.where(ks > 0, covered, torch.zeros_like(covered))
    nf = torch.tensor(float(n), dtype=torch.float32)
    incompressible = torch.clamp_min(nf - covered, 0.0)
    center_bytes = pow2 * float(elem_bytes)
    index_bytes = nf * bs / 8.0
    exception_bytes = incompressible * float(elem_bytes)
    return center_bytes + index_bytes + exception_bytes


def choose_b(counts_desc: torch.Tensor, n: int, elem_bytes: int, b_max: int):
    """argmin_B file_size(B) (first minimum); returns (B, sizes (b_max,)).
    The histogram's copy to the host is the ``sync.choose_b`` span, the
    model on the host the ``choose_b.model`` span."""
    with telemetry.span("sync.choose_b"):
        counts_desc = counts_desc.cpu()
    with telemetry.span("choose_b.model"):
        sizes = estimated_file_sizes(counts_desc, n, elem_bytes, b_max)
        return int(torch.argmin(sizes)) + 1, sizes


def choose_b_host(counts_desc: np.ndarray, n: int, elem_bytes: int,
                  b_max: int) -> int:
    """``choose_b``'s B of a host histogram (sorted descending)."""
    sizes = estimated_file_sizes(torch.from_numpy(np.asarray(counts_desc)),
                                 n, elem_bytes, b_max)
    return int(torch.argmin(sizes)) + 1


__all__ = ["cumsum_f32", "estimated_file_sizes", "choose_b", "choose_b_host"]
