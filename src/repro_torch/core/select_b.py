"""Auto-selection of the index length B (paper Sec. IV-B-2, Eq. 6).

    file_size(B) = 2^B * L  +  n * B / 8  +  n * alpha(B) * L

where alpha(B) is the incompressible ratio when keeping the top (2^B - 1)
candidate bins.  Computed in float32 on the host, as the reference does on
its device: the model is a 65,536-entry prefix sum and a few dozen flops.
"""
from __future__ import annotations

import torch


def estimated_file_sizes(counts_desc: torch.Tensor, n: int, elem_bytes: int,
                         b_max: int) -> torch.Tensor:
    """Eq. (6) for B in [1, b_max].  Returns float32 (b_max,) byte sizes.

    The prefix of the counts is summed in int64 and rounded to float32
    once.  The reference takes a float32 cumsum, whose every prefix is
    exact while n < 2^24, so the two agree exactly there; above 2^24 the
    reference's own value depends on its backend's summation order.
    """
    counts_desc = counts_desc.cpu()
    m = counts_desc.shape[0]
    cum = torch.cumsum(counts_desc.to(torch.int64), 0).to(torch.float32)
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
    """argmin_B file_size(B) (first minimum); returns (B, sizes (b_max,))."""
    sizes = estimated_file_sizes(counts_desc, n, elem_bytes, b_max)
    return int(torch.argmin(sizes)) + 1, sizes


__all__ = ["estimated_file_sizes", "choose_b"]
