"""The benchmark's own temporal data sets, made on the device from a seed.

A frozen torch copy of the statistics that the repository's data spec
gives the paper's Table 1 corpora (arXiv:1703.02438): a power-law
correlated field (spectral slope ``slope``) offset from zero, evolved by
element-wise multiplicative changes of volatility ``vol``, with a share
``jump_frac`` of elements jumping by ``1 + N(0, 1)`` each step and a share
``static_frac`` of cells that barely change.  The values differ from the
program's NumPy generator; the statistics are the same.  Everything is
drawn from one ``torch.Generator`` on the given device in a few large
calls, so the same seed gives the same steps on the same card.

Imports torch only: neither the program nor its reference package.
"""
from __future__ import annotations

from typing import List, Sequence

import torch


def correlated_field(gen: torch.Generator, shape: Sequence[int],
                     slope: float, device) -> torch.Tensor:
    """Unit-variance random field with a power-law spectrum (float32)."""
    white = torch.randn(tuple(shape), generator=gen, device=device)
    f = torch.fft.rfftn(white)
    axes = [torch.fft.fftfreq(n, device=device) for n in shape[:-1]]
    axes.append(torch.fft.rfftfreq(shape[-1], device=device))
    k2 = torch.zeros(f.shape, device=device)
    for i, g in enumerate(axes):
        view = [1] * len(shape)
        view[i] = g.numel()
        k2 = k2 + g.reshape(view) ** 2
    k = k2.sqrt()
    k.view(-1)[0] = 1.0
    f = f * k.pow(slope)
    out = torch.fft.irfftn(f, s=tuple(shape))
    return (out - out.mean()) / (out.std() + 1e-9)


def make_pool(spec: dict, steps: int, seed: int, device) -> List[torch.Tensor]:
    """``steps`` consecutive snapshots of the data set ``spec`` (a
    configuration's ``shape``, ``dtype`` and ``assumed`` statistics), as
    tensors on ``device``.  Step 0 is the field itself; each later step is
    the one before times its change field."""
    st = spec["assumed"]
    shape = tuple(spec["shape"])
    dtype = getattr(torch, spec["dtype"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    field = (correlated_field(gen, shape, st["slope"], device)
             + st["offset"]).to(dtype)
    static = torch.rand(shape, generator=gen, device=device) \
        < st["static_frac"]
    pool = [field]
    for _ in range(steps - 1):
        change = 1.0 + st["vol"] * correlated_field(gen, shape, st["slope"],
                                                    device)
        still = 1.0 + 1e-6 * torch.randn(shape, generator=gen, device=device)
        change = torch.where(static, still, change)
        jumps = torch.rand(shape, generator=gen, device=device) \
            < st["jump_frac"]
        leap = 1.0 + torch.randn(shape, generator=gen, device=device)
        change = torch.where(jumps, leap, change)
        field = (field * change.to(dtype)).to(dtype)
        pool.append(field)
    return pool
