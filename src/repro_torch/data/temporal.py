"""Synthetic temporal scientific datasets mimicking the paper's corpora.

A numpy copy of the reference's ``data/temporal.py``: the same seed gives
the same series in both packages.

The paper evaluates on FLASH Sedov/Stir (hydrodynamic turbulence), ASR
(Arctic reanalysis) and CMIP3 (coupled climate).  Real corpora are not
available offline, so we synthesize fields with the statistical properties
the paper leans on:

  * spatial correlation -- power-law spectrum (turbulence-like; `slope`)
  * temporal coherence  -- element-wise multiplicative evolution with
    volatility `vol` (small change ratios, the property NUMARCK exploits)
  * intermittency      -- a fraction of elements jumps (incompressible)
  * entropy control    -- `vol` scales the change-ratio spread; stir-like
    fields use high vol (hard to compress), sedov-like fields mostly-static
    cells (ratios under |E| -> the paper's ZLIB 'Sedov effect', Fig. 17)

Each generator yields float32/float64 arrays of the paper's per-variable
shapes (scaled down by `scale` to fit CPU memory).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np


def _correlated_field(rng, shape, slope=-1.7):
    """Random field with power-law spectrum via FFT filtering."""
    white = rng.standard_normal(shape)
    f = np.fft.rfftn(white)
    freqs = np.meshgrid(*[np.fft.fftfreq(n) for n in shape[:-1]]
                        + [np.fft.rfftfreq(shape[-1])], indexing="ij")
    k = np.sqrt(sum(g ** 2 for g in freqs))
    k[tuple([0] * len(shape))] = 1.0
    f *= k ** slope
    out = np.fft.irfftn(f, shape, axes=tuple(range(len(shape))))
    out = (out - out.mean()) / (out.std() + 1e-9)
    return out


@dataclass
class TemporalFieldSpec:
    name: str
    shape: Tuple[int, ...]
    dtype: str
    vol: float            # change-ratio volatility per step
    jump_frac: float      # fraction of intermittent jumps per step
    static_frac: float    # fraction of cells with ~zero change (sedov-like)
    offset: float = 2.0   # keeps values away from 0
    slope: float = -1.7


# paper Table 1 analogues (scaled: `scale` divides each dim)
SPECS = {
    # Sedov: double precision, 80% of points change less than |E|
    "sedov": TemporalFieldSpec("sedov", (165, 32, 32), "float64",
                               vol=5e-3, jump_frac=0.002, static_frac=0.8),
    # Stir: fully developed turbulence, high entropy, hard to compress
    "stir": TemporalFieldSpec("stir", (64, 157, 157), "float32",
                              vol=2e-2, jump_frac=0.01, static_frac=0.0),
    # ASR: atmospheric reanalysis (wind speed UU-like)
    "asr": TemporalFieldSpec("asr", (29, 320, 320), "float32",
                             vol=8e-3, jump_frac=0.005, static_frac=0.1),
    # CMIP: ocean current velocity (UVEL-like), smooth + repetitive
    "cmip": TemporalFieldSpec("cmip", (42, 360, 240), "float32",
                              vol=4e-3, jump_frac=0.002, static_frac=0.3),
}


def generate_series(spec_name: str, n_iterations: int = 5, seed: int = 0,
                    scale: int = 1) -> Iterator[np.ndarray]:
    """Yield `n_iterations` temporally-coherent snapshots."""
    spec = SPECS[spec_name]
    shape = tuple(max(4, s // scale) for s in spec.shape)
    rng = np.random.default_rng(seed)
    base = _correlated_field(rng, shape, spec.slope) + spec.offset
    field = base.astype(spec.dtype)
    static_mask = rng.random(shape) < spec.static_frac
    yield field.copy()
    for _ in range(n_iterations - 1):
        # spatially-correlated multiplicative change
        change = 1.0 + spec.vol * _correlated_field(rng, shape, spec.slope)
        change = np.where(static_mask,
                          1.0 + rng.standard_normal(shape) * 1e-6, change)
        jumps = rng.random(shape) < spec.jump_frac
        change = np.where(jumps, 1.0 + rng.standard_normal(shape), change)
        field = (field * change).astype(spec.dtype)
        yield field.copy()


def dataset_bytes(spec_name: str, scale: int = 1) -> int:
    spec = SPECS[spec_name]
    shape = tuple(max(4, s // scale) for s in spec.shape)
    # a dataset's dtype is a numpy name, float32 or float64
    # repro-lint: disable=dtype-hazard
    return int(np.prod(shape)) * np.dtype(spec.dtype).itemsize


__all__ = ["SPECS", "TemporalFieldSpec", "generate_series", "dataset_bytes"]
