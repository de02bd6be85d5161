"""Phase 3 bit-packing: B-bit indices <-> byte streams (paper Sec. IV-C).

Layout: little-endian bitstream, LSB-first -- element j occupies stream bits
[j*B, (j+1)*B); stream bit t lives at bit (t % 8) of byte (t // 8).  Each
index-table *block* is packed independently and byte-aligned.

Two implementations: numpy (host finalize / decompression path, copied
from the reference's ``core/packing.py``) and plain torch
(:func:`pack_indices`, the plain version of the bit-pack kernel in
``kernels.bitpack``: the same 32-bit words, held in int64 because CPU
``torch.uint32`` has no shifts or adds).
"""
from __future__ import annotations

import numpy as np
import torch

GROUP = 32              # indices per word group (32*B bits = B words)
_WORD_MASK = 0xFFFFFFFF


def packed_nbytes(n: int, b_bits: int) -> int:
    return (n * b_bits + 7) // 8


def pack_indices_np(idx: np.ndarray, b_bits: int) -> np.ndarray:
    idx = np.asarray(idx, dtype=np.int64)
    bits = ((idx[:, None] >> np.arange(b_bits)) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(-1), bitorder="little")


def unpack_indices_np(packed: np.ndarray, n: int, b_bits: int) -> np.ndarray:
    bits = np.unpackbits(np.asarray(packed, np.uint8), bitorder="little")
    bits = bits[: n * b_bits].reshape(n, b_bits).astype(np.int64)
    return (bits << np.arange(b_bits)).sum(axis=-1).astype(np.int32)


def pack_indices(idx: torch.Tensor, b_bits: int) -> torch.Tensor:
    """(n,) int32, n % 32 == 0 -> (n // 32 * B,) uint32 words.

    Word w of group g holds stream bits [32w, 32w + 32) of the group's
    32*B-bit stream; viewed as little-endian bytes the words equal
    ``pack_indices_np`` of the same indices.
    """
    n = idx.shape[0]
    if n % GROUP:
        raise ValueError(f"pack_indices needs n % {GROUP} == 0, got n={n}")
    vals = idx.reshape(-1, GROUP).to(torch.int64) & ((1 << b_bits) - 1)
    words = torch.zeros((vals.shape[0], b_bits), dtype=torch.int64,
                        device=idx.device)
    for j in range(GROUP):
        bit0 = j * b_bits
        w, s = bit0 // 32, bit0 % 32
        words[:, w] |= (vals[:, j] << s) & _WORD_MASK
        if s + b_bits > 32:                      # spills into the next word
            words[:, w + 1] |= vals[:, j] >> (32 - s)
    return words.reshape(-1).to(torch.uint32)


__all__ = ["GROUP", "packed_nbytes", "pack_indices_np", "unpack_indices_np",
           "pack_indices"]
