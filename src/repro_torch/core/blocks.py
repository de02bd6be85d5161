"""Index-table blocking + per-block entropy coding (paper Sec. IV-C).

The index table is split into fixed-element-count blocks, each entropy-
coded independently so that partial decompression only decodes the
overlapped blocks.  Packing and entropy coding live in the shared stage
modules (``core.pipeline``, ``core.entropy``); this module keeps the thin
block-level API of the reference's ``core/blocks.py``.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.core import entropy, packing
from repro_torch.core import pipeline as pipe


def block_slices(n: int, block_elems: int) -> List[Tuple[int, int]]:
    return pipe.block_slices(n, block_elems)


def deflate_blocks(idx: np.ndarray, b_bits: int, block_elems: int,
                   level: int = 6, codec: str = entropy.DEFAULT_CODEC,
                   parallel: bool = True):
    """Pack + entropy-code each block.
    Returns (blocks, raw_sizes, incomp_offsets)."""
    raws = pipe.pack_blocks_host(idx, b_bits, block_elems)
    blocks = entropy.compress_blocks(raws, codec=codec, level=level,
                                     parallel=parallel)
    raw_sizes = np.asarray([len(r) for r in raws], np.int64)
    marker = (1 << b_bits) - 1
    incomp_offsets = pipe.exception_offsets(
        np.asarray(idx).reshape(-1) == marker, block_elems)
    return blocks, raw_sizes, incomp_offsets


def inflate_block(blob: bytes, n_elems: int, b_bits: int,
                  codec: str = entropy.DEFAULT_CODEC) -> np.ndarray:
    packed = np.frombuffer(entropy.decompress_block(blob, codec),
                           dtype=np.uint8)
    return packing.unpack_indices_np(packed, n_elems, b_bits)


def zlib_ratio(blocks: List[bytes], raw_sizes: np.ndarray) -> float:
    """Average entropy compression ratio of the index table (paper
    Table 9); the name is the reference's, from its zlib-only days."""
    return pipe.entropy_ratio(blocks, raw_sizes)


__all__ = ["block_slices", "deflate_blocks", "inflate_block", "zlib_ratio"]
