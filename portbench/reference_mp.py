"""Plain reference of parallel NUMARCK's rank ownership (arXiv:1703.02438,
Sec. IV: block decomposition).

Written from the paper's decomposition and the documented block rule; it
imports nothing of the program under test.

A step of ``n`` elements is split over ``R`` ranks in contiguous shards
of ``ln = ceil(n / R)`` elements (the last one padded).  The index table
is cut into blocks of ``block_elems(B)`` indices: ``block_bytes * 8 / B``
rounded down to whole 32-index words, at least one word.  A block longer
than a shard shrinks to ``ln // 32 * 32`` indices, so that every rank
starts at least one block.  Rank s owns, and alone stores, the blocks
that start in ``[s * ln, (s + 1) * ln)``; the block that crosses a shard
boundary belongs to the rank it starts in.
"""
from __future__ import annotations

from typing import List, Tuple

WORD = 32


def block_elems(b_bits: int, block_bytes: int) -> int:
    """Indices a block holds before any shrink: whole 32-index words."""
    return max(WORD, block_bytes * 8 // b_bits // WORD * WORD)


def layout(n: int, ranks: int, b_bits: int, block_bytes: int
           ) -> Tuple[int, int, int]:
    """(shard length, block length, number of blocks) of one step."""
    ln = -(-n // ranks)
    be = block_elems(b_bits, block_bytes)
    if be > ln:
        be = ln // WORD * WORD
        if be < WORD:
            raise ValueError(f"a shard of {ln} elements holds no whole "
                             f"{WORD}-index word")
    return ln, be, -(-n // be)


def owned(n: int, ranks: int, b_bits: int, block_bytes: int
          ) -> List[Tuple[int, int]]:
    """(first block, number of blocks) that each rank owns, in rank
    order: the blocks whose first index lies in its shard."""
    ln, be, nblocks = layout(n, ranks, b_bits, block_bytes)

    def first(s):           # first block starting at or after s * ln
        return min(-(-(s * ln) // be), nblocks)

    return [(first(s), first(s + 1) - first(s)) for s in range(ranks)]


__all__ = ["block_elems", "layout", "owned"]
