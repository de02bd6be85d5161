"""What a step must move, and the card's peaks: the roofline's yardstick.

A roofline share is the least time the card could take over the time its
kernels took.  The least time is the bytes the step cannot avoid moving
at the peak bandwidth; the step's few operations a byte never make it
compute-bound.  The bytes follow from the step's shape, B and exception
count alone, whatever implements it: each input read once, each output
written once.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet: 80 GB of HBM3 at 3.35 TB/s (dense rates,
# 700 W).  A card set below 700 W runs slower; the result line names it.
HBM_BYTES_PER_S = 3.35e12


def compress_step_bytes(n: int, itemsize: int, b_bits: int,
                        n_exc: int) -> int:
    """A delta step's encode: the previous reconstruction and the new step
    read once, the B-bit index table and the exception values written
    once."""
    return 2 * n * itemsize + n * b_bits // 8 + n_exc * itemsize


def read_step_bytes(n: int, itemsize: int, stored: int, n_exc: int,
                    anchor: bool) -> int:
    """A step's read: its stored index (or anchor) bytes and exception
    values read once, the previous reconstruction read once (deltas
    only), the reconstruction written once."""
    prev = 0 if anchor else n * itemsize
    return stored + n_exc * itemsize + prev + n * itemsize
