"""Global scan-unroll switch (the port of the reference's
``models/unroll.py``).

The reference passes ``scan_unroll()`` as ``lax.scan``'s ``unroll=`` so
that XLA's cost analysis, which counts a while-loop body once, sees every
layer when its cost model is validated.  The port has no scan to unroll:
its layers run in a Python loop (``models/lm.py``), and so do the SSD's
chunks (``models/ssm.py``), so every layer's operations reach the op
counter of ``launch/cost_model.py`` as they are.  Nothing in the port
reads the flag; the names are kept so that every reference export has a
port export.
"""
from __future__ import annotations

from contextlib import contextmanager

_FLAG = {"on": False}


def scan_unroll():
    """The reference's ``unroll=`` value: True under ``full_unroll``."""
    return True if _FLAG["on"] else 1


@contextmanager
def full_unroll():
    prev = _FLAG["on"]
    _FLAG["on"] = True
    try:
        yield
    finally:
        _FLAG["on"] = prev


__all__ = ["scan_unroll", "full_unroll"]
