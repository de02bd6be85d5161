"""Integrity errors raised by the decode path (copy of the reference's
``faults.errors.IntegrityError``)."""
from __future__ import annotations


class IntegrityError(ValueError):
    """A persisted artifact failed verification (truncation, a codec
    stream that does not decode).  The read path raises this instead of
    returning silently wrong data."""


__all__ = ["IntegrityError"]
