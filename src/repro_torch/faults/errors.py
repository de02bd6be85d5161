"""Structured error taxonomy for the integrity + fault-tolerance layer
(copy of the reference's ``faults/errors.py``).

Hierarchy (chosen so existing callers keep working):

  * :class:`IntegrityError` subclasses ``ValueError``, so
    ``except ValueError`` / ``pytest.raises(ValueError)`` call sites
    catch it, while new code can catch the precise class.
  * :class:`CommitTimeoutError` subclasses ``TimeoutError``; it carries
    the structured rollback report of a manifest commit.
  * :class:`InjectedFault` subclasses ``RuntimeError`` and is raised
    ONLY by :mod:`repro_torch.faults.inject` -- seeing it outside a
    ``REPRO_FAULTS``-configured run is itself a bug.

Every class renders a message that names the damaged artifact (file,
variable, block index, expected/actual digest) so a fleet log line is
actionable without re-running under a debugger.
"""
from __future__ import annotations

from typing import List, Optional


class IntegrityError(ValueError):
    """A persisted artifact failed verification (checksum mismatch,
    truncation, unparseable header).  The read path raises this instead
    of returning silently wrong data."""


class CorruptBlockError(IntegrityError):
    """One variable (or one block of one variable) inside an NCK
    container failed its CRC-32 check."""

    def __init__(self, path: str, variable: str, block: Optional[int],
                 expected: int, actual: int):
        self.path = path
        self.variable = variable
        self.block = block
        self.expected = int(expected)
        self.actual = int(actual)
        where = (f"variable {variable!r}" if block is None
                 else f"variable {variable!r} block {block}")
        super().__init__(
            f"{path}: {where} checksum mismatch: expected "
            f"crc32=0x{self.expected:08x}, got 0x{self.actual:08x} "
            "(corrupt or torn write; refusing to decode)")


class CorruptShardError(IntegrityError):
    """A per-rank shard file referenced by an NCKM manifest is missing
    its recorded size/checksum, or failed structural verification."""

    def __init__(self, path: str, shard: str, rank: int, reason: str):
        self.path = path
        self.shard = shard
        self.rank = rank
        self.reason = reason
        super().__init__(
            f"manifest {path}: shard file {shard} (rank {rank}) failed "
            f"verification: {reason}")


class CommitTimeoutError(TimeoutError):
    """Rank 0's manifest commit exhausted its deadline.  ``report``
    carries the structured rollback state: which ranks never published,
    which published files were quarantined as corrupt, and the
    generation the logical file rolled back to (the previous durable
    manifest is untouched, byte for byte)."""

    def __init__(self, message: str, report: Optional[dict] = None):
        super().__init__(message)
        self.report = report or {}

    @property
    def missing_ranks(self) -> List[int]:
        return list(self.report.get("missing_ranks", []))

    @property
    def quarantined(self) -> List[str]:
        return list(self.report.get("quarantined", []))


class InjectedFault(RuntimeError):
    """Deliberate failure raised by an active fault-injection plan
    (``REPRO_FAULTS=`` / ``faults.inject.configure``)."""

    def __init__(self, site: str, detail: str = ""):
        self.site = site
        super().__init__(f"injected fault at site {site!r}"
                         + (f": {detail}" if detail else ""))


__all__ = ["IntegrityError", "CorruptBlockError", "CorruptShardError",
           "CommitTimeoutError", "InjectedFault"]
