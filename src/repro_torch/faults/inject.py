"""Deterministic fault injection: seedable failure points for the fleet
(copy of the reference's ``faults/inject.py``).

Activation: set ``REPRO_FAULTS`` in the environment (picked up at import
and by every spawned rank) or call :func:`configure` explicitly in
tests.  Disabled -- the default -- every site compiles down to a single
module-attribute check (``_PLAN is None``), the same "disabled is free"
discipline as the reference's telemetry.

Spec grammar (comma-separated entries)::

    REPRO_FAULTS = entry[,entry...]
    entry        = site['@'rank]['='value]['*'count]

``site``   one of :data:`SITES` below
``rank``   only fire on this fleet rank (default: every rank); matched
           against ``REPRO_PROCESS_ID`` at fire time, so one spec string
           handed to every spawned worker targets a single rank
``value``  site parameter (straggler seconds, torn-byte count, flip
           offset, ...); float
``count``  how many times the entry fires before exhausting (default 1)

Sites and what they do when they fire:

  ``rank_crash``            raise :class:`InjectedFault` (worker dies
                            mid-encode, before publishing its shard)
  ``straggler``             sleep ``value`` seconds (default 1.0)
  ``torn_shard``            truncate the next published ``.rank`` file
                            by ``value`` bytes (default 64) -- a torn
                            write that *looks* atomically published
  ``bitflip_shard``         XOR one bit of the next published ``.rank``
                            file at byte offset ``value`` (mod size)
  ``fsync_fail``            raise ``OSError`` from the publish fsync
  ``rename_fail``           raise ``OSError`` from the publish rename
  ``entropy_worker_death``  raise inside the entropy process-pool worker
                            (exercises the retire-and-degrade path)

Example -- rank 1 publishes a torn shard, rank 0 must quarantine it and
roll back::

    REPRO_FAULTS="torn_shard@1=64" python worker.py
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

from repro_torch.faults.errors import InjectedFault

ENV_FAULTS = "REPRO_FAULTS"

SITES = ("rank_crash", "straggler", "torn_shard", "bitflip_shard",
         "fsync_fail", "rename_fail", "entropy_worker_death")

# File-mangling sites only apply to per-rank shard publishes (the fleet
# write path under test), never to manifests or checkpoint files.
_SHARD_MARKER = ".rank"


class _Entry:
    __slots__ = ("site", "rank", "value", "remaining")

    def __init__(self, site: str, rank: Optional[int], value: Optional[float],
                 count: int):
        self.site = site
        self.rank = rank
        self.value = value
        self.remaining = count

    def matches(self, site: str) -> bool:
        if self.site != site or self.remaining <= 0:
            return False
        if self.rank is not None and self.rank != _current_rank():
            return False
        return True

    def take(self) -> None:
        self.remaining -= 1


def _current_rank() -> int:
    # Late-bound: spawned ranks set REPRO_PROCESS_ID after import time.
    try:
        return int(os.environ.get("REPRO_PROCESS_ID", "0"))
    except ValueError:
        return 0


class FaultPlan:
    """Parsed injection plan.  Deterministic: entries fire in spec order,
    each at most ``count`` times, rank-matched at fire time."""

    def __init__(self, spec: str):
        self.spec = spec
        self.entries: List[_Entry] = []
        self.fired: List[Dict] = []      # audit log for tests/reports
        for raw in spec.split(","):
            raw = raw.strip()
            if not raw:
                continue
            count = 1
            if "*" in raw:
                raw, c = raw.rsplit("*", 1)
                count = int(c)
            value: Optional[float] = None
            if "=" in raw:
                raw, v = raw.split("=", 1)
                value = float(v)
            rank: Optional[int] = None
            if "@" in raw:
                raw, r = raw.split("@", 1)
                rank = int(r)
            site = raw.strip()
            if site not in SITES:
                raise ValueError(
                    f"unknown fault site {site!r} in {ENV_FAULTS} spec "
                    f"(known: {', '.join(SITES)})")
            self.entries.append(_Entry(site, rank, value, count))

    def _claim(self, site: str) -> Optional[_Entry]:
        for e in self.entries:
            if e.matches(site):
                e.take()
                self.fired.append({"site": site, "rank": _current_rank(),
                                   "value": e.value})
                return e
        return None

    def fire(self, site: str, **ctx) -> None:
        e = self._claim(site)
        if e is None:
            return
        if site == "straggler":
            time.sleep(e.value if e.value is not None else 1.0)
            return
        if site in ("fsync_fail", "rename_fail"):
            raise OSError(f"injected {site} ({ctx.get('path', '?')})")
        raise InjectedFault(site, detail=", ".join(
            f"{k}={v}" for k, v in sorted(ctx.items())))

    def mangle_file(self, tmp: str, target: str) -> None:
        """Corrupt the not-yet-published tmp file of a ``.rank`` shard
        publish (torn / bit-flipped), so the damage rides the atomic
        rename exactly like real silent corruption would."""
        if _SHARD_MARKER not in os.path.basename(target):
            return
        e = self._claim("torn_shard")
        if e is not None:
            drop = int(e.value if e.value is not None else 64)
            size = os.path.getsize(tmp)
            with open(tmp, "r+b") as f:
                f.truncate(max(size - drop, 0))
            return
        e = self._claim("bitflip_shard")
        if e is not None:
            size = os.path.getsize(tmp)
            if size == 0:
                return
            off = int(e.value if e.value is not None else 0) % size
            with open(tmp, "r+b") as f:
                f.seek(off)
                b = f.read(1)
                f.seek(off)
                f.write(bytes([b[0] ^ 0x01]))


# One module-global plan slot (telemetry's registry-slot discipline):
# ``None`` means disabled, and every site entry point below is then a
# single attribute check -- no dict lookups, no string parsing.
_PLAN: Optional[FaultPlan] = None


def enabled() -> bool:
    return _PLAN is not None


def plan() -> Optional[FaultPlan]:
    return _PLAN


def configure(spec: Optional[str]) -> Optional[FaultPlan]:
    """Install (or, with ``None``/empty, clear) the process fault plan."""
    global _PLAN
    _PLAN = FaultPlan(spec) if spec else None
    return _PLAN


def reset() -> None:
    configure(None)


def fire(site: str, **ctx) -> None:
    """Injection point: no-op unless a plan entry matches ``site`` for
    the current rank.  May raise or sleep; see the module docstring."""
    if _PLAN is None:
        return
    _PLAN.fire(site, **ctx)


def mangle_file(tmp: str, target: str) -> None:
    """Shard-publish corruption hook (called by ``atomic_commit`` between
    fsync and rename); no-op unless a torn/bitflip entry is armed."""
    if _PLAN is None:
        return
    _PLAN.mangle_file(tmp, target)


# Environment pickup at import: spawned fleet ranks activate by env var
# alone, with no code changes in the worker.
configure(os.environ.get(ENV_FAULTS))

__all__ = ["ENV_FAULTS", "SITES", "FaultPlan", "enabled", "plan",
           "configure", "reset", "fire", "mangle_file"]
