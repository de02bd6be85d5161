"""Committed-baseline handling for the port's lint (the reference's
``analysis/baseline.py`` with the port's own file).

The baseline is the reviewed list of violations the repo has accepted
(intentional boundary syncs, constructor-time jit stores with a
documented lifetime).  A fingerprint deliberately excludes line numbers
-- ``(rule, path, scope, message)`` -- so unrelated edits above a
baselined site don't churn the file; moving the code to a different
function or changing the message retires the entry.

``diff`` returns both directions: *new* violations (fail CI) and *stale*
baseline entries (the accepted violation no longer exists -- reported so
the baseline can be re-tightened, but not a failure: a lint run must
never go red because someone fixed a bug).
"""
from __future__ import annotations

import json
from typing import Dict, List, Sequence, Tuple

from repro_torch.analysis.core import Violation

DEFAULT_BASELINE = "repro-torch-lint.baseline.json"

Fingerprint = Tuple[str, str, str, str]


def save(path: str, violations: Sequence[Violation]) -> None:
    entries = sorted({v.fingerprint() for v in violations})
    payload = {
        "comment": "accepted repro-torch-lint violations; regenerate "
                   "with `python -m repro_torch.analysis --write-baseline`",
        "entries": [
            {"rule": r, "path": p, "scope": s, "message": m}
            for (r, p, s, m) in entries
        ],
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")


def load(path: str) -> List[Fingerprint]:
    try:
        with open(path, "r", encoding="utf-8") as fh:
            payload = json.load(fh)
    except FileNotFoundError:
        return []
    out: List[Fingerprint] = []
    for e in payload.get("entries", []):
        out.append((e["rule"], e["path"], e["scope"], e["message"]))
    return out


def diff(violations: Sequence[Violation],
         baseline: Sequence[Fingerprint],
         ) -> Tuple[List[Violation], List[Fingerprint]]:
    """(new_violations, stale_baseline_entries).

    Fingerprints are counted, not set-matched: two *new* unlabeled
    submits in the same scope with the same message are two findings,
    and a baseline entry absorbs exactly as many occurrences as were
    accepted when it was written (one per entry -- ``save`` dedups, so
    an entry absorbs all same-fingerprint occurrences; the distinction
    matters only for hand-edited baselines, where dropping an entry
    surfaces every occurrence again).
    """
    accepted: Dict[Fingerprint, bool] = {fp: False for fp in baseline}
    new: List[Violation] = []
    for v in violations:
        fp = v.fingerprint()
        if fp in accepted:
            accepted[fp] = True
        else:
            new.append(v)
    stale = [fp for fp, seen in accepted.items() if not seen]
    return new, stale
