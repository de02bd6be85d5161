"""repro-torch-lint command line.

``python -m repro_torch.analysis [paths...]`` (or the
``repro-torch-lint`` console script) runs every registered pass over the
given paths (default: ``src/repro_torch``), diffs against the committed
baseline (``repro-torch-lint.baseline.json``), and exits nonzero
iff *new* violations exist.  ``--write-baseline`` accepts the current
state; ``--select`` narrows to a comma-separated rule subset;
``--list-rules`` prints the catalogue.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from repro_torch.analysis import baseline as baseline_mod
from repro_torch.analysis.core import Violation, load_project
from repro_torch.analysis.registry import all_passes, get_pass

_DEFAULT_PATHS = ("src/repro_torch",)


def _find_root(start: str) -> str:
    """Nearest ancestor holding a baseline file or .git; else `start`."""
    cur = os.path.abspath(start)
    while True:
        if os.path.exists(os.path.join(cur, baseline_mod.DEFAULT_BASELINE)) \
                or os.path.isdir(os.path.join(cur, ".git")):
            return cur
        nxt = os.path.dirname(cur)
        if nxt == cur:
            return os.path.abspath(start)
        cur = nxt


def run_lint(paths: List[str], root: str,
             select: Optional[List[str]] = None) -> List[Violation]:
    """Run the (selected) passes over `paths`; returns raw violations
    (pre-baseline).  Paths may be files or directories."""
    project = load_project(paths, root=root)
    passes = ([get_pass(r) for r in select] if select
              else all_passes())
    out: List[Violation] = []
    for cls in passes:
        out.extend(cls().run(project))
    out.sort(key=lambda v: (v.path, v.line, v.rule))
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro-torch-lint",
        description="project-specific static analysis for the PyTorch "
                    "port (device residency, builds traced once, "
                    "concurrency, format closure, dtype hazards)")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/directories to lint (default: src/repro_torch)")
    ap.add_argument("--root", default=None,
                    help="repo root for relative paths and the baseline "
                         "(default: auto-detected)")
    ap.add_argument("--baseline", default=None,
                    help="baseline file (default: "
                         f"<root>/{baseline_mod.DEFAULT_BASELINE})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every violation, ignoring the baseline")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept the current violations into the baseline")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule subset to run")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for cls in all_passes():
            print(f"{cls.rule:28s} {cls.description}")
        return 0

    root = os.path.abspath(args.root) if args.root else _find_root(os.getcwd())
    paths = args.paths or [os.path.join(root, p) for p in _DEFAULT_PATHS]
    select = ([s.strip() for s in args.select.split(",") if s.strip()]
              if args.select else None)
    violations = run_lint(paths, root=root, select=select)

    bl_path = args.baseline or os.path.join(
        root, baseline_mod.DEFAULT_BASELINE)
    if args.write_baseline:
        baseline_mod.save(bl_path, violations)
        print(f"repro-torch-lint: wrote {len(violations)} accepted violation(s) "
              f"to {os.path.relpath(bl_path, root)}")
        return 0

    known = [] if args.no_baseline else baseline_mod.load(bl_path)
    new, stale = baseline_mod.diff(violations, known)

    for v in new:
        print(f"{v.path}:{v.line}: [{v.rule}] {v.message} "
              f"(in {v.scope})")
    for fp in stale:
        rule, path, scope, _msg = fp
        print(f"repro-torch-lint: stale baseline entry [{rule}] {path} "
              f"({scope}) -- fixed? regenerate with --write-baseline")
    n_accepted = len(violations) - len(new)
    print(f"repro-torch-lint: {len(new)} new violation(s), "
          f"{n_accepted} baselined, {len(stale)} stale baseline entr"
          f"{'y' if len(stale) == 1 else 'ies'}")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
