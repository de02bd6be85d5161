"""Pass: retry-discipline.

Every retry/poll loop in ``src/repro_torch`` must be *bounded*: a fleet that
waits on a crashed rank, a wedged worker, or a file that will never
appear must surface a structured timeout, not spin forever.  The
sanctioned shape is ``repro_torch.faults.retry.Backoff`` -- a bounded attempt
count (or a deadline via ``sleep_until``) with growing, jittered delays
-- and every loop that sleeps must be able to *stop*.

The check: a ``while`` loop whose body calls ``time.sleep`` must contain
at least one exit edge -- ``break``, ``return`` or ``raise`` -- inside
the loop body (exits nested in inner function definitions do not count).
A sleep-loop with no exit edge can only terminate via its test
expression, and when that test is the constant ``True`` (or the loop
otherwise never re-checks a deadline) the process hangs unboundedly on
any lost wakeup.  Conservatively, *any* sleeping ``while`` with no
break/return/raise is flagged: even a ``while not done():`` shape should
raise on a deadline rather than trust the condition to eventually flip.

Suppress intentionally-infinite daemons with
``# repro-lint: disable=retry-discipline`` and a justification.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import LintPass, SourceFile, call_name
from repro_torch.analysis.registry import register_pass


def _body_nodes(loop: ast.While):
    """Loop-body nodes, not descending into nested function defs (an
    inner callback's `return` does not exit the loop)."""
    stack = list(loop.body) + list(loop.orelse)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


@register_pass
class RetryDisciplinePass(LintPass):
    rule = "retry-discipline"
    description = ("retry/poll loops are bounded: a while-loop that "
                   "time.sleep()s must break, return or raise")

    def check_file(self, sf: SourceFile) -> None:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.While):
                continue
            sleeps = False
            has_exit = False
            for sub in _body_nodes(node):
                if isinstance(sub, ast.Call) \
                        and (call_name(sub) or "") == "time.sleep":
                    sleeps = True
                elif isinstance(sub, (ast.Break, ast.Return, ast.Raise)):
                    has_exit = True
            if sleeps and not has_exit:
                self.emit(
                    sf, node.lineno,
                    "unbounded retry loop: `while` body sleeps but has no "
                    "break/return/raise -- bound it with "
                    "faults.retry.Backoff (attempt count or deadline) and "
                    "raise a structured timeout")
