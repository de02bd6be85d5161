"""Pass: concurrency-discipline.

Three contracts of the port's host runtime (``core/overlap.py``,
``core/entropy.py``, ``obs/telemetry.py``), one rule id, as in the
reference:

  1. **No blocking while holding a registry/pool lock.**  The telemetry
     ``Registry._lock`` and the entropy ``_pool_lock`` serialize every
     hot-path writer (pool workers, overlap workers, the main thread); a
     ``Future.result()``, pool dispatch, a device synchronize or any
     ``torch.*`` call (a device dispatch) inside a ``with <lock>:`` body
     turns a bounded critical section into a pipeline-wide stall (and
     ``_pool_lock`` + process-pool dispatch can deadlock outright).
     Flags blocking calls inside ``with`` blocks whose context expression
     ends in ``_lock``.

  2. **Process-pool dispatch only behind a ``holds_gil`` check.**  The
     forked ``ProcessPoolExecutor`` exists solely because GIL-holding
     codecs get nothing from threads; any function that touches
     ``_shared_proc_pool`` must test ``holds_gil`` somewhere (a fork
     after CUDA init is safe only for the host codecs).

  3. **Every FinalizeQueue.submit names its task.**  Background-failure
     attribution ("finalize step 12") only works when every submit
     passes ``label=``.  Receivers are recognized by the
     ``FinalizeQueue(...)`` construction in the same module or the
     ``_q`` naming convention.
"""
from __future__ import annotations

import ast
from typing import Set

from repro_torch.analysis.core import (LintPass, SourceFile, call_name,
                                 dotted_name, names_in)
from repro_torch.analysis.registry import register_pass

# Calls that block (or dispatch work that must complete) -- forbidden
# while holding a `*_lock`.
_BLOCKING_METHODS = {"result", "submit", "map", "shutdown",
                     "synchronize", "join", "acquire"}
_BLOCKING_CALLS = {"torch.cuda.synchronize", "time.sleep"}
# device dispatch inside a lock is a stall too: any torch.* call.
_DEVICE_PREFIXES = ("torch.",)


def _queue_receivers(sf: SourceFile) -> Set[str]:
    """Names holding a FinalizeQueue in this module: anything assigned
    from ``FinalizeQueue(...)`` plus the ``_q`` convention."""
    out: Set[str] = {"_q", "self._q"}
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            cn = call_name(node.value)
            if cn and cn.rsplit(".", 1)[-1] == "FinalizeQueue":
                for t in node.targets:
                    d = dotted_name(t)
                    if d:
                        out.add(d)
                        if d.startswith("self."):
                            out.add(d[len("self."):])
    return out


@register_pass
class ConcurrencyPass(LintPass):
    rule = "concurrency-discipline"
    description = ("no blocking under *_lock, holds_gil-gated process "
                   "pools, labelled FinalizeQueue submits")

    def check_file(self, sf: SourceFile) -> None:
        self._check_lock_blocks(sf)
        self._check_proc_pool_gating(sf)
        self._check_submit_labels(sf)

    # ---------------------------------------------- 1. with-lock bodies
    def _check_lock_blocks(self, sf: SourceFile) -> None:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.With):
                continue
            lock_names = [dotted_name(item.context_expr)
                          for item in node.items]
            if not any(n and n.rsplit(".", 1)[-1].endswith("_lock")
                       for n in lock_names):
                continue
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    if not isinstance(sub, ast.Call):
                        continue
                    cn = call_name(sub)
                    blocking = (
                        cn in _BLOCKING_CALLS
                        or (cn and cn.startswith(_DEVICE_PREFIXES))
                        or (isinstance(sub.func, ast.Attribute)
                            and sub.func.attr in _BLOCKING_METHODS))
                    if blocking:
                        self.emit(sf, sub.lineno,
                                  f"blocking call `{cn or sub.func.attr}` "
                                  "while holding a lock "
                                  f"(`with {lock_names[0]}:`)")

    # ------------------------------------- 2. process-pool holds_gil gate
    def _check_proc_pool_gating(self, sf: SourceFile) -> None:
        for fi in sf.functions:
            # The accessor itself (and the retire path) may touch the
            # pool unconditionally; dispatchers must gate on holds_gil.
            if fi.name.startswith(("_shared_proc_pool", "_retire_proc_pool")):
                continue
            touches = [n for n in ast.walk(fi.node)
                       if isinstance(n, (ast.Name, ast.Attribute))
                       and (dotted_name(n) or "").rsplit(".", 1)[-1]
                       == "_shared_proc_pool"]
            if not touches:
                continue
            gated = any("holds_gil" in {nm.rsplit(".", 1)[-1]
                                        for nm in names_in(t.test)}
                        for t in ast.walk(fi.node)
                        if isinstance(t, (ast.If, ast.IfExp)))
            if not gated:
                self.emit(sf, touches[0].lineno,
                          f"`{fi.name}` dispatches to the process pool "
                          "without a `holds_gil` check (thread-safe "
                          "codecs must stay on the thread pool)")

    # ------------------------------------------- 3. labelled queue submits
    def _check_submit_labels(self, sf: SourceFile) -> None:
        queues = _queue_receivers(sf)
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            if not (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "submit"):
                continue
            recv = dotted_name(node.func.value)
            if recv is None or recv not in queues:
                continue
            if not any(kw.arg == "label" for kw in node.keywords):
                self.emit(sf, node.lineno,
                          f"`{recv}.submit(...)` without `label=`: "
                          "background failures lose their stage/step "
                          "attribution")
