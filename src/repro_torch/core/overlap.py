"""Double-buffer discipline of the overlapped compressor.

One background worker thread, at most two tasks in flight (one executing
+ one queued); ``submit`` blocks past the bound so host memory stays
bounded regardless of stream length, and completed futures are
``.result()``-ed on the next submit/flush so background failures surface
instead of vanishing with their Future.  Worker exceptions carry the
submit-side ``label`` (stage and step) appended to their message.

The port's copy of the reference's ``core/overlap.py`` without telemetry
and without the wedged-worker timeout (no caller of the port sets one).
"""
from __future__ import annotations

from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Deque, Optional, Tuple


def _attach_context(e: BaseException, queue: str, label: str):
    """Append ``[queue worker: label]`` to the exception message (type and
    traceback preserved; attached once)."""
    if getattr(e, "_overlap_context", None) is not None:
        return
    ctx = f"[{queue} worker: {label}]"
    try:
        e._overlap_context = ctx  # type: ignore[attr-defined]
        if e.args and isinstance(e.args[0], str):
            e.args = (f"{e.args[0]} {ctx}",) + e.args[1:]
        else:
            e.args = e.args + (ctx,)
    except Exception:  # exotic exception types: context stays best-effort
        pass


class FinalizeQueue:
    """Bounded single-worker task queue with an inline (serial) mode.

    With ``overlap=False`` every ``submit`` runs the callable inline and
    returns an already-resolved Future, so callers never branch on the
    mode.
    """

    def __init__(self, overlap: bool, name: str = "finalize",
                 max_in_flight: int = 2):
        self.overlap = overlap
        self._name = name
        self._max = max(1, max_in_flight)
        self._ex: Optional[ThreadPoolExecutor] = None
        self._pending: Deque[Tuple[Future, str]] = deque()

    def _drain_one(self) -> None:
        f, _ = self._pending.popleft()
        f.result()

    def submit(self, fn, *args, label: Optional[str] = None) -> Future:
        """Run ``fn(*args)`` (inline or on the worker); ``label`` names the
        task in exception context."""
        label = label or getattr(fn, "__name__", "task")
        if not self.overlap:
            f: Future = Future()
            try:
                f.set_result(fn(*args))
            except BaseException as e:  # noqa: BLE001 -- mirror executor
                _attach_context(e, self._name, label)
                f.set_exception(e)
            return f
        while self._pending and self._pending[0][0].done():
            self._drain_one()
        while len(self._pending) >= self._max:
            self._drain_one()
        if self._ex is None:
            self._ex = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix=self._name)

        def run():
            try:
                return fn(*args)
            except BaseException as e:  # noqa: BLE001 -- context, re-raise
                _attach_context(e, self._name, label)
                raise

        f = self._ex.submit(run)
        self._pending.append((f, label))
        return f

    def flush(self):
        """Block until every in-flight task has completed (re-raises the
        first background exception, if any)."""
        while self._pending:
            self._drain_one()

    def close(self):
        try:
            self.flush()
        finally:
            if self._ex is not None:
                self._ex.shutdown(wait=True)
                self._ex = None


__all__ = ["FinalizeQueue"]
