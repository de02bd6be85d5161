"""Double-buffer discipline shared by every overlapped host stage.

The port's copy of the reference's ``core/overlap.py``.  The overlapped
compressors (``TemporalCompressor``, ``ShardedCompressor``,
``MultiProcessCompressor``) and the async checkpoint writer all follow
the same pattern: one background worker thread, at most two tasks in
flight (one executing + one queued), submit blocks past the bound so
host memory stays bounded regardless of stream length, and completed
futures are ``.result()``-ed on the next submit/flush so background
failures surface instead of vanishing with their Future.  This is that
pattern, once.

Observability (``repro_torch.obs``): every queue emits, under its own name,

  ``<name>.depth``          gauge   in-flight tasks after each submit
  ``<name>.queue_wait_s``   hist    submit -> worker-start latency
  ``<name>.stall_s``        counter time the *caller* blocked because the
                                    queue was full (the flush-stall the
                                    overlap is supposed to hide)
  ``<name>.task``           span    task execution on the worker lane
                                    (records the failure when it raises)

and worker exceptions carry the stage/step context of the task that died:
the submit-side ``label`` is appended to the exception message (type and
traceback preserved), so a failed background finalize names which step
and stage failed instead of re-raising a bare Future error.

Fault tolerance: construct with ``timeout=<seconds>`` and every wait on a
background task is bounded.  A wedged worker surfaces as a ``TimeoutError``
naming the stuck task's ``label`` -- instead of hanging the driver forever
-- and the worker thread is retired and replaced (shutdown without
waiting, pending futures cancelled; the next submit gets a fresh worker),
the same discipline ``core.entropy`` applies to wedged process pools.
"""
from __future__ import annotations

import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Deque, Optional, Tuple

from repro_torch.obs import telemetry


def _attach_context(e: BaseException, queue: str, label: str):
    """Append ``[queue worker: label]`` to the exception message so the
    failing stage/step is visible wherever the Future is re-raised.  The
    exception type, args structure and traceback are preserved (the
    original message stays a prefix, so ``pytest.raises(match=...)`` on
    it keeps working); double-attachment on re-surfaced futures is
    suppressed."""
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
    returns an already-resolved Future -- identical interface, serial
    semantics, so callers never branch on the mode.

    ``timeout`` (seconds, ``None`` = wait forever, the historical
    behaviour) bounds every internal wait on a background task: drain on
    submit, the full-queue stall, and ``flush``.  On expiry the worker is
    retired (it may be wedged in a C call that ignores interrupts) and a
    ``TimeoutError`` naming the stuck task's label is raised.
    """

    def __init__(self, overlap: bool, name: str = "finalize",
                 max_in_flight: int = 2, timeout: Optional[float] = None):
        self.overlap = overlap
        self._name = name
        self._max = max(1, max_in_flight)
        self._timeout = timeout
        self._ex: Optional[ThreadPoolExecutor] = None
        self._pending: Deque[Tuple[Future, str]] = deque()

    def _retire_worker(self):
        """Abandon a wedged worker thread (entropy-pool discipline:
        shutdown without waiting, cancel what never started, forget the
        executor so the next submit builds a fresh one)."""
        if self._ex is not None:
            self._ex.shutdown(wait=False, cancel_futures=True)
            self._ex = None
        self._pending.clear()

    def _drain_one(self) -> None:
        """Resolve the oldest pending task, bounded by ``timeout``."""
        f, label = self._pending.popleft()
        try:
            f.result(timeout=self._timeout)
        except _FutureTimeout:
            # py3.10: concurrent.futures.TimeoutError is NOT the builtin.
            self._pending.appendleft((f, label))
            self._retire_worker()
            raise TimeoutError(
                f"{self._name} worker wedged: task [label={label}] did not "
                f"complete within {self._timeout}s; worker retired and "
                "replaced") from None

    def submit(self, fn, *args, label: Optional[str] = None) -> Future:
        """Run ``fn(*args)`` (inline or on the worker).  ``label`` names
        the task for telemetry spans and exception context -- pass the
        stage/step (e.g. ``"finalize step 12"``) so background failures
        are attributable."""
        label = label or getattr(fn, "__name__", "task")
        if not self.overlap:
            f: Future = Future()
            try:
                with telemetry.span(f"{self._name}.task", label=label):
                    f.set_result(fn(*args))
            except BaseException as e:  # noqa: BLE001 -- mirror executor
                _attach_context(e, self._name, label)
                f.set_exception(e)
            return f
        # .result() on completed futures too: a failed background task must
        # surface on the next submit/flush, not vanish with its Future.
        while self._pending and self._pending[0][0].done():
            self._drain_one()
        if len(self._pending) >= self._max:
            # Queue full: the caller stalls here until the oldest task
            # drains -- the stall the overlap exists to hide, so meter it.
            t_stall = time.perf_counter()
            while len(self._pending) >= self._max:
                self._drain_one()
            telemetry.counter(f"{self._name}.stall_s",
                              time.perf_counter() - t_stall)
        if self._ex is None:
            self._ex = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix=self._name)
        t_submit = time.perf_counter()

        def run():
            telemetry.histo(f"{self._name}.queue_wait_s",
                            time.perf_counter() - t_submit)
            try:
                with telemetry.span(f"{self._name}.task", label=label):
                    return fn(*args)
            except BaseException as e:  # noqa: BLE001 -- context then re-raise
                _attach_context(e, self._name, label)
                raise

        f = self._ex.submit(run)
        self._pending.append((f, label))
        telemetry.gauge(f"{self._name}.depth", len(self._pending))
        return f

    def flush(self):
        """Barrier: block until every in-flight task has completed
        (re-raises the first background exception, if any; with a
        ``timeout`` configured, a wedged task raises a labeled
        TimeoutError instead of blocking forever)."""
        with telemetry.span(f"{self._name}.flush",
                            pending=len(self._pending)):
            while self._pending:
                self._drain_one()

    # Checkpoint manager calls this name; keep both as the public barrier.
    wait = flush

    def close(self):
        try:
            self.flush()
        finally:
            if self._ex is not None:
                self._ex.shutdown(wait=True)
                self._ex = None


__all__ = ["FinalizeQueue"]
