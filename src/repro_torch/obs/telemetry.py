"""Near-zero-overhead pipeline telemetry: spans, counters, gauges, hists.

The port's own copy of the reference's ``obs/telemetry.py`` (standard
library only), names and behaviour unchanged.

The paper's evaluation (and the stage-structured related work,
arXiv:1903.07761 / LCP arXiv:2411.00761) reports *per-stage* time
breakdowns of exactly our analyze/encode/entropy/write stages; this module
is the measurement substrate those numbers come from.  Design rules:

  * **Disabled is free.**  There is one process-global ``_active``
    registry slot; when it is ``None`` every primitive returns the shared
    no-op constant (``span``) or falls through a single attribute check
    (``counter``/``gauge``/``histo``).  No locks, no allocation, no
    timestamps on the disabled path -- instrumentation can stay in the hot
    paths permanently.
  * **Spans never change outputs.**  Every primitive is read-only with
    respect to pipeline state; blobs are byte-identical with telemetry
    enabled or disabled (asserted in tests/test_torch_obs.py).
  * **Thread-aware.**  The span stack is thread-local (nesting depth is
    per thread) while the record list is shared under a lock, so spans
    from the entropy pool, the overlap workers and the main thread all
    land in one registry and export as separate Chrome-trace lanes
    (``obs.trace``).

Usage::

    from repro_torch.obs import telemetry

    with telemetry.capture() as reg:
        with telemetry.span("encode", step=3) as sp:
            ...
            sp.set(bytes_out=n)
        telemetry.counter("entropy.bytes_in.zlib", total)
    report.rollup(reg)          # aggregates
    trace.write_chrome_trace(path, reg)   # chrome://tracing JSON

While a capture is active every span also enters the device annotation
that ``obs.trace`` registers (``torch.profiler.record_function``, plus an
NVTX range once CUDA is initialised), so each host span lines up with the
kernels it launched in a ``torch.profiler`` capture, on the profiler's
clock.  The reference's ``annotate=`` switch is gone: one rule, every
span.  Disabled, ``span`` returns the shared no-op and touches no torch.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["Registry", "SpanRecord", "span", "counter", "gauge", "histo",
           "capture", "enabled", "start", "stop", "active",
           "set_annotation_factory"]


class SpanRecord:
    """One finished span (immutable once recorded)."""

    __slots__ = ("name", "t0", "t1", "tid", "tname", "depth", "attrs",
                 "error")

    def __init__(self, name: str, t0: float, t1: float, tid: int,
                 tname: str, depth: int, attrs: Dict[str, Any],
                 error: Optional[str]):
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.tid = tid
        self.tname = tname
        self.depth = depth
        self.attrs = attrs
        self.error = error

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"SpanRecord({self.name!r}, {self.duration * 1e3:.3f}ms, "
                f"thread={self.tname!r}, depth={self.depth})")


class Registry:
    """Holds every record of one capture window.

    Span records, counters, gauge sample series and histogram samples are
    appended under one lock (writers are the main thread plus pool/overlap
    workers); the span *stack* is thread-local so nesting depth is always
    per thread.
    """

    def __init__(self):
        self.t0 = time.perf_counter()
        self._lock = threading.Lock()
        self.spans: List[SpanRecord] = []
        self.counters: Dict[str, float] = {}
        # gauge name -> [(t_rel_seconds, value), ...] sample series
        self.gauges: Dict[str, List[Tuple[float, float]]] = {}
        self.hists: Dict[str, List[float]] = {}
        self._tls = threading.local()

    # ------------------------------------------------------------- writers
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = []
            self._tls.stack = st
        return st

    def record_span(self, rec: SpanRecord):
        with self._lock:
            self.spans.append(rec)

    def counter_add(self, name: str, value: float):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + value

    def gauge_set(self, name: str, value: float):
        t = time.perf_counter() - self.t0
        with self._lock:
            self.gauges.setdefault(name, []).append((t, float(value)))

    def hist_record(self, name: str, value: float):
        with self._lock:
            self.hists.setdefault(name, []).append(float(value))

    # ------------------------------------------------------------- readers
    def snapshot(self) -> Dict[str, Any]:
        """Point-in-time copy of every record list (safe to iterate while
        workers keep appending)."""
        with self._lock:
            return {"spans": list(self.spans),
                    "counters": dict(self.counters),
                    "gauges": {k: list(v) for k, v in self.gauges.items()},
                    "hists": {k: list(v) for k, v in self.hists.items()}}

    def span_names(self) -> List[str]:
        with self._lock:
            return sorted({s.name for s in self.spans})


# ------------------------------------------------------------------ state

_active: Optional[Registry] = None
_annotation_factory: Optional[Callable[[str], Any]] = None


def set_annotation_factory(fn: Optional[Callable[[str], Any]]):
    """Register the device-annotation bridge (``obs.trace`` installs a
    ``torch.profiler.record_function`` factory; ``None`` disables it).  The
    factory may return ``None`` (no annotation) or a context manager."""
    global _annotation_factory
    _annotation_factory = fn


def enabled() -> bool:
    return _active is not None


def active() -> Optional[Registry]:
    return _active


def start(registry: Optional[Registry] = None) -> Registry:
    """Enable telemetry into `registry` (a fresh one by default)."""
    global _active
    _active = registry if registry is not None else Registry()
    return _active


def stop() -> Optional[Registry]:
    """Disable telemetry; returns the registry that was collecting."""
    global _active
    reg, _active = _active, None
    return reg


@contextmanager
def capture(registry: Optional[Registry] = None):
    """Scoped enable: ``with telemetry.capture() as reg: ...``."""
    reg = start(registry)
    try:
        yield reg
    finally:
        if _active is reg:
            stop()


# ------------------------------------------------------------------ spans

class _NoopSpan:
    """The disabled-path constant: every method is a no-op, ``duration``
    is 0.0.  A single shared instance is returned by every ``span()`` call
    while telemetry is disabled -- no allocation, no timestamps."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        return False

    def set(self, **kw):
        return self

    @property
    def duration(self) -> float:
        return 0.0


NOOP_SPAN = _NoopSpan()


class Span:
    """A live span: context manager that records a SpanRecord on exit.

    ``set(**attrs)`` attaches attributes any time before exit (e.g. sizes
    known only at the end of the stage).  If the body raises, the record
    carries ``error`` and the exception propagates unchanged.
    """

    __slots__ = ("_reg", "name", "attrs", "t0", "t1", "_depth", "_ann")

    def __init__(self, reg: Registry, name: str, attrs: Dict[str, Any]):
        self._reg = reg
        self.name = name
        self.attrs = attrs
        self.t0 = 0.0
        self.t1 = 0.0
        fn = _annotation_factory
        self._ann = fn(name) if fn is not None else None

    def set(self, **kw):
        self.attrs.update(kw)
        return self

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    def __enter__(self):
        st = self._reg._stack()
        self._depth = len(st)
        st.append(self)
        if self._ann is not None:
            self._ann.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, et, ev, tb):
        self.t1 = time.perf_counter()
        if self._ann is not None:
            self._ann.__exit__(et, ev, tb)
        st = self._reg._stack()
        if st and st[-1] is self:
            st.pop()
        th = threading.current_thread()
        err = None if et is None else f"{et.__name__}: {ev}"
        self._reg.record_span(SpanRecord(
            self.name, self.t0, self.t1, th.ident or 0, th.name,
            self._depth, self.attrs, err))
        return False


def span(name: str, **attrs):
    """Open a (nested) span, which also enters the registered device
    annotation.  Returns the shared no-op constant when telemetry is
    disabled -- safe to leave in hot paths."""
    reg = _active
    if reg is None:
        return NOOP_SPAN
    return Span(reg, name, attrs)


def counter(name: str, value: float = 1.0):
    reg = _active
    if reg is not None:
        reg.counter_add(name, value)


def gauge(name: str, value: float):
    reg = _active
    if reg is not None:
        reg.gauge_set(name, value)


def histo(name: str, value: float):
    reg = _active
    if reg is not None:
        reg.hist_record(name, value)
