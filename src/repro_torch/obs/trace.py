"""Chrome-trace (``chrome://tracing`` / Perfetto) export of a telemetry
capture, plus the torch device-annotation bridge.

The port's counterpart of the reference's ``obs/trace.py``.
``chrome_trace(reg)`` converts a :class:`~repro_torch.obs.telemetry.Registry`
into the Trace Event Format dict Chrome/Perfetto load directly:

  * every span becomes a complete ("ph": "X") event on its own thread
    lane -- the entropy pool threads ("entropy_N"), the overlap/finalize
    workers ("finalize_N", "shard-finalize_N", "ckpt-save_N") and the
    main thread each render as a separate track;
  * gauge sample series become counter ("ph": "C") events (e.g. the
    FinalizeQueue depth over time);
  * counters and histogram summaries ride in ``otherData``.

Open a written file at chrome://tracing or https://ui.perfetto.dev.

Device bridging: importing this module registers an annotation factory
with the telemetry layer in place of the reference's jax
``TraceAnnotation``: every span opened under an enabled capture enters
``torch.profiler.record_function(name)``, so the span appears inside a
``torch.profiler`` capture above the kernels it launched, and, once CUDA
is initialised in the process, pushes an NVTX range of the same name.
torch is imported only when a span opens under an enabled capture, so
importing this module stays standard library only.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Optional

from repro_torch.obs import telemetry

__all__ = ["chrome_trace", "write_chrome_trace", "device_annotation"]

_PID = 0                    # single-process trace; lanes are threads


class _TorchAnnotation:
    """``torch.profiler.record_function(name)``, and an NVTX range when
    CUDA is initialised: one context manager."""

    __slots__ = ("_name", "_rf", "_nvtx")

    def __init__(self, name: str):
        import torch
        self._name = name
        self._rf = torch.profiler.record_function(name)
        self._nvtx = torch.cuda.nvtx if torch.cuda.is_initialized() else None

    def __enter__(self):
        self._rf.__enter__()
        if self._nvtx is not None:
            self._nvtx.range_push(self._name)
        return self

    def __exit__(self, et, ev, tb):
        if self._nvtx is not None:
            self._nvtx.range_pop()
        return self._rf.__exit__(et, ev, tb)


telemetry.set_annotation_factory(_TorchAnnotation)


def device_annotation(name: str):
    """Standalone device annotation (no host span): a context manager that
    is a no-op unless telemetry is enabled."""
    if not telemetry.enabled():
        return telemetry.NOOP_SPAN
    return _TorchAnnotation(name)


def chrome_trace(reg: Optional[telemetry.Registry] = None) -> Dict[str, Any]:
    """Trace Event Format dict of a capture (the active one by default)."""
    reg = reg if reg is not None else telemetry.active()
    if reg is None:
        raise ValueError("no registry: pass one or run inside capture()")
    snap = reg.snapshot()
    events = []
    # Lane key is (os tid, thread name), not the tid alone: the OS reuses
    # idents, so a finalize worker that exits before an entropy pool
    # thread starts would otherwise be merged into the pool's lane.
    lanes: Dict[tuple, int] = {}
    for rec in snap["spans"]:
        tid = lanes.setdefault((rec.tid, rec.tname), len(lanes))
        args = {k: _jsonable(v) for k, v in rec.attrs.items()}
        if rec.error is not None:
            args["error"] = rec.error
        events.append({
            "name": rec.name, "cat": "host", "ph": "X",
            "ts": (rec.t0 - reg.t0) * 1e6, "dur": rec.duration * 1e6,
            "pid": _PID, "tid": tid, "args": args,
        })
    for (_, tname), tid in sorted(lanes.items(), key=lambda kv: kv[1]):
        events.append({"name": "thread_name", "ph": "M", "pid": _PID,
                       "tid": tid, "args": {"name": tname}})
    for name, samples in sorted(snap["gauges"].items()):
        for t, v in samples:
            events.append({"name": name, "ph": "C", "ts": t * 1e6,
                           "pid": _PID, "args": {"value": v}})
    hist_summary = {
        name: {"count": len(vs), "mean": sum(vs) / len(vs), "max": max(vs)}
        for name, vs in sorted(snap["hists"].items()) if vs}
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"counters": snap["counters"],
                          "histograms": hist_summary}}


def write_chrome_trace(path: str,
                       reg: Optional[telemetry.Registry] = None) -> str:
    """Write the Chrome-trace JSON for `reg` to `path`; returns `path`."""
    with open(path, "w") as f:
        json.dump(chrome_trace(reg), f)
    return path


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)
