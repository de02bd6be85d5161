"""Pipeline observability: telemetry spans/counters/gauges, Chrome-trace
export, and per-step/per-series rollups (the reference's ``obs``
package, with a torch device-annotation bridge).

Importing the package wires the pieces together (``trace`` registers the
``torch.profiler.record_function`` bridge with ``telemetry``); all three
submodules are standard library only at import time, so
``repro_torch.obs`` is safe to import from the most import-light core
modules.
"""
from repro_torch.obs import report, telemetry, trace
from repro_torch.obs.report import rollup, series_rollup
from repro_torch.obs.telemetry import (Registry, capture, counter, enabled,
                                       gauge, histo, span, start, stop)
from repro_torch.obs.trace import (chrome_trace, device_annotation,
                                   write_chrome_trace)

__all__ = ["telemetry", "trace", "report", "Registry", "capture", "counter",
           "enabled", "gauge", "histo", "span", "start", "stop",
           "chrome_trace", "device_annotation", "write_chrome_trace",
           "rollup", "series_rollup"]
