"""The traced run's device trace: torch.profiler over the measured window,
reduced to busy time, kernel time and count, the costliest device
operations and the longest idle gaps by what the host was doing.

Kernels, copies and memsets count as busy.  The window is the harness's
own ``portbench.window`` annotation; the host's activity during a gap is
the innermost annotation (a span of the program, or the harness's own
around each call into it) that holds the gap's middle.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Tuple

WINDOW = "portbench.window"
BUSY = {"kernel", "gpu_memcpy", "gpu_memset"}


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        elif b > a:
            out.append((a, b))
    return out


def _clip(spans, t0, t1):
    return [(max(a, t0), min(b, t1)) for a, b in spans
            if min(b, t1) > max(a, t0)]


def reduce_events(events: List[dict]) -> Dict[str, object]:
    """Reduce a Chrome trace's events (times in microseconds) to seconds."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise ValueError(f"the trace holds {len(win)} '{WINDOW}' windows")
    t0 = float(win[0]["ts"])
    t1 = t0 + float(win[0]["dur"])
    dev = [e for e in events if e.get("cat") in BUSY and e.get("ph") == "X"]

    def spans(cats):
        return _clip([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                      for e in dev if e["cat"] in cats], t0, t1)

    busy = _union(spans(BUSY))
    kern = _union(spans({"kernel"}))
    inside = [e for e in dev if t0 <= float(e["ts"]) < t1]
    by_op: Dict[str, float] = {}
    for e in inside:
        name = e["name"][:96]
        by_op[name] = by_op.get(name, 0.0) + float(e["dur"]) * 1e-6
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in events
                  if e.get("cat") == "user_annotation"
                  and e.get("name") != WINDOW and e.get("ph") == "X")
    gaps: Dict[str, float] = {}
    edge = t0
    for a, b in busy + [(t1, t1)]:
        if a > edge:
            mid = 0.5 * (edge + a)
            doing = [h for h in host if h[0] <= mid < h[1]]
            name = max(doing)[2] if doing else "host:unannotated"
            gaps[name] = gaps.get(name, 0.0) + (a - edge) * 1e-6
        edge = max(edge, b)
    top = lambda d: [[k, v] for k, v in  # noqa: E731
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"window_s": (t1 - t0) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "kernel_s": sum(b - a for a, b in kern) * 1e-6,
            "kernels": sum(1 for e in inside if e["cat"] == "kernel"),
            "device_ops": top(by_op), "idle_gaps": top(gaps)}


class Profile:
    """torch.profiler over CPU and CUDA, started before the window opens
    so that its own start-up is set-up time."""

    def __init__(self, torch_mod, cuda: bool):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        self._torch = torch_mod
        self._cuda = cuda
        self._prof = profile(activities=acts)

    def warm(self) -> None:
        """One short profile first: the tracer's one-time start-up."""
        from torch.profiler import profile
        with profile(activities=self._prof.activities):
            x = self._torch.ones(1 << 20, device="cuda" if self._cuda
                                 else "cpu")
            (x * 2).sum().item()

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        return False

    def reduce(self) -> Dict[str, object]:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return reduce_events(events)
