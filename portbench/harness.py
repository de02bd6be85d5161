"""One run of one cell: find its files by name, drive it, judge it, print.

``BENCHMARK.json`` names each cell's configuration and traffic mix.  The
configuration's file is ``configs/<name>.json`` (as BENCHMARK.json gives
it), the traffic mix's ``traffic/<name>.json``; the mix names its driver,
``drivers/<driver>.py``, which sets the cell up, runs the window and
judges what the program produced against ``reference.py``.  Each metric
is read by ``metrics/<name>.py`` from the run's record; a reader that
finds nothing to read returns None and the metric is left out.

The last line of standard output is the result; the numbers compared
with their limits are the last lines of standard error and the result's
last key.
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Packages that may not be loaded in a run: the JAX stack and the
# reference package the program was ported from (compared by top-level
# name, so the port's own name does not match).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _load(path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        f"portbench_{path.parent.name}_{path.stem}".replace(".", "_"), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bench(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(name: str, spec: Optional[dict] = None, root: Path = ROOT) -> dict:
    """The workload ``name`` with its configuration and traffic mix, read
    from their files under the checkout ``root``."""
    spec = spec or bench(root)
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(root / "portbench" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return dict(workload=w, config=config, traffic=traffic,
                chips=int(w["chips"]), root=root)


def metrics_for(spec: dict, name: str, traced: bool):
    """The cell's metrics of one kind, in BENCHMARK.json's order."""
    group = spec["per_layer"] if traced else spec["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def per_second(done, nbytes, t0, seconds):
    """MB delivered in each whole second of the window, from the host
    times at which steps finished (a diagnostic of the run's steadiness)."""
    bins = [0.0] * max(1, int(seconds))
    for t, b in zip(done, nbytes):
        k = int(t - t0)
        if 0 <= k < len(bins):
            bins[k] += b / 1e6
    return [round(b, 1) for b in bins]


def forbidden_modules():
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


# The profiled part of a traced window: its first seconds, long enough for
# some hundreds of steps, short enough that the trace stays a few hundred
# MB and is read within the run's time limit.
TRACE_SECONDS = 4.0


class Window:
    """The measured window: the peak reset at its start, the host clock
    from its open to its close.  In a traced run telemetry records the
    program's spans over the whole window, and torch.profiler its first
    ``TRACE_SECONDS`` under the ``portbench.window`` annotation."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.profile = None
        if ctx.trace:
            from portbench.devtrace import Profile
            self.profile = Profile(ctx.torch, ctx.cuda)
            self.profile.warm()

    def __enter__(self):
        torch = self.ctx.torch
        self.setup_peak = 0
        if self.ctx.cuda:
            torch.cuda.synchronize()
            self.setup_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        self.reg = None
        self._profiling = self.profile is not None
        if self._profiling:
            from repro_torch.obs import telemetry, trace  # noqa: F401
            self.profile.__enter__()
            self.reg = telemetry.start()
        self._ann = torch.profiler.record_function("portbench.window")
        self._ann.__enter__()
        self.t0 = time.perf_counter()
        self.trace_until = self.t0
        self.setup_s = self.ctx.since_start()
        self.deadline = self.t0 + self.ctx.seconds
        return self

    def open(self) -> bool:
        now = time.perf_counter()
        if self._profiling and now >= self.t0 + TRACE_SECONDS:
            self._stop_profile()
        return now < self.deadline

    def _stop_profile(self) -> None:
        if self.ctx.cuda:
            self.ctx.torch.cuda.synchronize()
        self.trace_until = time.perf_counter()
        self._ann.__exit__(None, None, None)
        self.profile.__exit__(None, None, None)
        self._profiling = False

    def traced(self, done_at, values) -> tuple:
        """(steps, sum of ``values``) of the steps finished inside the
        profiled part of the window."""
        inside = [v for t, v in zip(done_at, values) if t <= self.trace_until]
        return len(inside), sum(inside)

    def __exit__(self, et, ev, tb):
        torch = self.ctx.torch
        if self.ctx.cuda:
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        if self._profiling:
            self._stop_profile()
        elif self.profile is None:
            self._ann.__exit__(et, ev, tb)
        self.seconds = self.t1 - self.t0
        self.peak = (torch.cuda.max_memory_allocated()
                     if self.ctx.cuda else 0)
        self.spans = []
        self.trace = None
        if self.profile is not None:
            from repro_torch.obs import telemetry
            telemetry.stop()
            self.spans = [(s.name, s.duration, s.depth)
                          for s in self.reg.snapshot()["spans"]]
            if et is None:
                self.trace = self.profile.reduce()
        return False


class Ctx:
    """What a driver is given: the cell, the seed, the window's length, the
    device, and the process's clock."""

    def __init__(self, name, cellspec, seed, seconds, trace, torch_mod,
                 device, since_start):
        self.name = name
        self.workload = cellspec["workload"]
        self.config = cellspec["config"]
        self.traffic = cellspec["traffic"]
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.torch = torch_mod
        self.device = device
        self.cuda = torch_mod.device(device).type == "cuda"
        self.since_start = since_start

    def window(self) -> Window:
        return Window(self)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             since_start, spec: Optional[dict] = None,
             cellspec: Optional[dict] = None):
    """Set up, measure and judge one run; return (result, the run's
    record).  The caller has made sure the device is there."""
    import torch
    spec = spec or bench()
    cellspec = cellspec or cell(name, spec)
    ctx = Ctx(name, cellspec, seed, seconds, trace, torch, device,
              since_start)
    files = cellspec["root"] / "portbench"
    driver = _load(files / "drivers" / f"{ctx.traffic['driver']}.py")
    rec = driver.run(ctx)
    t0 = time.perf_counter()
    checks = driver.check(ctx, rec)
    rec["summary"]["check_s"] = time.perf_counter() - t0
    metrics = {}
    for m in metrics_for(spec, name, trace):
        value = _load(files / "metrics" / f"{m['name']}.py").read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {"platform": "gpu" if ctx.cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if ctx.cuda
                            else "cpu"),
                   "count": cellspec["chips"],
                   "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    result = {"correct": all(c["value"] <= c["limit"]
                             for c in checks.values()),
              "attempted": int(rec["attempted"]),
              "failed": int(rec["failed"]),
              "metrics": metrics, "device": device_info}
    if trace and rec.get("trace"):
        tr = rec["trace"]
        rec["summary"]["idle_share_kernels_only"] = \
            1.0 - tr["kernel_s"] / tr["window_s"]
        device_info["busy_s"] = tr["busy_s"]
        device_info["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = checks
    return result, rec


def emit(result: dict, rec: dict, out=None, err=None) -> None:
    """Earlier lines first, then the compared numbers as the last lines of
    standard error and the result as the last line of standard output."""
    out, err = out or sys.stdout, err or sys.stderr
    print(json.dumps({"portbench": rec.get("summary", {})}), file=out)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()


def main(args, since_start) -> int:
    import torch
    spec = bench()
    cellspec = cell(args.workload, spec)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; nothing is measured",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cellspec["chips"]:
        print(f"portbench: {args.workload} needs {cellspec['chips']} CUDA "
              f"devices, {torch.cuda.device_count()} present",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result, rec = run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", since_start, spec,
                           cellspec)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    emit(result, rec)
    return 0


__all__ = ["bench", "cell", "run_cell", "main", "emit", "Window", "Ctx",
           "forbidden_modules", "per_second", "FORBIDDEN"]
