#!/usr/bin/env python3
"""Run a cell several times, one process a run, and report each metric's
spread: the interquartile distance over the median, per set of runs.

    python3 portbench/spread.py --workload cmip.rans.stream --seconds 10 \
        --sets 2 --seeds 11,12,13,14,15,16 [--traced 3] [--out FILE]

Each set runs the same seeds in turn; ``--traced`` adds that many
``--trace 1`` runs on further seeds.  Every result line, with the run's
wall time, goes to ``--out`` (JSON lines).  A bound is set from the wider
of the sets' spreads (see PERF.md).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

RUN = Path(__file__).resolve().parent / "run.py"


def one(workload: str, seed: int, seconds: float, trace: int) -> dict:
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, str(RUN), "--workload", workload,
                        "--seed", str(seed), "--seconds", str(seconds),
                        "--trace", str(trace)], capture_output=True,
                       text=True)
    wall = time.perf_counter() - t0
    lines = p.stdout.strip().splitlines()
    out = {"seed": seed, "trace": trace, "rc": p.returncode, "wall_s": wall}
    try:
        out["result"] = json.loads(lines[-1])
        out["summary"] = json.loads(lines[-2])["portbench"]
    except (IndexError, ValueError, KeyError):
        out["stderr"] = p.stderr[-3000:]
    return out


def spread(values):
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--traced", type=int, default=0)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    seeds = [int(s) for s in a.seeds.split(",")]
    runs = []
    sink = open(a.out, "a") if a.out else None
    try:
        plan = [(k, s, 0) for k in range(a.sets) for s in seeds]
        plan += [(a.sets, seeds[-1] + 1000 + i, 1) for i in range(a.traced)]
        for k, s, tr in plan:
            r = one(a.workload, s, a.seconds, tr)
            r["set"] = k
            runs.append(r)
            line = json.dumps({"workload": a.workload, **r})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    report = {}
    for k in range(a.sets):
        got = [r["result"] for r in runs if r["set"] == k and "result" in r]
        names = sorted({m for g in got for m in g["metrics"]})
        for m in names:
            vals = [g["metrics"][m]["value"] for g in got if m in g["metrics"]]
            report.setdefault(m, []).append(
                {"median": statistics.median(vals), "spread": spread(vals),
                 "n": len(vals)})
    wrong = [r["seed"] for r in runs if not r.get("result", {}).get("correct")]
    print(json.dumps({"workload": a.workload, "spreads": report,
                      "not_correct": wrong}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
