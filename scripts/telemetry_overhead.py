#!/usr/bin/env python3
"""Time the warm CMIP series with telemetry off against other trees of the
port, and with telemetry on, on one CUDA card.

    python3 scripts/telemetry_overhead.py [--source NAME=DIR/src ...]
                                          [--reps 3]
                                          [--out chiprun_out/overhead.json]

Each tree runs in a process of its own (every tree's package is
``repro_torch``): the sources in the order given, this tree twice, then
the sources again in reverse, so a drift of the host's speed over the run
falls on both sides.  A process builds its tree's kernels, makes the CMIP
series of chip_smoke.py (seed 0, 6 steps of 42 x 360 x 240 float32), and
for zlib and for rans (v1 blobs) runs ``reps + 1`` calls of
``compress_series`` then ``decompress_series`` on the card, chain
"device", each ended by a synchronize and timed on the host clock; the
first call of each is a warm-up and is dropped.  A tree that has
``repro_torch.obs`` also runs the same calls under ``telemetry.capture()``.
The script prints the median of each tree, codec, mode and call over all
its processes, beside the card's name and power limit, and writes every
time to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_WORKER = """
import json, sys, time
import torch
from repro_torch import compress_series, decompress_series
from repro_torch.core.types import NumarckParams
from repro_torch.data.temporal import generate_series
from repro_torch.kernels import _build
try:
    from repro_torch.obs import telemetry
except ImportError:
    telemetry = None
_build.build()
reps = int(sys.argv[1])
arrays = list(generate_series("cmip", 6, seed=0, scale=1))
out = {}
for codec in ("zlib", "rans"):
    p = NumarckParams(error_bound=1e-3, codec=codec)
    for mode in ("off", "on") if telemetry else ("off",):
        comp, dec = [], []
        for _ in range(reps + 1):
            if mode == "on":
                telemetry.start()
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                steps = compress_series(arrays, p, chain="device",
                                        device="cuda")
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                decompress_series(steps, device="cuda")
                torch.cuda.synchronize()
                t2 = time.perf_counter()
            finally:
                if mode == "on":
                    telemetry.stop()
            comp.append((t1 - t0) * 1e3)
            dec.append((t2 - t1) * 1e3)
        out[f"{codec} {mode}"] = {"compress_ms": comp[1:],
                                  "decompress_ms": dec[1:]}
print("RESULT " + json.dumps(out))
"""


def run_tree(src: Path, reps: int) -> dict:
    env = dict(os.environ, PYTHONPATH=str(src))
    proc = subprocess.run([sys.executable, "-c", _WORKER, str(reps)],
                          env=env, capture_output=True, text=True,
                          timeout=1800)
    if proc.returncode:
        raise RuntimeError(f"worker for {src} failed:\n{proc.stderr}")
    return json.loads(proc.stdout.split("RESULT ", 1)[1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=DIR", help="another tree's src/ directory")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "overhead.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("telemetry_overhead: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    sources = dict(s.split("=", 1) for s in args.source)
    trees = {**{n: Path(p).resolve() for n, p in sources.items()},
             "current": ROOT / "src"}
    order = (list(sources) + ["current", "current"]
             + list(reversed(list(sources))))
    runs = []
    for name in order:
        res = run_tree(trees[name], args.reps)
        runs.append({"tree": name, "times": res})
        print(f"{name}: " + json.dumps(
            {k: {c: [round(x, 1) for x in v] for c, v in r.items()}
             for k, r in res.items()}), flush=True)
    summary: dict = {}
    for r in runs:
        for key, calls in r["times"].items():
            for call, vals in calls.items():
                summary.setdefault(r["tree"], {}).setdefault(
                    f"{key} {call}", []).extend(vals)
    print(f"medians, ms, warm CMIP series (6 steps), {card}:")
    for tree, rows in summary.items():
        for key, vals in sorted(rows.items()):
            print(f"  {tree:10s} {key:28s} {statistics.median(vals):9.1f} "
                  f"(n={len(vals)}, min {min(vals):.1f}, max "
                  f"{max(vals):.1f})")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "order": order, "runs": runs}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
