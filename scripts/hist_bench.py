#!/usr/bin/env python3
"""Time the histogram kernel against earlier versions of its source on one
CUDA card.

    python3 scripts/hist_bench.py [--source NAME=PATH ...] [--profile]
                                  [--out build/hist_bench.json]

It builds src/repro_torch/csrc/hist.cu ("current") and every ``--source``
(another hist.cu: the parent commit's from a ``git archive``, or an
earlier revision) with the flags of kernels/_build.py, every nvcc at once.
A source whose library has no ``histogram_plan`` is taken to be the
parent's, whose ``histogram_i32`` takes no id bound and whose counts the
caller zeroes.  The id sets are chip_smoke.py's (`hist_id_sets`): the CMIP
step's ids with the main path's id bound, the 2^26 pair, the wide-domain
2^26 pair, one-bin and uniform ids.  Every build is held against
histogram_plain exactly on every set, then timed as chip_smoke.py times a
kernel (CUDA events behind a spin kernel, allocation of the counts
included as in each wrapper), in turns: the sources in the order given,
current, then current and the sources again in reverse.  "host us" is
the host's time per call over 200 calls queued back to back (launch
overhead and the plan, no synchronize).  ``--profile`` adds each build's
device time per call of each kernel it runs, from torch.profiler.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def build_all(build_dir: Path, sources: dict) -> dict:
    """name -> source path  ->  name -> loaded library."""
    from repro_torch.kernels import _build

    build_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, src in sources.items():
        so = build_dir / f"libhist_{name}.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT))
    libs = {}
    for name, (so, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n"
                               + out.decode(errors="replace"))
        libs[name] = ctypes.CDLL(str(so))
    return libs


def entry(lib):
    """(histogram_i32, whether it takes an id bound)."""
    with_bound = hasattr(lib, "histogram_plan")
    fn = lib.histogram_i32
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                    ctypes.c_int] + ([ctypes.c_int] if with_bound else [])
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, with_bound


def profile_us(torch, fn, iters: int = 20) -> dict:
    """Device microseconds per call of each kernel ``fn`` runs, from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = getattr(evt, "self_cuda_time_total", 0)
        if t:
            out[evt.key[:40]] = round(t / iters, 3)
    return out


def host_us(torch, fn, calls: int = 200) -> float:
    """Host microseconds per call of ``fn``, queued back to back."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH", help="another hist.cu to time")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "hist_bench.json")
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.data.temporal import generate_series
    from repro_torch.kernels import hist

    if not torch.cuda.is_available():
        print("hist_bench: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)

    others = dict(s.split("=", 1) for s in args.source)
    sources = {"current": ROOT / "src" / "repro_torch" / "csrc" / "hist.cu"}
    sources.update({k: Path(v).resolve() for k, v in others.items()})
    libs = build_all(ROOT / "build" / "hist_bench", sources)
    fns = {k: entry(lib) for k, lib in libs.items()}

    cmip = [a.reshape(-1) for a in generate_series("cmip", 2, seed=0)]
    prev_big, curr_big = cs.big_pair(np, cs.N_BIG)
    pairs = {"cmip": tuple(cmip), "2^26": (prev_big, curr_big),
             "wide 2^26": cs.wide_pair(np, prev_big, curr_big)}
    m = 65536
    sets = cs.hist_id_sets(torch, np, dev, pairs, cs.E, m)
    del pairs, prev_big, curr_big

    order = [*others, "current", "current", *reversed(others)]
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for label, (ids, bound) in sets.items():
        n = ids.numel()
        want = hist.histogram_plain(ids, max_bins=m)
        b_arg = m if bound is None else bound

        def call(name):
            fn, with_bound = fns[name]
            alloc = torch.empty if with_bound else torch.zeros
            counts = alloc(m, dtype=torch.int32, device=dev)
            extra = (b_arg,) if with_bound else ()
            rc = fn(ids.data_ptr(), n, counts.data_ptr(), m, *extra, stream)
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")
            return counts

        for name in fns:
            got = call(name)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{name} differs from histogram_plain "
                                     f"on {label}")
        bound_ms = cs.bound_ms(4 * n + 4 * m, n, cs.FP32_OPS_PER_S)[0]
        times = {}
        for name in order:
            times.setdefault(name, []).append(
                cs.time_ms(torch, lambda: call(name)))
        host = {name: host_us(torch, lambda: call(name)) for name in fns}
        row = dict(set=label, n=n, id_bound=bound, bound_ms=bound_ms,
                   card=card, ms=times, host_us=host)
        if args.profile:
            row["profile_us"] = {name: profile_us(torch, lambda: call(name))
                                 for name in fns}
            print(f"  torch.profiler, device us per call: "
                  f"{json.dumps(row['profile_us'])}", flush=True)
        rows.append(row)
        print(f"{label} n={n} id_bound={bound} bound {bound_ms:.4f} ms; all "
              f"exact; ms: " + ", ".join(
                  f"{k} {'/'.join(f'{t:.4f}' for t in v)}"
                  for k, v in times.items())
              + "; host us: " + ", ".join(f"{k} {v:.2f}"
                                          for k, v in host.items()),
              flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"sets": rows}, indent=1))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
