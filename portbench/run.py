#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python3 portbench/run.py --workload cmip.rans.stream --seed 7 \
        --seconds 10 --trace 0

from the root of a checkout, on a machine with the CUDA devices the cell
asks for.  Without them it exits with code 2 and prints no result.  The
last line of standard output is the result (see ``harness.py``).
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

_T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent


def _since_start() -> float:
    """Seconds since this process started (the kernel's record of it where
    there is one, else since this file began to run)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # The program's CUDA builds live in the checkout (build/); keep the
    # driver's JIT cache beside them, at a fixed path.
    os.environ.setdefault("CUDA_CACHE_PATH",
                          str(ROOT / "build" / "cuda_cache"))
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import harness
    return harness.main(args, _since_start)


if __name__ == "__main__":
    sys.exit(main())
