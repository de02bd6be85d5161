#!/usr/bin/env python3
"""The dry run's whole matrix in several processes at once.

    python3 scripts/dryrun_matrix.py [--out build/dryrun_matrix]
                                     [--procs-per-mesh 4]

Every arch x shape cell of ``repro_torch.launch.dryrun`` on both meshes
and the compression cell of each, as ``python -m repro_torch.launch.dryrun
--all --compression --out DIR`` runs them one after another, in
``2 x --procs-per-mesh`` CPU processes (each holds one fake fleet, so a
process takes the cells of one mesh).  One record a cell lands in
``--out``; the script prints the OK / SKIP / FAIL counts and each FAIL
with its error, and exits 1 if a cell failed.  It needs no device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORKER = """
import json, sys
from repro_torch.launch import dryrun
mesh, out = sys.argv[1], sys.argv[2]
for arch, shape in json.loads(sys.argv[3]):
    dryrun.run_cell(arch, shape, mesh, out)
if sys.argv[4] == "1":
    dryrun.run_compression_dryrun(mesh, out)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "dryrun_matrix"))
    ap.add_argument("--procs-per-mesh", type=int, default=4)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import list_archs
    from repro_torch.models.config import SHAPES

    cells = [(a, s) for a in list_archs() for s in SHAPES]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    n = args.procs_per_mesh
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, mesh, args.out,
         json.dumps(cells[i::n]), "1" if i == 0 else "0"], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        for mesh in ("single", "multi") for i in range(n)]
    try:
        for p in procs:
            p.wait()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    recs = [json.loads(f.read_text())
            for f in sorted(Path(args.out).glob("*.json"))]
    print(json.dumps(Counter(r["status"] for r in recs)),
          f"{time.perf_counter() - t0:.1f} s")
    for r in recs:
        if r["status"] == "FAIL":
            print("FAIL", r["arch"], r["shape"], r["mesh"],
                  r["error"][:400].replace("\n", " "))
    return 1 if any(r["status"] == "FAIL" for r in recs) else 0


if __name__ == "__main__":
    sys.exit(main())
