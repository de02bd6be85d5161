#!/usr/bin/env python3
"""The control: the reference itself, in bfloat16, put in the program's
place and judged by the cell's own check.  The configurations state
float32; bfloat16 is the next precision below (a float32 computation
with no matrix products has no TF32 step).  A sound check reads it as not
correct.

    python3 portbench/control.py --workload cmip.rans.stream \
        --seeds 21,22,23 [--steps 64]

prints one JSON line a seed with the check's numbers.  Stream cells feed
``--steps`` deltas in the cell's order; read cells the cell's series.
"""
from __future__ import annotations

import argparse
import json
import struct
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def v0_blob(idx: np.ndarray, b: int) -> bytes:
    """A stored (v0) index block: u32 length | u8 0 | the packed bits."""
    bits = ((idx.astype(np.int64)[:, None] >> np.arange(b)) & 1)
    raw = np.packbits(bits.astype(np.uint8).reshape(-1), bitorder="little")
    return struct.pack("<IB", raw.size, 0) + raw.tobytes()


def _step(enc, curr):
    return SimpleNamespace(
        b_bits=enc["b"], centers=enc["centers"], nbytes=0,
        incomp_values=curr[enc["exc"]].float().cpu().numpy(),
        index_blocks=[v0_blob(enc["idx"].cpu().numpy(), enc["b"])],
        n_incompressible=int(enc["exc"].sum()))


def record(ctx, driver, dtype, steps: int) -> dict:
    """A run's record with the reference in ``dtype`` as the program."""
    import torch
    from portbench import gen, reference
    tr = ctx.traffic
    k = tr.get("pool_steps", tr.get("series_steps"))
    pool_dev = gen.make_pool(ctx.config, k, ctx.seed, ctx.device)
    pool = [x.cpu().numpy() for x in pool_dev]
    stated = reference.stated(ctx.config)
    if tr["driver"] == "stream":
        seq = driver.order(k)
        fed = [next(seq) for _ in range(steps + 1)]
        tally = driver._Tally(ctx.seed, tr["sample_steps"])
        for t, enc, curr, _ in reference.follow(pool_dev, fed, dtype=dtype,
                                                **stated):
            tally.add(t, _step(enc, curr))
        return dict(pool=pool, fed=fed, tally=tally, summary={})
    stored, kept = [None], {(0, 0): pool[0]}
    for t, enc, curr, state in reference.follow(
            pool_dev, list(range(k)), dtype=dtype, **stated):
        stored.append(_step(enc, curr))
        kept[(t, t)] = state.to(torch.float32).cpu().numpy()
    return dict(pool=pool, steps_stored=stored, kept=kept, short=0,
                summary={})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench import harness
    cs = harness.cell(a.workload)
    driver = harness._load(ROOT / "portbench" / "drivers"
                           / f"{cs['traffic']['driver']}.py")
    for seed in a.seeds.split(","):
        ctx = harness.Ctx(a.workload, cs, int(seed), 0, False, torch,
                          a.device, lambda: 0.0)
        checks = driver.check(ctx, record(ctx, driver, torch.bfloat16,
                                          a.steps))
        print(json.dumps({"workload": a.workload, "seed": int(seed),
                          "control": "bfloat16", "checks": checks,
                          "correct": all(c["value"] <= c["limit"]
                                         for c in checks.values())}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
