"""One rank of a multi-process stream cell (``mp_stream.py`` starts them).

    python portbench/drivers/mp_rank.py <work dir>

under ``repro_torch.launch.distributed.spawn_emulated``, which gives the
rank its place in the fleet and, on a host with cards, one card of its
own.  ``<work dir>/spec.json`` holds the cell, the seed, the window's
length, whether it is traced and the device kind.

Set-up makes the cell's pool from the seed on the rank's device (every
rank the same steps), compresses the anchor and the warm-up through
``MultiProcessCompressor.add_fragment_async``.  The ranks open the window
at a barrier and feed the pool in ``stream.order`` until rank 0's window
closes.  Every step ends in collectives that all ranks join, so the
ranks run in lockstep and none can begin a step more than one ahead of
another: rank 0, at its deadline after c steps, writes ``stop`` with the
count c + 1, which no rank has passed, and every rank feeds up to it.
The window closes at a barrier.  In a traced run rank 0 runs the
profiler over the window's first seconds, and every rank records the
program's spans over all of it.  Afterwards every rank writes its set-up
fragments with ``ShardNCKWriter`` and rank 0 commits their manifest;
each rank leaves its record in ``<work dir>/rank<r>.pkl``.
"""
from __future__ import annotations

import json
import os
import pickle
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]


def _write(path: Path, data: bytes) -> None:
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def main(work: Path) -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    spec = json.loads((work / "spec.json").read_text())
    traced = bool(spec["trace"])
    import torch
    import torch.distributed as dist
    from repro_torch.launch import distributed as ld

    cfg = ld.initialize()
    rank, ranks = cfg.process_id, cfg.num_processes
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // ranks))
    device = spec["device"]
    card = None
    if device == "cuda":
        seen = torch.cuda.device_count()
        if seen != 1:
            raise SystemExit(f"rank {rank} sees {seen} cards: a rank of "
                             "this deployment sees its own card only")
        torch.cuda.set_device(0)
        card = str(torch.cuda.get_device_properties(0).uuid)

    from portbench import gen, harness, yardstick
    from repro_torch.core.container import ShardNCKWriter
    from repro_torch.core.types import NumarckParams
    from repro_torch.distributed.pipeline import MultiProcessCompressor
    from repro_torch.kernels import rans
    from repro_torch.obs import telemetry

    stream = harness._load(HERE / "stream.py")
    digest = harness._load(HERE / "mp_stream.py")._digest
    cellspec = dict(workload=spec["workload"], config=spec["config"],
                    traffic=spec["traffic"])
    t_start = time.perf_counter()
    ctx = harness.Ctx(spec["workload"]["name"], cellspec, spec["seed"],
                      spec["seconds"], traced and rank == 0, torch,
                      device, lambda: time.perf_counter() - t_start)
    tr = ctx.traffic
    params = NumarckParams(**ctx.config["params"], **tr["params"])
    pool = [x.cpu().numpy() for x in gen.make_pool(
        ctx.config, tr["pool_steps"], ctx.seed, device)]
    seq = stream.order(len(pool))
    comp = MultiProcessCompressor([device], params)
    tally = stream._Tally(ctx.seed, tr["sample_steps"])
    owned, done_at, step_s, must = [], [], [], []
    item = pool[0].itemsize
    ln = -(-pool[0].size // ranks)

    def take(t, frag):
        tally.add(t, SimpleNamespace(
            b_bits=frag.info["B"], centers=frag.centers,
            incomp_values=frag.incomp_values, nbytes=frag.nbytes,
            index_blocks=frag.index_blocks))
        owned.append((frag.block_start, len(frag.index_blocks)))

    fed = [next(seq)]
    setup = [comp.add_fragment(pool[fed[0]])]          # the anchor
    for _ in range(tr["warmup_steps"]):
        fed.append(next(seq))
        setup.append(comp.add_fragment(pool[fed[-1]]))
        take(len(fed) - 1, setup[-1])
    warm = len(fed)
    stop = work / "stop"
    launches = rans.ENCODE.launches
    pending: list = []

    def finish():
        t, fut, t0, done = pending.pop(0)
        frag = fut.result()
        done_at.append(done[0] if done else time.perf_counter())
        step_s.append(done_at[-1] - t0)
        must.append(yardstick.compress_step_bytes(
            ln, item, frag.info["B"], frag.incomp_values.size))
        take(t, frag)

    def feed():
        fed.append(next(seq))
        done: list = []
        t0 = time.perf_counter()
        with torch.profiler.record_function("portbench.add_async"):
            fut = comp.add_fragment_async(pool[fed[-1]])
        fut.add_done_callback(lambda _f, d=done: d.append(
            time.perf_counter()))
        pending.append((len(fed) - 1, fut, t0, done))
        while len(pending) > tr["max_pending"]:
            finish()

    dist.barrier()
    # Rank 0's traced window records the spans; the others record theirs
    # alike, so that every rank pays the same for its spans.
    reg = telemetry.start() if traced and rank != 0 else None
    with ctx.window() as w:
        opened = time.time()
        final = None
        while final is None or len(fed) - warm < final:
            if final is None and rank == 0 and not w.open():
                final = len(fed) - warm + 1
                _write(stop, str(final).encode())
            elif final is None and rank != 0 and stop.exists():
                final = int(stop.read_text())
            if final is None or len(fed) - warm < final:
                feed()
        while pending:
            finish()
        dist.barrier()
    if reg is not None:
        telemetry.stop()
    reg = reg or w.reg
    launches = rans.ENCODE.launches - launches
    trace_steps, trace_bytes = w.traced(done_at, must)
    comp.close()
    coll = []
    if reg is not None:
        coll = [(s.name, s.duration, int(s.attrs.get("bytes", 0)))
                for s in reg.snapshot()["spans"]
                if s.name.startswith("coll.")]
    writer = ShardNCKWriter(str(work / "setup.nck"), rank, ranks)
    for i, frag in enumerate(setup):
        writer.add_fragment(f"step{i:04d}", frag)
    writer.write()
    if rank == 0:
        writer.commit_manifest(timeout=120.0)
    dist.barrier()
    rec = dict(
        rank=rank, ranks=ranks, card=card, pool_sha256=digest(pool),
        fed=fed, warm=warm, owned=owned, done_at=done_at,
        tally=dict(b=tally.b, centers=tally.centers, exc=tally.exc,
                   stored=tally.stored, kept=tally.kept, last=tally.last),
        opened=opened, t0=w.t0, profiled_until=w.trace_until,
        window_s=w.seconds, peak=w.peak,
        setup_peak=w.setup_peak, rans_launches=launches, step_s=step_s,
        trace_steps=trace_steps, roofline_bytes=trace_bytes,
        spans=w.spans, coll=coll, trace=w.trace,
        forbidden=harness.forbidden_modules())
    _write(work / f"rank{rank}.pkl", pickle.dumps(rec, protocol=5))
    ld.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(Path(sys.argv[1])))
