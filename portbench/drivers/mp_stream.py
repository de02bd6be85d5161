"""Multi-process stream cells: the paper's parallel NUMARCK (Sec. IV), one
rank a card, each rank compressing its shard of every step as the
simulation writes it.

``run`` builds the CUDA libraries once, starts the configuration's
``ranks`` rank processes (``mp_rank.py``) through the program's launcher,
``launch.distributed.spawn_emulated``, and kills every rank at a deadline:
a rank that hangs fails the run, it never stalls it.  Each rank makes the
same pool from the seed, compresses the anchor and the warm-up through
``MultiProcessCompressor.add_fragment_async``, and feeds the window in
``stream.order`` in lockstep with the others (each rank runs the
harness's ``Window``; in a traced run rank 0's is profiled over its
first seconds and every rank records its spans; the record keeps rank
0's spans, step times and trace, and every rank's collective bytes).
After the window the ranks commit their set-up fragments under one NCKM
manifest, which ``run`` reads back through the program's ``NCKReader``.

The check walks the reference chain over every step fed and compares each
step's B and centers, the exceptions of the ranks' fragments joined in
rank order, and the index tables of the sampled and last steps decoded
from the joined blobs; each rank's first block and block count against
``reference_mp``; the set-up steps read back through the manifest; the
pool each rank made; and the modules each rank loaded.  Every limit is 0.
"""
from __future__ import annotations

import hashlib
import json
import pickle
import shutil
import struct
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from portbench import gen, reference, reference_mp
from portbench.harness import per_second

HERE = Path(__file__).resolve().parent
RANK = HERE / "mp_rank.py"
# Seconds a fleet may take beyond its window before every rank is killed:
# start-up, pools, anchor and warm-up, the window's drain, the set-up
# files and the records (tens of seconds on the card's host).
SLACK_S = 300.0


def _fail(results) -> str:
    for r, res in enumerate(results):
        if res.returncode != 0:
            return (f"rank {r} exited {res.returncode}:\n"
                    f"{(res.stderr or '')[-4000:]}")
    return ""


def _digest(pool) -> str:
    h = hashlib.sha256()
    for x in pool:
        h.update(x.tobytes())
    return h.hexdigest()


def _read_back(path: str, names):
    """The set-up steps as the program's NCKM reader returns them."""
    from repro_torch.core.container import NCKReader
    reader = NCKReader(path)
    return [reader.read_step(name) for name in names]


def run(ctx) -> dict:
    import torch
    from repro_torch.launch import distributed as ld

    began = time.time() - ctx.since_start()
    if ctx.cuda:
        from repro_torch.kernels import _build
        _build.build()
    ranks = int(ctx.config["ranks"])
    work = Path(tempfile.mkdtemp(prefix="portbench-mp-"))
    try:
        (work / "spec.json").write_text(json.dumps(dict(
            workload=ctx.workload, config=ctx.config, traffic=ctx.traffic,
            seed=ctx.seed, seconds=ctx.seconds, trace=ctx.trace,
            device="cuda" if ctx.cuda else "cpu")))
        results = ld.spawn_emulated(ranks, [str(RANK), str(work)],
                                    timeout=ctx.seconds + SLACK_S)
        failed = _fail(results)
        if failed:
            raise RuntimeError(f"the fleet failed: {failed}")
        outs = [pickle.loads((work / f"rank{r}.pkl").read_bytes())
                for r in range(ranks)]
        setup = _read_back(str(work / "setup.nck"),
                           [f"step{i:04d}" for i in range(outs[0]["warm"])])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    pool = [x.cpu().numpy() for x in gen.make_pool(
        ctx.config, ctx.traffic["pool_steps"], ctx.seed, ctx.device)]
    if ctx.cuda:
        torch.cuda.empty_cache()
    head = outs[0]
    n, item = pool[0].size, pool[0].itemsize
    steps = min(len(o["done_at"]) for o in outs)
    window_s = head["window_s"]
    setup_s = max(o["opened"] for o in outs) - began
    rec = dict(kind="stream", pool=pool, pool_sha256=_digest(pool),
               ranks_out=outs, setup=setup,
               attempted=steps, failed=0, steps=steps, window_s=window_s,
               setup_s=setup_s, bytes_in=steps * n * item,
               bytes_stored=sum(sum(o["tally"]["stored"][head["warm"] - 1:])
                                for o in outs),
               memory_peak_bytes=max(max(o["peak"], o["setup_peak"])
                                     for o in outs),
               peak_bytes=max(o["peak"] for o in outs),
               step_s=head["step_s"], spans=head["spans"],
               coll_spans=head["coll"],
               coll_bytes=[sum(b for _, _, b in o["coll"]) for o in outs],
               done_at=[o["done_at"] for o in outs],
               profiled_until=head["profiled_until"], trace=head["trace"],
               trace_steps=head["trace_steps"],
               roofline_bytes=head["roofline_bytes"])
    rec["summary"] = dict(
        steps=steps, ranks=len(outs), window_s=window_s, setup_s=setup_s,
        traced=ctx.trace, MBps=rec["bytes_in"] / window_s / 1e6,
        b_last=head["tally"]["b"][-1],
        rans_launches_per_step=[o["rans_launches"] / max(steps, 1)
                                for o in outs],
        peak_MB=[o["peak"] / 1e6 for o in outs],
        per_s=per_second(head["done_at"], [n * item] * steps, head["t0"],
                         ctx.seconds))
    return rec


def _join(outs, i: int):
    """Step ``i`` of the ranks' tallies joined in rank order: B (-1 where
    the ranks disagree), rank 0's centers, the exceptions."""
    bs = {o["tally"]["b"][i] for o in outs}
    b = bs.pop() if len(bs) == 1 else -1
    exc = np.concatenate([np.asarray(o["tally"]["exc"][i]).reshape(-1)
                          for o in outs])
    return b, outs[0]["tally"]["centers"][i], exc


def _sampled(outs):
    """Step -> the ranks' blobs joined in rank order, for every step each
    rank sampled (all sample the same steps) and the last."""
    kept = {}
    for o in outs:
        t = o["tally"]
        for step, blobs in list(t["kept"].items()) + [tuple(t["last"])]:
            kept.setdefault(step, {})[o["rank"]] = blobs
    return {step: [b for r in sorted(parts) for b in parts[r]]
            for step, parts in kept.items() if len(parts) == len(outs)}


def _index_differ(blobs, n: int, b: int, want) -> int:
    try:
        return reference.index_mismatch(blobs, n, b, want)
    except ValueError:                  # not a decodable table of n * b bits
        return n


def check(ctx, rec) -> dict:
    """Compare every step fed with the reference chain; limits are 0."""
    import torch
    outs, dev = rec["ranks_out"], ctx.device
    head = outs[0]
    fed, warm = head["fed"], head["warm"]
    pool = [torch.from_numpy(x).to(dev) for x in rec["pool"]]
    n = pool[0].numel()
    stated = reference.stated(ctx.config)
    ranks, block_bytes = len(outs), ctx.config["params"]["block_bytes"]
    sampled = _sampled(outs)
    have = min(len(o["tally"]["b"]) for o in outs)
    bad_headers = bad_exc = bad_idx = bad_owner = bad_setup = 0
    for t, enc, curr, _ in reference.follow(pool, fed, **stated):
        i = t - 1
        if i >= have:
            break
        b, centers, exc = _join(outs, i)
        if b != enc["b"] or reference.bits_differ(enc["centers"], centers):
            bad_headers += 1
        bad_exc += reference.bits_differ(curr[enc["exc"]].cpu().numpy(),
                                         exc)
        want = reference_mp.owned(n, ranks, enc["b"], block_bytes)
        bad_owner += sum(tuple(o["owned"][i]) != want[o["rank"]]
                         for o in outs)
        if t in sampled:
            bad_idx += (n if b != enc["b"] else
                        _index_differ(sampled[t], n, b, enc["idx"]))
        if t < warm:
            st = rec["setup"][t]
            if (st.b_bits != enc["b"]
                    or reference.bits_differ(enc["centers"], st.centers)
                    or reference.bits_differ(curr[enc["exc"]].cpu().numpy(),
                                             st.incomp_values)
                    or _index_differ(st.index_blocks, n, enc["b"],
                                     enc["idx"])):
                bad_setup += 1
    anchor = rec["setup"][0]
    try:
        raw = b"".join(reference.decode_block(x)
                       for x in anchor.index_blocks)
    except ValueError:
        raw = b""
    bad_setup += int(raw != rec["pool"][fed[0]].tobytes())
    del pool
    digest = {o["pool_sha256"] for o in outs} | {rec["pool_sha256"]}
    cards = [o["card"] for o in outs if o["card"] is not None]
    rec["summary"].update(checked_steps=have, sampled_steps=sorted(sampled))
    return {"bad_headers": {"value": bad_headers, "limit": 0},
            "bad_exceptions": {"value": bad_exc, "limit": 0},
            "bad_indices": {"value": bad_idx, "limit": 0},
            "missing_steps": {"value": len(fed) - 1 - have, "limit": 0},
            "bad_ownership": {"value": bad_owner, "limit": 0},
            "bad_setup_steps": {"value": bad_setup, "limit": 0},
            "pools_differ": {"value": len(digest) - 1, "limit": 0},
            "ranks_sharing_a_card": {"value": len(cards) - len(set(cards)),
                                     "limit": 0},
            "forbidden_modules": {"value": sum(len(o["forbidden"])
                                               for o in outs), "limit": 0}}


def control_record(ctx, dtype, steps: int) -> dict:
    """A run's record with the reference in ``dtype`` in every rank's
    place (``portbench/control.py``'s control for this driver): ``steps``
    deltas in the cell's order, each rank owning what ``reference_mp``
    gives it, rank 0 holding every exception and a stored (v0) blob of
    each whole index table, the set-up steps read back as the same."""
    from portbench import control
    from portbench.harness import _load
    stream = _load(HERE / "stream.py")
    pool_dev = gen.make_pool(ctx.config, ctx.traffic["pool_steps"],
                             ctx.seed, ctx.device)
    pool = [x.cpu().numpy() for x in pool_dev]
    seq = stream.order(len(pool))
    fed = [next(seq) for _ in range(steps + 1)]
    ranks, n = int(ctx.config["ranks"]), pool[0].size
    warm = 1 + ctx.traffic["warmup_steps"]
    raw = pool[fed[0]].tobytes()
    setup = [SimpleNamespace(index_blocks=[
        struct.pack("<IB", len(raw), 0) + raw])]
    outs = [dict(rank=r, card=None, forbidden=[], owned=[],
                 pool_sha256=_digest(pool), fed=fed, warm=warm,
                 tally=dict(b=[], centers=[], exc=[], kept={}, last=None))
            for r in range(ranks)]
    for t, enc, curr, _ in reference.follow(
            pool_dev, fed, dtype=dtype, **reference.stated(ctx.config)):
        st = control._step(enc, curr)
        owned = reference_mp.owned(n, ranks, st.b_bits,
                                   ctx.config["params"]["block_bytes"])
        for o in outs:
            mine = o["rank"] == 0
            tl = o["tally"]
            tl["b"].append(st.b_bits)
            tl["centers"].append(st.centers if mine else None)
            tl["exc"].append(st.incomp_values if mine
                             else np.zeros(0, np.float32))
            tl["kept"][t] = st.index_blocks if mine else []
            tl["last"] = (t, tl["kept"][t])
            o["owned"].append(owned[o["rank"]])
        if t < warm:
            setup.append(st)
    return dict(pool=pool, pool_sha256=_digest(pool), ranks_out=outs,
                setup=setup, summary={})


__all__ = ["run", "check", "control_record"]
