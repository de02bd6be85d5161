"""Read cells: an analyst reads an archived series back, again and again.

Set-up makes ``series_steps`` consecutive steps of the data set on the
device from the seed, compresses them with ``compress_series`` (the
anchor and the deltas) and writes them once to one NCK file in the
temporary directory, then reads the series once to warm up.  The window
reads the whole series again and again: ``NCKReader.read_step`` and
``TemporalDecompressor.add``, each step handed to the caller as a host
array.  The file stays in the page cache: reads are warm.

The check walks the reference chain over the series and compares a
sample of the reconstructions delivered (drawn from the seed, and the
last one) bit for bit; it also compares every stored step's B, centers
and exception values, and the index tables of a sample of them decoded
by the reference.
"""
from __future__ import annotations

import os
import random
import tempfile
import time

from portbench import gen, reference, yardstick
from portbench.harness import per_second


def run(ctx) -> dict:
    import torch
    from repro_torch.core.compress import (TemporalDecompressor,
                                           compress_series)
    from repro_torch.core.container import NCKReader
    from repro_torch.core.partial import TemporalArchive
    from repro_torch.core.types import NumarckParams

    tr = ctx.traffic
    params = NumarckParams(**ctx.config["params"], **tr["params"])
    pool = [x.cpu().numpy() for x in gen.make_pool(
        ctx.config, tr["series_steps"], ctx.seed, ctx.device)]
    n, item = pool[0].size, pool[0].itemsize
    steps = compress_series(pool, params, device=ctx.device)
    fd, path = tempfile.mkstemp(prefix="portbench-", suffix=".nck")
    os.close(fd)
    try:
        TemporalArchive.write(path, "v", steps)
        names = [TemporalArchive.step_name("v", i) for i in range(len(pool))]
        must = [yardstick.read_step_bytes(
            n, item, sum(len(b) for b in st.index_blocks),
            st.n_incompressible, st.is_anchor) for st in steps]
        rng = random.Random(ctx.seed)
        kept, last, short = {}, None, 0
        delivered, step_s, read_s = 0, [], []
        done_at, sizes, moved = [], [], []

        def read_series(window):
            nonlocal last, short, delivered
            reader = NCKReader(path)
            dec = TemporalDecompressor(ctx.device)
            for t, name in enumerate(names):
                if window is not None and not window.open():
                    return False
                t0 = time.perf_counter()
                with torch.profiler.record_function("portbench.read_step"):
                    st = reader.read_step(name)
                t1 = time.perf_counter()
                with torch.profiler.record_function("portbench.decompress"):
                    out = dec.add(st)
                t2 = time.perf_counter()
                if window is None:
                    continue
                read_s.append(t1 - t0)
                step_s.append(t2 - t0)
                done_at.append(t2)
                sizes.append(out.nbytes)
                delivered += out.nbytes
                moved.append(must[t])
                short += out.size != n
                k = len(step_s)
                key = (k, t)
                if len(kept) < tr["sample_steps"]:
                    kept[key] = out
                else:
                    j = rng.randrange(k)
                    if j < tr["sample_steps"]:
                        del kept[sorted(kept)[j]]
                        kept[key] = out
                last = (key, out)
            return True

        read_series(None)
        with ctx.window() as w:
            while read_series(w):
                pass
        file_bytes = os.path.getsize(path)
        trace_steps, trace_bytes = w.traced(done_at, moved)
    finally:
        os.remove(path)
    if ctx.cuda:
        torch.cuda.empty_cache()
    kept[last[0]] = last[1]
    rec = dict(kind="read", pool=pool, steps_stored=steps, kept=kept,
               attempted=len(step_s), failed=0, steps=len(step_s),
               short=short, window_s=w.seconds, setup_s=w.setup_s,
               bytes_out=delivered, bytes_raw=len(pool) * n * item,
               bytes_stored=file_bytes,
               memory_peak_bytes=max(w.peak, w.setup_peak),
               peak_bytes=w.peak, step_s=step_s, nck_read_s=read_s,
               spans=w.spans, trace=w.trace, trace_steps=trace_steps,
               roofline_bytes=trace_bytes)
    rec["summary"] = dict(steps=len(step_s), window_s=w.seconds,
                          setup_s=w.setup_s, traced=ctx.trace,
                          MBps=delivered / w.seconds / 1e6,
                          file_bytes=file_bytes,
                          per_s=per_second(done_at, sizes, w.t0,
                                           ctx.seconds),
                          b=[st.b_bits for st in steps[1:]])
    return rec


def check(ctx, rec) -> dict:
    """Compare the stored steps and the sampled reconstructions with the
    reference chain; limits are 0."""
    import torch
    pool = [torch.from_numpy(x).to(ctx.device) for x in rec["pool"]]
    steps = rec["steps_stored"]
    n = pool[0].numel()
    wanted = {t for _, t in rec["kept"]}
    chain = {0: pool[0].cpu().numpy().reshape(-1)}
    rng = random.Random(ctx.seed ^ 0x5EED)
    decode = set(rng.sample(range(1, len(pool)),
                            min(ctx.traffic["decode_steps"], len(pool) - 1)))
    bad_headers = bad_exc = bad_idx = 0
    for t, enc, curr, state in reference.follow(
            pool, list(range(len(pool))), **reference.stated(ctx.config)):
        st = steps[t]
        if st.b_bits != enc["b"] or reference.bits_differ(enc["centers"],
                                                          st.centers):
            bad_headers += 1
        bad_exc += reference.bits_differ(curr[enc["exc"]].cpu().numpy(),
                                         st.incomp_values)
        if t in decode:
            bad_idx += (n if st.b_bits != enc["b"] else
                        reference.index_mismatch(st.index_blocks, n,
                                                 enc["b"], enc["idx"]))
        if t in wanted:
            chain[t] = state.cpu().numpy()
    del pool
    bad_recon = sum(reference.bits_differ(chain[t], out)
                    for (_, t), out in rec["kept"].items())
    rec["summary"].update(recon_checked=len(rec["kept"]),
                          decoded=sorted(decode))
    return {"bad_headers": {"value": bad_headers, "limit": 0},
            "bad_exceptions": {"value": bad_exc, "limit": 0},
            "bad_indices": {"value": bad_idx, "limit": 0},
            "bad_recon": {"value": bad_recon, "limit": 0},
            "short_steps": {"value": rec["short"], "limit": 0}}


__all__ = ["run", "check"]
