"""Stream cells: a simulation hands the compressor each output step as it
is produced.

Set-up makes ``pool_steps`` consecutive steps of the data set on the
device from the seed and keeps them in host memory, compresses the anchor
(step 0) and ``warmup_steps`` deltas.  The window then feeds the pool in
the order 0, 1, ..., K-1, K-2, ..., 1, 0, 1, ... (forward, then back: a
reversed change ratio is 1/(1+r), so every step keeps the data set's
statistics and none jumps back) through ``TemporalCompressor.add_async``,
with at most ``max_pending`` steps outstanding, as ``compress_series``
keeps them.  Each finished step is tallied and dropped; no file is
written.

The check walks the reference chain over every step fed, set-up's
included, and compares each step's B, centers and exception values, and
the index tables of a sample of steps drawn from the seed (and of the
last), decoded by the reference.
"""
from __future__ import annotations

import random
import time
from collections import deque

from portbench import gen, reference, yardstick
from portbench.harness import per_second


def order(k: int):
    """0, 1, ..., k-1, k-2, ..., 1, 0, 1, ... forever."""
    i, step = 0, 1
    while True:
        yield i
        if not 0 <= i + step < k:
            step = -step
        i += step


def _params(ctx):
    from repro_torch.core.types import NumarckParams
    return NumarckParams(**ctx.config["params"], **ctx.traffic["params"])


class _Tally:
    """Per-step records kept for the check: the cheap parts of every step,
    the index blocks of a reservoir sample (and of the last step)."""

    def __init__(self, seed: int, sample: int):
        self.rng = random.Random(seed)
        self.sample = sample
        self.b, self.centers, self.exc, self.stored = [], [], [], []
        self.kept = {}            # t -> index blocks
        self.last = None

    def add(self, t: int, st) -> None:
        self.b.append(st.b_bits)
        self.centers.append(st.centers)
        self.exc.append(st.incomp_values)
        self.stored.append(st.nbytes)
        k = len(self.b)
        if len(self.kept) < self.sample:
            self.kept[t] = st.index_blocks
        else:
            j = self.rng.randrange(k)
            if j < self.sample:
                del self.kept[sorted(self.kept)[j]]
                self.kept[t] = st.index_blocks
        self.last = (t, st.index_blocks)


def run(ctx) -> dict:
    import torch
    from repro_torch.core.compress import TemporalCompressor

    tr = ctx.traffic
    params = _params(ctx)
    pool = [x.cpu().numpy() for x in gen.make_pool(
        ctx.config, tr["pool_steps"], ctx.seed, ctx.device)]
    n, item = pool[0].size, pool[0].itemsize
    seq = order(len(pool))
    comp = TemporalCompressor(params, device=ctx.device)
    fed = [next(seq)]
    comp.add(pool[fed[0]])                         # the anchor
    tally = _Tally(ctx.seed, tr["sample_steps"])
    for _ in range(tr["warmup_steps"]):
        fed.append(next(seq))
        tally.add(len(fed) - 1, comp.add(pool[fed[-1]]))
    warm = len(fed)
    step_s, done_at, must = [], [], []
    pending: deque = deque()

    def finish():
        t, fut, t0, done = pending.popleft()
        st = fut.result()
        done_at.append(done[0] if done else time.perf_counter())
        step_s.append(done_at[-1] - t0)
        must.append(yardstick.compress_step_bytes(n, item, st.b_bits,
                                                  st.n_incompressible))
        tally.add(t, st)

    with ctx.window() as w:
        while w.open():
            fed.append(next(seq))
            done = []
            t0 = time.perf_counter()
            with torch.profiler.record_function("portbench.add_async"):
                fut = comp.add_async(pool[fed[-1]])
            fut.add_done_callback(
                lambda _f, d=done: d.append(time.perf_counter()))
            pending.append((len(fed) - 1, fut, t0, done))
            while len(pending) > tr["max_pending"]:
                finish()
        while pending:
            finish()
    comp.close()
    del comp
    if ctx.cuda:
        torch.cuda.empty_cache()
    steps = len(fed) - warm
    trace_steps, trace_bytes = w.traced(done_at, must)
    stored = sum(tally.stored[warm - 1:])
    rec = dict(kind="stream", pool=pool, fed=fed, tally=tally,
               attempted=steps, failed=0, steps=steps,
               window_s=w.seconds, setup_s=w.setup_s,
               bytes_in=steps * n * item, bytes_stored=stored,
               memory_peak_bytes=max(w.peak, w.setup_peak),
               peak_bytes=w.peak, step_s=step_s,
               spans=w.spans, trace=w.trace, trace_steps=trace_steps,
               roofline_bytes=trace_bytes)
    rec["summary"] = dict(steps=steps, window_s=w.seconds,
                          setup_s=w.setup_s, traced=ctx.trace,
                          MBps=rec["bytes_in"] / w.seconds / 1e6,
                          b_last=tally.b[-1], exc_last=len(tally.exc[-1]),
                          per_s=per_second(done_at, [n * item] * steps,
                                           w.t0, ctx.seconds))
    return rec


def check(ctx, rec) -> dict:
    """Compare every step fed with the reference chain; limits are 0."""
    import torch
    tally, fed = rec["tally"], rec["fed"]
    dev = ctx.device
    pool = [torch.from_numpy(x).to(dev) for x in rec["pool"]]
    sampled = dict(tally.kept)
    sampled[tally.last[0]] = tally.last[1]
    n = pool[0].numel()
    bad_headers = bad_exc = bad_idx = 0
    for t, enc, curr, _ in reference.follow(pool, fed,
                                            **reference.stated(ctx.config)):
        i = t - 1
        if i >= len(tally.b):
            break
        if tally.b[i] != enc["b"] or reference.bits_differ(
                enc["centers"], tally.centers[i]):
            bad_headers += 1
        want_exc = curr[enc["exc"]].cpu().numpy()
        bad_exc += reference.bits_differ(want_exc, tally.exc[i])
        if t in sampled:
            bad_idx += (n if tally.b[i] != enc["b"] else
                        reference.index_mismatch(sampled[t], n, enc["b"],
                                                 enc["idx"]))
    del pool
    missing = len(fed) - 1 - len(tally.b)
    rec["summary"].update(checked_steps=len(tally.b),
                          sampled_steps=sorted(sampled))
    return {"bad_headers": {"value": bad_headers, "limit": 0},
            "bad_exceptions": {"value": bad_exc, "limit": 0},
            "bad_indices": {"value": bad_idx, "limit": 0},
            "missing_steps": {"value": missing, "limit": 0}}


__all__ = ["run", "check", "order"]
