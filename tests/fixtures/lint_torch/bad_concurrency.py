"""Fixture: concurrency-discipline violations."""
import threading

import torch

from repro_torch.core.overlap import FinalizeQueue

_pool_lock = threading.Lock()
_shared_proc_pool = None


def blocking_under_lock(fut, x):
    with _pool_lock:
        r = fut.result()                      # violation: blocks under lock
        torch.cuda.synchronize()              # violation: device sync under lock
    return r


def fine_under_lock(items):
    with _pool_lock:
        items.append(1)                       # fine: bounded critical section
    return items


def ungated_dispatch(fn, blob):
    pool = _shared_proc_pool                  # violation: no holds_gil check
    return pool.submit(fn, blob)


def gated_dispatch(codec, fn, blob):
    if codec.holds_gil:
        pool = _shared_proc_pool              # fine: behind holds_gil
        return pool.submit(fn, blob)
    return fn(blob)


def unlabeled_submit(overlap, fn, x):
    _q = FinalizeQueue(overlap)
    _q.submit(fn, x)                          # violation: no label=
    _q.submit(fn, x, label="step 3")          # fine
    return _q
