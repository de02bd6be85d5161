"""Multi-process stream cells: 95th percentile, over the window's steps that
every rank finished after rank 0's profiled part (the profiler runs on
rank 0 alone; every rank records its spans alike), of the latest rank's
finish of a step minus the earliest's (each rank's host clock at the
step's finished fragment; the monotonic clock that the processes of one
host share)."""

import numpy as np


def read(rec):
    done = rec.get("done_at")
    if rec["kind"] != "stream" or not done or len(done) < 2:
        return None
    steps = min(len(d) for d in done)
    at = np.array([d[:steps] for d in done]).reshape(len(done), steps)
    at = at[:, at.min(axis=0) > rec["profiled_until"]]
    if not at.shape[1]:
        return None
    return float(np.percentile(at.max(axis=0) - at.min(axis=0), 95)) * 1e3
