"""Multi-process stream cells: the summed durations of rank 0's coll.* spans
(each collective from its local fold through its exchange to the copy
back, the waits on the other ranks included), ms a delta step of the
traced window."""


def read(rec):
    coll = rec.get("coll_spans")
    if rec["kind"] != "stream" or not coll or not rec["steps"]:
        return None
    return sum(d for _, d, _ in coll) / rec["steps"] * 1e3
