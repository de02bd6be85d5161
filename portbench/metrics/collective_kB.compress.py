"""Multi-process stream cells: the bytes that every rank sent in its coll.*
spans (their ``bytes`` attribute), summed over the ranks, kB a delta
step of the traced window (1e3 bytes a kB)."""


def read(rec):
    sent = rec.get("coll_bytes")
    if (rec["kind"] != "stream" or not sent or not any(sent)
            or not rec["steps"]):
        return None
    return sum(sent) / rec["steps"] / 1e3
