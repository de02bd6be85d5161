"""Stream cells: the program's finalize span (exceptions, entropy stage,
assembly), ms a delta step of the traced window."""


def read(rec):
    if rec["kind"] != "stream" or not rec["steps"]:
        return None
    total = [d for name, d, _ in rec["spans"] if name == "finalize"]
    return sum(total) / rec["steps"] * 1e3 if total else None
