"""Stream cells: the summed durations of the program's sync.* spans, the
time the host was blocked on the card, ms a delta step of the traced
window."""


def read(rec):
    if rec["kind"] != "stream" or not rec["steps"]:
        return None
    total = [d for name, d, _ in rec["spans"] if name.startswith("sync.")]
    return sum(total) / rec["steps"] * 1e3 if total else None
