"""Stream cells: the program's sync.* spans (one for each call that blocks
the host on the card), counted a delta step of the traced window."""


def read(rec):
    if rec["kind"] != "stream" or not rec["steps"]:
        return None
    n = sum(1 for name, _, _ in rec["spans"] if name.startswith("sync."))
    return n / rec["steps"] if n else None
