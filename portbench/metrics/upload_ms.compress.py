"""Stream cells: the program's sync.upload spans (the pageable copy of each
step to the card), ms a delta step of the traced window."""


def read(rec):
    if rec["kind"] != "stream" or not rec["steps"]:
        return None
    total = [d for name, d, _ in rec["spans"] if name == "sync.upload"]
    return sum(total) / rec["steps"] * 1e3 if total else None
