"""Stream cells: the program's encode.* spans (analyze, index, exceptions,
device entropy, pack and fetch), ms a delta step of the traced window."""


def read(rec):
    if rec["kind"] != "stream" or not rec["steps"]:
        return None
    total = [d for name, d, _ in rec["spans"] if name.startswith("encode.")]
    return sum(total) / rec["steps"] * 1e3 if total else None
