"""Stream cells: the program's upload.stage spans (each delta step staged
through host memory, its copies to the card sent without a wait), ms a
delta step of the traced window."""


def read(rec):
    if rec["kind"] != "stream" or not rec["steps"]:
        return None
    total = [d for name, d, _ in rec["spans"] if name == "upload.stage"]
    return sum(total) / rec["steps"] * 1e3 if total else None
