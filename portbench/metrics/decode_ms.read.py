"""Read cells: the program's decode.* spans (entropy, dequantize, patch,
fetch), ms a step of the traced window."""


def read(rec):
    if rec["kind"] != "read" or not rec["steps"]:
        return None
    total = [d for name, d, _ in rec["spans"] if name.startswith("decode.")]
    return sum(total) / rec["steps"] * 1e3 if total else None
