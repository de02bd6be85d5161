"""Input bytes over stored bytes (paper Eq. 2). Stream cells: every window step
as the NCK container lays it out; read cells: the whole file."""


def read(rec):
    if rec["kind"] == "stream":
        return rec["bytes_in"] / rec["bytes_stored"]
    return rec["bytes_raw"] / rec["bytes_stored"]
