"""Read cells: bytes of reconstruction delivered to the caller over the
window's seconds (1e6 bytes a MB), host clock."""


def read(rec):
    if rec["kind"] != "read":
        return None
    return rec["bytes_out"] / rec["window_s"] / 1e6
