"""Stream cells: input bytes of every step finalized in the window over the
window's seconds (1e6 bytes a MB), host clock."""


def read(rec):
    if rec["kind"] != "stream":
        return None
    return rec["bytes_in"] / rec["window_s"] / 1e6
