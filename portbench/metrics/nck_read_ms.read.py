"""Read cells: the harness's own host timing around NCKReader.read_step, ms a
step (mean over the traced window)."""


def read(rec):
    if rec["kind"] != "read" or not rec["nck_read_s"]:
        return None
    return sum(rec["nck_read_s"]) / len(rec["nck_read_s"]) * 1e3
