"""Read cells: 95th percentile of the host time of one step's read (read_step
and TemporalDecompressor.add), over every step of the traced window."""

import numpy as np


def read(rec):
    if rec["kind"] != "read" or not rec["step_s"]:
        return None
    return float(np.percentile(rec["step_s"], 95)) * 1e3
