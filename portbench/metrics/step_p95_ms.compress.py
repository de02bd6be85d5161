"""Stream cells: 95th percentile of the host time from add_async to the
finished step, over every step of the traced window."""

import numpy as np


def read(rec):
    if rec["kind"] != "stream" or not rec["step_s"]:
        return None
    return float(np.percentile(rec["step_s"], 95)) * 1e3
