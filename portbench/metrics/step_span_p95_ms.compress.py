"""Stream cells: 95th percentile of the program's compress.step spans (the
whole of TemporalCompressor.add_async), over every step of the traced
window: the program's own reading of step_p95_ms.compress."""

import numpy as np


def read(rec):
    if rec["kind"] != "stream":
        return None
    steps = [d for name, d, _ in rec["spans"] if name == "compress.step"]
    return float(np.percentile(steps, 95)) * 1e3 if steps else None
