"""Stream cells: kernels launched on the card a delta step (torch.profiler over
the profiled part of the window), a count."""


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "stream" or not tr or not tr["kernels"]:
        return None
    return tr["kernels"] / rec["trace_steps"]
