"""Read cells: the share of the profiled part of the window in which no kernel,
copy or memset ran on the card (torch.profiler), in percent."""


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "read" or not tr or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
