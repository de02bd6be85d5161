"""Read cells: the bytes that the steps finished in the profiled part of the
window must move (yardstick.read_step_bytes) at the card's peak bandwidth,
over the device kernel time of that part (the union of kernel intervals), in
percent."""

from portbench.yardstick import HBM_BYTES_PER_S


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "read" or not tr or not tr["kernel_s"]:
        return None
    return 100.0 * rec["roofline_bytes"] / HBM_BYTES_PER_S / tr["kernel_s"]
