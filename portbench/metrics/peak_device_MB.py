"""torch.cuda.max_memory_allocated() over the window (reset at its open), 1e6
bytes a MB: memory the compressor takes from the simulation that owns the
card."""


def read(rec):
    return rec["peak_bytes"] / 1e6 if rec["peak_bytes"] else None
