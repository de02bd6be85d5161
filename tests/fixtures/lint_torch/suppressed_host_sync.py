"""Fixture: every suppression placement the framework supports."""


def encode_device(x):
    a = x.cpu()   # repro-lint: disable=host-sync-in-device-path
    # repro-lint: disable=host-sync-in-device-path
    b = x.item()
    return a, b


# repro-lint: disable=host-sync-in-device-path
def decompress_step_device(x):
    # def-line (or line above def) suppression covers the whole body
    a = x.cpu()
    b = x.tolist()
    return a, b
