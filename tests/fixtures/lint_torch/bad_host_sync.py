"""Fixture: device-resident functions with forbidden host syncs."""
import numpy as np
import torch

from repro_torch.obs import telemetry


def encode_device(x, a):
    h = np.asarray(x)                      # violation: np.asarray
    b = x.item()                           # violation: .item()
    torch.cuda.synchronize()               # violation: explicit sync
    c = float(a["b_auto"])                 # violation: scalar dict fetch
    d = float(1.5)                         # NOT a violation: plain scalar
    tele = telemetry.enabled()
    if tele:
        torch.cuda.synchronize()           # exempt: telemetry-gated
    e = x.cpu()                            # violation: .cpu()
    f = x.tolist()                         # violation: .tolist()
    g = int(torch.argmin(x))               # violation: scalar of a torch call
    k = int(a.b_bits)                      # NOT a violation: host attribute
    return h, b, c, d, e, f, g, k


def analyze_device(x):
    return x.numpy()                       # violation: the per-shard stage


def host_helper(x):
    return np.asarray(x).item()            # NOT a violation: unregistered
