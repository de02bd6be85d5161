"""Fixture: the port's dtype hazards."""
import numpy as np
import torch


def u32_arithmetic(words, k):
    w = words.to(torch.uint32)
    a = w >> 3                                # violation: >> on uint32
    b = words.view(torch.uint32) + k          # violation: + on uint32
    c = w < 7                                 # violation: < on uint32
    d = w // 2                                # violation: // on uint32
    return a, b, c, d


def int64_masked_ok(words):
    w = words.to(torch.int64) & 0xFFFFFFFF
    return (w >> 3) + 1, w < 7, w // 2        # fine: int64 held


def step_bytes(step):
    return np.dtype(step.dtype).itemsize      # violation: bf16 has no np dtype


def step_dtype(name):
    return np.dtype(name.dtype)               # fine: the one resolver


def set_default():
    torch.set_default_dtype(torch.float64)    # violation: process-wide dtype
