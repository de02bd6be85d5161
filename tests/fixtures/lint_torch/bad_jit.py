"""Fixture: built-or-traced-once violations and sanctioned shapes."""
import ctypes
import functools

import torch


@torch.compile
def module_level_ok(x):                       # sanctioned: module decorator
    return x + 1


@functools.partial(torch.compile, dynamic=False)
def module_partial_ok(x):                     # sanctioned: partial decorator
    return x * 2


_MODULE_FN = torch.compile(lambda x: x)       # sanctioned: module assignment


def _encode(x):
    f = torch.compile(lambda y: y + 1)        # violation: per-call lambda
    return f(x)


def hot_loop(xs):
    out = []
    for x in xs:
        out.append(torch.jit.trace(step, x))  # violation: per-call trace
    return out


def step(x):
    return x


class Cached:
    def build(self, key, path):
        lib = ctypes.CDLL(path)
        self._libs[key] = lib                 # sanctioned: keyed two-step
        return self._libs[key]

    def build_direct(self, key, src):
        self._libs[key] = torch.utils.cpp_extension.load_inline(key, src)
        return self._libs[key]                # sanctioned: keyed store

    def __init__(self):
        self._libs = {}
        self._one = torch.jit.script(step)    # violation: unkeyed store
        self._graph = torch.cuda.CUDAGraph()  # violation: unkeyed capture
