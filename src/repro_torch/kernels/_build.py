"""Build the port's CUDA sources with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into
``build/repro_torch_kernels/lib<name>-<hash>.so`` with a plain C interface
(seconds per source, where ``torch.utils.cpp_extension.load`` takes
minutes).  The hash covers the sources and the flags, so an edited source
is rebuilt and an unchanged one is reused.  The first kernel call builds
every source at once, one nvcc per source, all started together.

Nothing here runs at import: the CPU tests import every module on hosts
that have no nvcc and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

import torch

# The kernels build from a source checkout (``PYTHONPATH=src``): the
# package data does not ship csrc/, and the libraries go into the
# checkout's build/ (this file is <repo>/src/repro_torch/kernels).
CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("change_ratio", "hist", "bitpack", "dequant", "rans")
# IEEE division and square root, denormals kept, no FMA contraction: the
# port's contract is byte identity with the reference, and one ulp at a
# bin edge moves a bin id.  Never add --use_fast_math.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
              "-fmad=false")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> float:
    """Compile every listed source whose library is missing, all at once;
    return the wall seconds spent.  Raises with nvcc's output on failure."""
    t0 = time.perf_counter()
    missing = [n for n in names if not (CSRC / f"{n}.cu").is_file()]
    if missing:
        raise RuntimeError(f"CUDA sources {missing} are not in {CSRC}: the "
                           "kernels build from a source checkout of the "
                           "repo (PYTHONPATH=src)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, so, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"--- {name}.cu (exit {proc.returncode})\n"
                          + out.decode(errors="replace"))
        else:
            # a build output, not a durable publish: a lost library is
            # rebuilt, and the rename keeps readers off a half-written one
            os.replace(tmp, so)  # repro-lint: disable=format-closure
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all sources at
    the first call."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build()
            for n in SOURCES:
                _libs[n] = ctypes.CDLL(str(library_path(n)))
            lib = _libs[name]
        return lib


class Kernel:
    """One CUDA kernel: its C entry points in ``csrc/<lib>.cu`` (``lib``
    defaults to the kernel's name) and a count of launches.

    ``launches`` is a plain integer that :meth:`launch` raises by one per
    successful launch and nothing else touches, so a caller can reset it
    and read it back to show that a run went through the kernel.
    """

    route = "cuda"

    def __init__(self, name: str, replaces: str, lib: str = ""):
        self.name = name
        self.lib = lib or name
        self.source = f"src/repro_torch/csrc/{self.lib}.cu"
        self.replaces = replaces
        self.launches = 0
        self._fns: Dict[str, object] = {}

    def launch(self, symbol: str, argtypes: Sequence, *args) -> None:
        """Call entry point ``symbol`` on PyTorch's current stream (appended
        as the last argument) and raise if the launch was refused."""
        fn = self._fns.get(symbol)
        if fn is None:
            lib = library(self.lib)
            fn = getattr(lib, symbol)
            fn.argtypes = [*argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{self.lib}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fns[symbol] = fn
            self._fns[f"{symbol}:err"] = err
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            msg = self._fns[f"{symbol}:err"](rc).decode()
            raise RuntimeError(f"{self.name}: {symbol} failed with CUDA "
                               f"error {rc} ({msg})")
        self.launches += 1


def check_cuda(name: str, t: torch.Tensor, dtypes, numel=None) -> None:
    """Raise unless ``t`` is a contiguous tensor on the current CUDA device,
    of one of ``dtypes`` (and ``numel`` elements, when given)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.device.index != torch.cuda.current_device():
        # The kernels launch on the current device's current stream.
        raise ValueError(f"{name} is on {t.device}, but the current CUDA "
                         f"device is {torch.cuda.current_device()}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name} must have {numel} elements, "
                         f"got {t.numel()}")


__all__ = ["BUILD_DIR", "CSRC", "SOURCES", "NVCC_FLAGS", "Kernel", "build",
           "library", "library_path", "check_cuda", "nvcc"]
