"""ReferenceChain: one owner for the prev->recon temporal state.

The paper's temporal chain -- "reconstructed data of step i becomes the
reference of step i+1" (Sec. III) -- with two residencies, as in the
reference's ``core/chain.py``:

  host    -- NumPy state, advanced by ``pipeline.reconstruct_from_indices``.
  device  -- a torch tensor on the compressor's device, advanced by the
             fused chain-advance kernel (``kernels.ops.chain_advance``), so
             the state never round-trips through the host between steps.

Both are bit-identical: reconstruction runs in the source precision on
every path (``pipeline.reconstruction_dtype``).  torch holds float64
natively, so unlike the reference the device chain takes f64 data too;
residency never changes output.

Telemetry: each advance is a ``chain.advance`` span; the device chain's
host-to-device copies are ``sync.chain_*`` spans inside it.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core import pipeline as pipe
from repro_torch.core.tree import map_with_keys
from repro_torch.kernels import ops as kops
from repro_torch.obs import telemetry

CHAIN_HOST = "host"
CHAIN_DEVICE = "device"
CHAIN_AUTO = "auto"
RESIDENCIES = (CHAIN_HOST, CHAIN_DEVICE, CHAIN_AUTO)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another.  A CUDA device with no GPU present raises; nothing carries on
    on the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions")
    return dev


def device_supports(dtype) -> bool:
    """Can a device-resident chain hold `dtype` bit-exactly?  f32 and f64;
    narrower floats must round to their own dtype every step, which the
    host chain does explicitly."""
    return np.dtype(dtype) in (np.dtype(np.float32), np.dtype(np.float64))


def check_residency(requested: str) -> str:
    """`requested` if it names a residency, else ValueError."""
    if requested not in RESIDENCIES:
        raise ValueError(f"unknown chain residency {requested!r}; "
                         f"expected one of {RESIDENCIES}")
    return requested


def resolve_residency(requested: str, dtype) -> str:
    """Residency policy: honor an explicit choice, pick for "auto"."""
    if check_residency(requested) == CHAIN_HOST:
        return CHAIN_HOST
    supported = device_supports(dtype)
    if requested == CHAIN_DEVICE and not supported:
        raise ValueError(
            f"device-resident chain cannot hold dtype {np.dtype(dtype)} "
            "bit-exactly; use chain='host' or 'auto'")
    return CHAIN_DEVICE if supported else CHAIN_HOST


class ReferenceChain:
    """Owns the prev->recon temporal state of one variable.

    Lifecycle: ``seed(arr)`` on the anchor step, then per delta step
    either ``advance(dev, curr)`` (REF_RECONSTRUCTED) or ``replace(arr)``
    (REF_ORIGINAL).  ``peek()`` hands the state to the encode stage in the
    chain's own residency; ``to_host()`` returns a private host copy.
    Chains treat their state as immutable (every ``seed`` and ``advance``
    builds a new one), so ``fork()`` is a cheap handle copy: a consumer
    that must stage an advance and commit it later (the checkpoint
    manager, after the step file is durable) forks, advances the fork and
    swaps it in.
    """

    residency: str = "?"

    def __init__(self):
        self._state: Optional[Any] = None

    @property
    def empty(self) -> bool:
        return self._state is None

    def reset(self) -> None:
        self._state = None

    def fork(self) -> "ReferenceChain":
        return copy.copy(self)

    def seed(self, arr) -> None:
        raise NotImplementedError

    def replace(self, arr) -> None:
        self.seed(arr)

    def advance(self, dev: pipe.DeviceEncoded, curr) -> None:
        raise NotImplementedError

    def peek(self):
        return self._state

    def to_host(self) -> np.ndarray:
        raise NotImplementedError


class HostReferenceChain(ReferenceChain):
    """NumPy-resident chain."""

    residency = CHAIN_HOST

    def seed(self, arr) -> None:
        # Private copy: callers may reuse/mutate their buffers.
        self._state = np.array(np.asarray(arr), copy=True)

    def advance(self, dev: pipe.DeviceEncoded, curr) -> None:
        with telemetry.span("chain.advance"):
            self._state = pipe.reconstruct_from_indices(
                self._state, dev.enc, dev.centers, self._state.dtype,
                curr=np.asarray(curr))

    def to_host(self) -> np.ndarray:
        return self._state.copy()


class DeviceReferenceChain(ReferenceChain):
    """Tensor-resident chain on ``device``, advanced by the fused
    chain-advance kernel (its plain version on a CPU device)."""

    residency = CHAIN_DEVICE

    def __init__(self, device: torch.device):
        super().__init__()
        self.device = torch.device(device)
        self._shape: Optional[tuple] = None

    def seed(self, arr) -> None:
        arr = np.asarray(arr)
        if not device_supports(arr.dtype):
            raise ValueError(f"device chain cannot hold {arr.dtype} "
                             "bit-exactly")
        # torch.tensor copies: a CPU tensor from torch.from_numpy would
        # alias the caller's buffer, which callers may reuse at once.
        self._state = torch.tensor(arr, device=self.device)
        self._shape = tuple(arr.shape)

    def advance(self, dev: pipe.DeviceEncoded, curr) -> None:
        with telemetry.span("chain.advance"):
            curr_dev = dev.curr_dev
            if curr_dev is None:
                with telemetry.span("sync.chain_curr"):
                    curr_dev = torch.tensor(np.asarray(curr),
                                            device=self.device)
            # Centers are a float64 view of values already rounded to the
            # data dtype, so this cast is exact.
            with telemetry.span("sync.chain_centers"):
                centers = torch.as_tensor(dev.centers, device=self.device)
            centers = centers.to(self._state.dtype)
            new = kops.chain_advance(dev.idx_dev.reshape(-1),
                                     self._state.reshape(-1),
                                     curr_dev.reshape(-1), centers,
                                     b_bits=dev.enc.b_bits)
            self._state = new.reshape(self._shape)

    def to_host(self) -> np.ndarray:
        return self._state.cpu().numpy().copy()


def make_reference_chain(residency: str, dtype,
                         device: torch.device) -> ReferenceChain:
    """Factory used by the single-device compressor."""
    if resolve_residency(residency, dtype) == CHAIN_DEVICE:
        return DeviceReferenceChain(device)
    return HostReferenceChain()


# -- serve-side session state ----------------------------------------------

def tree_to_host(tree) -> Any:
    """A private host copy of a tree: tensors become CPU tensors (which
    keep bfloat16, where numpy has none), other leaves ndarrays."""
    return map_with_keys(lambda _, x: (x.detach().to("cpu", copy=True)
                                       if isinstance(x, torch.Tensor)
                                       else np.array(x)), tree)


class SessionChain:
    """Handle for device-resident session state (a tree of tensors).

    The serve-side analogue of a ReferenceChain: decode caches, resume
    token and position stay on the device between requests; ``to_host()``
    is the explicit durable-write boundary (session snapshots to disk).
    """

    def __init__(self, tree: Dict[str, Any]):
        self._tree = tree

    def __getitem__(self, key: str):
        return self._tree[key]

    @property
    def tree(self) -> Dict[str, Any]:
        return self._tree

    def to_host(self) -> Dict[str, Any]:
        return tree_to_host(self._tree)


__all__ = ["ReferenceChain", "HostReferenceChain", "DeviceReferenceChain",
           "SessionChain", "make_reference_chain", "resolve_residency",
           "check_residency", "resolve_device", "device_supports",
           "tree_to_host", "CHAIN_HOST", "CHAIN_DEVICE", "CHAIN_AUTO",
           "RESIDENCIES"]
