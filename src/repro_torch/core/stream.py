"""The per-step loop that every streaming compressor shares.

``StreamCompressor`` owns what a step of ``core.compress.TemporalCompressor``,
``distributed.pipeline.ShardedCompressor`` and
``distributed.pipeline.MultiProcessCompressor`` has in common: the
parameters, the overlap mode and the chain residency (checked at
construction), the ``FinalizeQueue``, the step counter, the choice of
anchor or delta, the reference chain's seed and its ``advance`` or
``replace``, the private copy a background finalize reads, the labelled
submit, and the series drain with at most two finalizes in flight.  Each
``add_async`` is one ``compress.step`` span.

A compressor supplies the four hooks in which they differ:

  _make_chain(dtype)           the reference chain of a new series
  _device_encode(prev, curr)   the device stages of a delta step, against
                               the chain's state -> ``DeviceEncoded``
  _finalize_anchor(arr)        the host finalize of an anchor
  _finalize(curr, dev)         the host finalize of a delta step

The two finalize hooks run on the queue (a background thread with
``overlap=True``); by default they are ``core.pipeline``'s
``finalize_anchor`` and ``finalize_step``.
"""
from __future__ import annotations

from collections import deque
from concurrent.futures import Future
from typing import Optional

import numpy as np

from repro_torch.core import chain as chainmod
from repro_torch.core import pipeline as pipe
from repro_torch.core.overlap import FinalizeQueue
from repro_torch.core.pipeline import DeviceEncoded
from repro_torch.core.types import REF_RECONSTRUCTED, NumarckParams
from repro_torch.obs import telemetry


class StreamCompressor:
    """Streaming compression of a temporal series (paper Sec. III): the
    first ``add`` after construction or ``reset()`` stores a lossless
    anchor, each later one a delta against the reference chain.
    ``overlap=True`` runs the host finalize of step i on a background
    thread while the next ``add_async`` drives the device encode of step
    i+1; results equal the serial path."""

    _queue = "finalize"             # the FinalizeQueue's span and metric name

    def __init__(self, params: NumarckParams, overlap: bool, chain: str):
        self.params = params
        self.overlap = overlap
        self.chain = chainmod.check_residency(chain)
        self._chain: Optional[chainmod.ReferenceChain] = None
        self._q = FinalizeQueue(overlap, name=self._queue)
        self._step = 0

    def _make_chain(self, dtype) -> chainmod.ReferenceChain:
        raise NotImplementedError

    def _device_encode(self, prev, curr: np.ndarray) -> DeviceEncoded:
        raise NotImplementedError

    def _finalize_anchor(self, arr: np.ndarray):
        return pipe.finalize_anchor(arr, self.params)

    def _finalize(self, curr: np.ndarray, dev: DeviceEncoded):
        return pipe.finalize_step(curr, dev.enc, dev.centers, dev.domain_lo,
                                  dev.width, self.params, dev.meta)

    def _submit(self, arr: np.ndarray, dev: DeviceEncoded,
                step_i: int) -> Future:
        # The background finalize reads `arr` (exception values), and
        # callers may reuse their buffers at once.
        curr = arr.copy() if self.overlap else arr
        return self._q.submit(self._finalize, curr, dev,
                              label=f"finalize step {step_i}")

    def add_async(self, arr: np.ndarray) -> Future:
        """Device-encode `arr` now; return a future of the finalized step.
        The reference chain advances before returning."""
        with telemetry.span("compress.step"):
            arr = np.asarray(arr)
            step_i, self._step = self._step, self._step + 1
            if self._chain is None or self._chain.empty:
                self._chain = self._make_chain(arr.dtype)
                self._chain.seed(arr)
                return self._q.submit(self._finalize_anchor, arr.copy(),
                                      label=f"anchor step {step_i}")
            dev = self._device_encode(self._chain.peek(), arr)
            if self.params.reference == REF_RECONSTRUCTED:
                self._chain.advance(dev, arr)
            else:
                self._chain.replace(arr)
            return self._submit(arr, dev, step_i)

    def add(self, arr: np.ndarray):
        return self.add_async(arr).result()

    def compress_series(self, arrays) -> list:
        """Compress a temporal series from a new anchor, with at most two
        finalizes in flight."""
        self.reset()
        out: list = []
        pending: deque = deque()
        for a in arrays:
            pending.append(self.add_async(a))
            while len(pending) > 2:
                out.append(pending.popleft().result())
        out.extend(f.result() for f in pending)
        return out

    def reference_state(self) -> Optional[np.ndarray]:
        """Host copy of the current chain state (None before the anchor)."""
        if self._chain is None or self._chain.empty:
            return None
        return self._chain.to_host()

    def flush(self):
        self._q.flush()

    def close(self):
        self._q.close()

    def reset(self):
        """Drop the temporal chain state (the next add stores an anchor)."""
        self._chain = None
        self._step = 0


__all__ = ["StreamCompressor"]
