"""Checkpoint manager: NUMARCK anchor+delta compression, atomic publish,
manifest, retention, corruption fallback, async save.

The port's counterpart of the reference's ``checkpoint/manager.py``, the
paper's motivating use-case: checkpoints form a temporal series per
tensor, so every `anchor_every`-th save is a lossless anchor and the rest
are NUMARCK deltas against the previous *reconstructed* state.

A tree is nested dicts, lists, tuples and NamedTuples whose leaves are
tensors, ndarrays or scalars -- a ``state_dict()`` is one.  A leaf's key
is the ``/``-joined path the reference forms from jax's tree paths (dict
keys, sequence indices as numbers, a NamedTuple's fields as ``.name``;
``core/tree.py``), and the step file holds the leaves in the
sorted order of those keys, so the same tree as numpy arrays gives the
reference's step files and ``MANIFEST.json`` byte for byte.  A
bfloat16 leaf (a tensor, or an ml_dtypes array) is a lossless anchor
recording ``dtype="bfloat16"`` over its 2-byte values, as the reference
stores it; the port holds those bytes as uint16 and never needs
ml_dtypes.

Layout:
    <dir>/step_000123.nck      one NCK container per step (all tensors)
    <dir>/MANIFEST.json        {steps: [...], anchors: [...]}

Fault tolerance:
  * atomic rename on both .nck and manifest, fsync'd before the rename --
    the manifest is only committed AFTER its step file is durable, and the
    per-tensor delta chains only advance then too
  * restore walks back past corrupted/incomplete files and records each
    skipped step in ``last_restore_report``
  * retention keeps the last `keep` checkpoints plus their anchors
  * async saves snapshot the tree to host memory on the caller's thread
    and return; one background worker ("ckpt-save") runs compress+write,
    with at most two saves in flight and a `wait()` barrier
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import chain as chainmod
from repro_torch.core import container
from repro_torch.core import pipeline as pipe
from repro_torch.core.compress import (decode_anchor, decompress_step,
                                       encode_device, make_anchor)
from repro_torch.core.container import NCKReader, NCKWriter
from repro_torch.core.overlap import FinalizeQueue
from repro_torch.core.tree import leaves_with_keys, map_with_keys, nest
from repro_torch.core.types import (NumarckParams, host_storage,
                                    storage_tensor)
from repro_torch.obs import telemetry


def _flatten(tree, snapshot: bool = False
             ) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """Host copy of a tree: each leaf's bytes in its storage dtype
    (bfloat16 as uint16) and each leaf's recorded dtype name.
    `snapshot=True` forces a private copy of leaves that live in host
    memory (async saves read the arrays on another thread after the
    caller may have mutated them in place; a CPU tensor's ``.numpy()``
    shares its memory)."""
    flat, dtypes = {}, {}
    for key, leaf in leaves_with_keys(tree):
        on_host = (leaf.device.type == "cpu" if isinstance(leaf, torch.Tensor)
                   else isinstance(leaf, np.ndarray))
        arr, dtypes[key] = host_storage(leaf)
        flat[key] = np.array(arr, copy=True) if snapshot and on_host else arr
    return flat, dtypes


class CheckpointManager:
    def __init__(self, directory: str,
                 params: NumarckParams = NumarckParams(error_bound=1e-3),
                 anchor_every: int = 4, keep: int = 3,
                 compress: bool = True, async_save: bool = False,
                 exempt_substrings: Tuple[str, ...] = ("scale", "step",
                                                       "pos_map"),
                 chain: str = chainmod.CHAIN_HOST, device=None):
        """`exempt_substrings`: tensor paths stored losslessly regardless
        (norm scales and counters are tiny but precision-critical).

        `chain`: residency of the per-tensor reference chains the deltas
        encode against ("host" default; "auto"/"device" keeps the
        reconstructed state on ``device`` between saves, one state copy of
        device memory).  Applied per tensor: tensors the device chain
        cannot hold bit-exactly get host chains.  `device` runs the encode
        and the read (CUDA unless the caller asks for another), and is
        where a restore puts leaves whose template lives on "meta"."""
        chainmod.check_residency(chain)
        self.dir = directory
        self.params = params
        self.anchor_every = max(1, anchor_every)
        self.keep = keep
        self.compress = compress
        self.async_save = async_save
        self.exempt = exempt_substrings
        self.device = chainmod.resolve_device(device)
        # Populated by restore_latest: steps it had to skip and why.
        self.last_restore_report: List[Dict] = []
        self.chain = chain
        os.makedirs(directory, exist_ok=True)
        # One ReferenceChain per tensor path: the prev->recon state every
        # delta encodes against.
        self._recon_state: Dict[str, chainmod.ReferenceChain] = {}
        self._save_count = 0
        # Single worker serializes compress+write (manifest ordering stays
        # trivially correct); the queue bounds in-flight saves at two.
        self._q = FinalizeQueue(overlap=True, name="ckpt-save")

    # ------------------------------------------------------------------ io
    def _manifest_path(self) -> str:
        return os.path.join(self.dir, "MANIFEST.json")

    def _step_path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}.nck")

    def _read_manifest(self) -> Dict:
        try:
            with open(self._manifest_path()) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return {"steps": [], "anchors": []}

    def _write_manifest(self, m: Dict):
        container.atomic_commit(self._manifest_path(),
                                json.dumps(m, indent=1).encode())

    # ---------------------------------------------------------------- save
    def save(self, step: int, tree: Any, blocking: Optional[bool] = None):
        """Checkpoint a tree (parameters, optimizer state, ...).

        Blocking saves return the stats dict.  Async saves snapshot the
        tree to host memory on the caller's thread and return a Future of
        the stats dict; compress+write run on the background worker, at
        most two saves in flight (a third `save` blocks until the oldest
        completes).  `wait()` is the barrier.
        """
        blocking = (not self.async_save) if blocking is None else blocking
        # caller-thread copy
        flat, dtypes = _flatten(tree, snapshot=not blocking)
        if blocking:
            self.wait()                  # keep manifest commit order
            return self._save_inner(step, flat, dtypes)
        return self._q.submit(self._save_inner, step, flat, dtypes,
                              label=f"save step {step}")

    def wait(self):
        """Barrier: block until every in-flight async save is durable;
        re-raises the first background exception, if any."""
        self._q.flush()

    def close(self):
        """Wait for the in-flight saves and stop the save worker."""
        self._q.close()

    def _seeded_chain(self, arr: np.ndarray) -> chainmod.ReferenceChain:
        # Per tensor: the device chain only for dtypes it holds exactly
        # (ints and f16 are lossless-only anyway).
        residency = self.chain
        if not chainmod.device_supports(arr.dtype):
            residency = chainmod.CHAIN_HOST
        c = chainmod.make_reference_chain(residency, arr.dtype, self.device)
        c.seed(arr)
        return c

    def _save_inner(self, step: int, flat: Dict[str, np.ndarray],
                    dtypes: Dict[str, str]):
        with telemetry.span("ckpt.save", step=step,
                            tensors=len(flat)) as sp:
            return self._save_body(step, flat, dtypes, sp)

    def _save_body(self, step: int, flat: Dict[str, np.ndarray],
                   dtypes: Dict[str, str], sp):
        is_anchor = (self._save_count % self.anchor_every == 0
                     or not self._recon_state)
        w = NCKWriter()
        stats = {"step": step, "anchor": is_anchor, "orig_bytes": 0,
                 "comp_bytes": 0, "codec": self.params.codec}
        names = {}
        staged: Dict[str, chainmod.ReferenceChain] = {}
        with telemetry.span("ckpt.encode", step=step):
            for i, (key, arr) in enumerate(sorted(flat.items())):
                var = f"t{i:04d}"
                names[var] = key
                stats["orig_bytes"] += arr.nbytes
                # bfloat16 (uint16 storage here, an ml_dtypes type in the
                # reference) is not a numpy floating type: lossless.
                lossless = (not self.compress or is_anchor
                            or any(s in key for s in self.exempt)
                            or not np.issubdtype(arr.dtype, np.floating)
                            or arr.size < 4096
                            or key not in self._recon_state)
                if lossless:
                    st = make_anchor(arr, self.params, dtypes[key])
                    staged[key] = self._seeded_chain(arr)
                else:
                    # Encode against the chain state and advance a *fork*
                    # from the pre-entropy result.  Checkpoints always
                    # chain the reconstruction, whatever
                    # params.reference says.
                    prev_chain = self._recon_state[key]
                    on_device = prev_chain.residency == chainmod.CHAIN_DEVICE
                    # One upload, shared by the encode and the advance.
                    curr_in = (torch.tensor(arr, device=self.device)
                               if on_device else arr)
                    dev = encode_device(prev_chain.peek(), curr_in,
                                        self.params,
                                        need_host_idx=not on_device,
                                        device=self.device)
                    st = pipe.finalize_step(arr, dev.enc, dev.centers,
                                            dev.domain_lo, dev.width,
                                            self.params, dev.meta)
                    c = prev_chain.fork()
                    c.advance(dev, arr)
                    staged[key] = c
                stats["comp_bytes"] += st.nbytes
                w.add_step(var, st)
        w.add_array("__names__",
                    np.frombuffer(json.dumps(names).encode(), np.uint8),
                    attrs={"step": step})
        # The container's own write span ("nck.write" + fsync/rename
        # children) nests under this one on the same lane.
        with telemetry.span("ckpt.write", step=step):
            w.write(self._step_path(step))
        # Commit the staged chains only after the step file is durable: a
        # save that dies mid-write must leave the next delta encoding
        # against the last *persisted* state.  The forks make this a
        # handle swap, never an in-place mutation.
        self._recon_state.update(staged)
        self._save_count += 1

        with telemetry.span("ckpt.manifest", step=step):
            m = self._read_manifest()
            m["steps"] = sorted(set(m["steps"] + [step]))
            if is_anchor:
                m["anchors"] = sorted(set(m.get("anchors", []) + [step]))
            self._write_manifest(m)
            self._retention(m)
        stats["ratio"] = stats["orig_bytes"] / max(stats["comp_bytes"], 1)
        sp.set(anchor=is_anchor, orig_bytes=stats["orig_bytes"],
               comp_bytes=stats["comp_bytes"])
        return stats

    def _retention(self, m: Dict):
        """Keep the last `keep` steps + the anchors their deltas chain to."""
        steps: List[int] = m["steps"]
        if len(steps) <= self.keep:
            return
        keep_set = set(steps[-self.keep:])
        anchors = list(m.get("anchors", []))
        for s in list(keep_set):
            past = [a for a in anchors if a <= s]
            if past:
                keep_set.add(max(past))
        # deltas chain step-to-step; keep everything from the oldest needed
        # anchor forward
        oldest = min(keep_set)
        keep_set = {s for s in steps if s >= oldest}
        for s in steps:
            if s not in keep_set:
                try:
                    os.remove(self._step_path(s))
                except FileNotFoundError:
                    pass
        m["steps"] = sorted(keep_set)
        m["anchors"] = sorted(set(m.get("anchors", [])) & keep_set)
        self._write_manifest(m)

    # ------------------------------------------------------------- restore
    def _load_flat(self, upto_step: int, m: Dict
                   ) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
        """Replay anchors+deltas up to `upto_step` (inclusive): each
        leaf's host array (bfloat16 as its uint16 storage) and recorded
        dtype name."""
        anchors = [a for a in m.get("anchors", []) if a <= upto_step]
        if not anchors:
            raise FileNotFoundError("no anchor at or before requested step")
        start = max(anchors)
        chain = [s for s in m["steps"] if start <= s <= upto_step]
        state: Dict[str, np.ndarray] = {}
        dtypes: Dict[str, str] = {}
        for s in chain:
            r = NCKReader(self._step_path(s))
            names = json.loads(bytes(r.read_array("__names__")).decode())
            for var, key in names.items():
                st = r.read_step(var)
                dtypes[key] = st.dtype
                if st.is_anchor:
                    state[key] = decode_anchor(st, self.device)
                else:
                    state[key] = decompress_step(st, state[key], self.device)
        return state, dtypes

    def restore_latest(self, template: Any = None
                       ) -> Optional[Tuple[int, Any]]:
        """(step, tree) from the newest valid checkpoint; walks back past
        corrupt files.  Without `template` the tree is nested dicts of
        ndarrays (bfloat16 leaves as CPU ``torch.bfloat16`` tensors, since
        numpy has no bfloat16); with one, it has the template's structure
        and each leaf its template leaf's shape and dtype: a tensor on the
        template's device (on the manager's device for a "meta"
        template), an ndarray, or a Python scalar.

        Every skipped (corrupt/missing) step is recorded in
        ``last_restore_report`` -- a list of ``{"step", "error"}`` dicts."""
        self.wait()                      # drain in-flight async saves
        m = self._read_manifest()
        self.last_restore_report = []
        for step in reversed(m["steps"]):
            try:
                flat, dtypes = self._load_flat(step, m)
                self._recon_state = {k: self._seeded_chain(v)
                                     for k, v in flat.items()}
                self._save_count = len(
                    [s for s in m["steps"] if s <= step])
                return step, self._unflatten(flat, dtypes, template)
            except Exception as e:  # noqa: BLE001 -- corrupt/missing: walk back
                self.last_restore_report.append(
                    {"step": int(step), "error": f"{type(e).__name__}: {e}"})
        return None

    def _unflatten(self, flat: Dict[str, np.ndarray], dtypes: Dict[str, str],
                   template: Any):
        if template is None:
            return nest({k: (storage_tensor(arr, dtypes[k])
                             if dtypes[k] == "bfloat16" else arr)
                         for k, arr in flat.items()})
        return map_with_keys(
            lambda key, leaf: self._leaf_like(flat[key], dtypes[key], leaf),
            template)

    def _leaf_like(self, arr: np.ndarray, dtype_name: str, leaf):
        """`arr` (storage of the recorded `dtype_name`) on `leaf`'s shape
        and dtype, and for a tensor its device."""
        if isinstance(leaf, torch.Tensor):
            dev = self.device if leaf.device.type == "meta" else leaf.device
            return storage_tensor(arr, dtype_name).reshape(
                tuple(leaf.shape)).to(device=dev, dtype=leaf.dtype)
        if isinstance(leaf, (bool, int, float)):
            return type(leaf)(arr.reshape(()).item())
        arr = arr.reshape(np.shape(leaf))
        dtype = getattr(leaf, "dtype", None)
        return arr.astype(dtype) if dtype is not None else arr


__all__ = ["CheckpointManager"]
