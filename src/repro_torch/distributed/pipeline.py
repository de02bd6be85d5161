"""Sharded NUMARCK compression pipeline (paper Sec. IV) on torch.

The port's counterpart of the reference's ``distributed/pipeline.py``.
The reference's mesh axis is a ``collectives.ShardGroup``: an explicit
list of ``torch.device``s, one per shard (one card may be named several
times), extended across processes by ``torch.distributed``.  Each shard
runs the hand-written kernels on its own device (their plain versions on
a CPU device).  Phases, 1:1 with the paper:

  1. change-ratio calculation  -- a range pass per shard; min/max
     Allreduce for the global range (skipped under ``fixed_domain``),
     then the change-ratio kernel per shard.
  2. bin construction (top-k)  -- the histogram kernel per shard; a sum
     Allreduce merges them; every process runs the same descending sort
     and Eq. (6) B scan (the replicated "serial part", Table 3).
  3. indexing                  -- rank-LUT lookup per shard.
  4. index alignment           -- block boundaries are static (shard s
     holds elements [s*ln, (s+1)*ln)); the block straddling a shard
     boundary is completed by ``right_edge_exchange`` (only its part
     past the boundary crosses it), so each shard owns the blocks that
     start inside it.
  5. bits packing              -- one bit-pack launch per shard over its
     owned blocks, which are contiguous in its extended table.
  6. entropy coding            -- the shared host finalize, or with
     ``codec="rans"`` the rANS encode kernel per shard (in every driver
     here, multi-process included).

The REF_RECONSTRUCTED chain stays sharded on the devices between steps,
advanced per shard by the dequantize kernel (``_ShardedDeviceChain``).
Blobs are byte-identical to the reference's sharded driver, and to the
single-device driver wherever ``block_elems(B)`` fits in a shard (else
blocks shrink to ``ln // 32 * 32``, as in the reference).

Telemetry: the reference's ``encode.*``, ``finalize.*`` and ``decode.*``
spans and ``meta["telemetry"]`` records, with the single-device driver's
key set (``obs.report``); each device stage ends in a synchronize of
every shard's card only while telemetry is enabled.
"""
from __future__ import annotations

import contextlib
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Deque, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import binning, entropy, ratios, select_b
from repro_torch.core import chain as chainmod
from repro_torch.core import compress as comp
from repro_torch.core import pipeline as pipe
from repro_torch.core.container import ShardNCKWriter, StepFragment
from repro_torch.core.overlap import FinalizeQueue
from repro_torch.core.pipeline import DeviceEncoded
from repro_torch.core.types import (REF_RECONSTRUCTED, CompressedStep,
                                    NumarckParams, step_dtype)
from repro_torch.distributed import collectives as coll
from repro_torch.faults import inject
from repro_torch.kernels import ops as kops
from repro_torch.kernels import rans
from repro_torch.kernels.dequant import patch_exceptions
from repro_torch.obs import telemetry


def _on(dev: torch.device):
    """Make ``dev`` current while a shard's kernels launch (they run on
    the current device's stream)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _sync(devices: Sequence[torch.device]) -> None:
    """End a device stage under telemetry on every shard's card."""
    for d in set(devices):
        comp._sync(d)


def _check_devices(devices) -> List[torch.device]:
    out = [chainmod.resolve_device(d) for d in devices]
    if not out:
        raise ValueError("need at least one shard device")
    return out


def analyze_device(devices, prev_sh, curr_sh, domain_lo, width, bound, *,
                   max_bins: int, reduce_sum, kernels=kops):
    """The device part of phases 1-2 (the reference's ``_analyze_shard``
    after its range Allreduce): per shard its candidate-bin ids and
    histogram, the histograms summed by ``reduce_sum`` (a list of
    per-shard histograms -> their sum), and the sum's descending sort.
    ``kernels`` has ``change_ratio_bins`` and ``histogram``: the dispatch
    of ``kernels.ops``, or the plain versions (the dry run's meta
    tensors).  -> (bin_ids per shard, counts_desc, ids_desc)."""
    bin_ids, hists = [], []
    for d, prev_l, curr_l in zip(devices, prev_sh, curr_sh):
        with _on(torch.device(d)):
            _, ids = kernels.change_ratio_bins(prev_l, curr_l, domain_lo,
                                               width, max_bins=max_bins)
            bin_ids.append(ids)
            hists.append(kernels.histogram(ids, max_bins=max_bins,
                                           id_bound=bound))
    counts_desc, ids_desc = binning.sort_histogram(reduce_sum(hists))
    return bin_ids, counts_desc, ids_desc


def _shard(flat: np.ndarray, s: int, ln: int,
           dev: torch.device) -> torch.Tensor:
    """Elements [s*ln, (s+1)*ln) of ``flat`` on ``dev``, zero-padded past
    the end (a zero previous value makes the pad an invalid ratio, so it
    indexes as the marker).  Always a private copy."""
    part = flat[s * ln:(s + 1) * ln]
    out = torch.zeros(ln, dtype=step_dtype(part.dtype).torch, device=dev)
    out[:part.size] = torch.from_numpy(np.ascontiguousarray(part)).to(dev)
    return out


@dataclass
class _Layout:
    """Static block layout of one step over the shards."""

    n: int
    ln: int
    be: int
    b_bits: int

    @property
    def nblocks(self) -> int:
        return -(-self.n // self.be)

    def first_block(self, s: int) -> int:
        """First global block owned by shard s (the first one starting at
        or after its first element), clipped to the step's blocks."""
        return min(-(-(s * self.ln) // self.be), self.nblocks)

    def reach(self, s: int) -> int:
        """Elements past shard s's end that its owned blocks cover: the
        part of the block straddling its right edge, 0 where its blocks
        end on the edge."""
        return max(0, self.first_block(s + 1) * self.be - (s + 1) * self.ln)


@dataclass
class _ShardOut:
    """One shard's encode output."""

    idx: torch.Tensor            # (ln,) int32 indices
    g0: int                      # first owned global block
    nown: int                    # number of owned blocks
    owned: torch.Tensor          # (nown * be,) indices of the owned blocks
    exc_pos: Optional[np.ndarray] = None     # global marker positions < n
    exc_counts: Optional[np.ndarray] = None  # markers per owned block


class ShardedCompressor:
    """Distributed NUMARCK over a list of shard devices (the reference's
    mesh axis), in one process or, through ``MultiProcessCompressor``,
    across processes.

    ``overlap=True`` double-buffers the device/host split across temporal
    steps, as in the reference.  ``chain`` picks the reference chain's
    residency: "auto" (default) keeps it sharded on the devices, "host"
    keeps a NumPy copy.  Blobs are byte-identical across residencies and
    overlap modes.  Devices default to one CUDA device; pass CPU devices
    for the plain versions.
    """

    _pipeline = "sharded"
    _distributed = False          # shards of other processes too

    def __init__(self, devices: Optional[Sequence] = None,
                 params: NumarckParams = NumarckParams(),
                 overlap: bool = False, chain: str = chainmod.CHAIN_AUTO):
        if chain not in chainmod.RESIDENCIES:
            raise ValueError(f"unknown chain residency {chain!r}")
        devices = _check_devices([None] if devices is None else devices)
        self.group = coll.ShardGroup(devices, self._distributed)
        self.devices = self.group.devices
        self.params = params
        self.overlap = overlap
        self.chain = chain
        self.n_shards = self.group.size
        self._q = FinalizeQueue(overlap, name="shard-finalize")
        self._chain: Optional[chainmod.ReferenceChain] = None
        self._step = 0

    # -------------------------------------------------------- device stage
    def _layout(self, n: int, b_bits: int) -> _Layout:
        ln = -(-n // self.n_shards)
        be = self.params.block_elems(b_bits)
        if be > ln:
            be = max(32, ln // 32 * 32) if ln >= 32 else 32
            if be > ln:
                raise ValueError(
                    f"shard length {ln} smaller than minimum block (32); "
                    "use fewer shards or larger inputs")
        return _Layout(n=n, ln=ln, be=be, b_bits=b_bits)

    def _scatter(self, flat: np.ndarray, ln: int) -> List[torch.Tensor]:
        """This process's shards of ``flat``, one on each device."""
        g = self.group
        return [_shard(flat, g.first + j, ln, d)
                for j, d in enumerate(self.devices)]

    def _analyze(self, prev_sh, curr_sh, n: int, ebytes: int) -> dict:
        """Phases 1-2: global domain, per-shard bins and histogram, the
        summed histogram's sort, and auto-B."""
        p = self.params
        if p.fixed_domain:
            # Skips the range pass and its Allreduce, as the reference's
            # sharded driver does (NumarckParams.fixed_domain).
            width = np.float32(2.0) * np.float32(p.error_bound)
            domain_lo = np.float32(np.float32(-0.5) * width) \
                * np.float32(p.max_bins)
            bound = p.max_bins
        else:
            # Each shard's ends carry XLA's signed zeros, and the
            # reduction keeps the first shard's zero, as the reference's
            # pmin/pmax do.  A valid ratio is finite, so an infinite end
            # means that no shard has one.
            ends = [ratios.valid_ends(*ratios.change_ratios(prev_l, curr_l))
                    for prev_l, curr_l in zip(prev_sh, curr_sh)]
            lo, hi = coll.allreduce_minmax([e[0] for e in ends],
                                           [e[1] for e in ends], self.group)
            lo = lo if np.isfinite(lo) else np.float32(0.0)
            hi = hi if np.isfinite(hi) else np.float32(0.0)
            domain_lo, width, bound = ratios.histogram_domain(
                lo, hi, p.error_bound, p.max_bins)
        bin_ids, counts_desc, ids_desc = analyze_device(
            self.devices, prev_sh, curr_sh, domain_lo, width, bound,
            max_bins=p.max_bins,
            reduce_sum=lambda hs: coll.allreduce_sum(hs, self.group))
        b_auto, est_sizes = select_b.choose_b(counts_desc, n, ebytes,
                                              p.b_max)
        return dict(bin_ids=bin_ids, ids_desc=ids_desc, b_auto=b_auto,
                    est_sizes=est_sizes, domain_lo=domain_lo, width=width)

    def _encode_shards(self, bin_ids, ids_desc, lay: _Layout,
                       k_eff: int) -> List[_ShardOut]:
        """Phases 3-4: indices per shard, the edge exchange and each
        shard's owned blocks."""
        p, g = self.params, self.group
        marker = (1 << lay.b_bits) - 1
        idx_sh = []
        for d, ids in zip(self.devices, bin_ids):
            with _on(d):
                idx_sh.append(comp._encode_topk(ids, ids_desc.to(d),
                                                lay.b_bits, k_eff,
                                                p.max_bins))
        # Each head is what the shard before it needs; nothing crosses a
        # boundary that no block straddles.
        heads = [x[:lay.reach(g.first + j - 1)] for j, x in enumerate(idx_sh)]
        fill = torch.full((lay.reach(g.first + g.n_local - 1),), marker,
                          dtype=torch.int32)
        edges = coll.right_edge_exchange(heads, g, fill)
        outs = []
        for j, (idx, edge) in enumerate(zip(idx_sh, edges)):
            s = g.first + j
            g0, g1 = lay.first_block(s), lay.first_block(s + 1)
            ext = torch.cat([idx, edge])
            start = g0 * lay.be - s * lay.ln
            outs.append(_ShardOut(idx=idx, g0=g0, nown=g1 - g0,
                                  owned=ext[start:start + (g1 - g0) * lay.be]))
        return outs

    @staticmethod
    def _exceptions(outs: List[_ShardOut], lay: _Layout) -> None:
        """The markers in each shard's owned blocks: global positions below
        n, ascending, and their count per block."""
        marker = (1 << lay.b_bits) - 1
        for o in outs:
            pos = torch.nonzero(o.owned == marker).reshape(-1).cpu().numpy()
            pos = pos.astype(np.int64) + o.g0 * lay.be
            o.exc_pos = pos[pos < lay.n]
            o.exc_counts = np.bincount((o.exc_pos - o.g0 * lay.be) // lay.be,
                                       minlength=o.nown).astype(np.int64)

    def _pack(self, outs: List[_ShardOut], lay: _Layout) -> List[bytes]:
        """Phase 5: one bit-pack launch per shard over its owned blocks;
        the packed bytes of every owned block in global order."""
        raws: List[bytes] = []
        for d, o in zip(self.devices, outs):
            if not o.nown:
                continue
            with _on(d):
                words = kops.pack_bits(o.owned.contiguous(),
                                       b_bits=lay.b_bits)
            raw = words.cpu().numpy().astype("<u4", copy=False).tobytes()
            raws += pipe.split_packed(raw, o.nown, lay.be, lay.b_bits)
        return raws

    def _entropy_stage(self, outs: List[_ShardOut],
                       lay: _Layout) -> List[bytes]:
        """Device entropy per shard: the bit-pack and rANS encode kernels
        over its owned blocks (v1 blobs, as the reference's sharded
        stage), byte-identical to the host coder."""
        blobs: List[bytes] = []
        for d, o in zip(self.devices, outs):
            if not o.nown:
                continue
            with _on(d):
                blobs += rans.compress_blocks_device(
                    o.owned.contiguous(), lay.b_bits, o.nown, lay.be)
        return blobs

    def _code_or_pack(self, outs: List[_ShardOut], lay: _Layout):
        """Phases 5-6 on the shards where ``device_entropy_route`` holds
        (coded blobs), else phase 5 alone (packed bytes for the host
        coder).  -> (coded, raws, device entropy s, pack s)."""
        coded = raws = None
        with telemetry.span("encode.device_entropy") as sp_de:
            if comp.device_entropy_route(self.params, lay.n, lay.b_bits):
                coded = self._entropy_stage(outs, lay)
        pack_s = 0.0
        if coded is None:
            with telemetry.span("encode.pack_fetch") as sp_pack:
                raws = self._pack(outs, lay)
            pack_s = sp_pack.duration
        return coded, raws, sp_de.duration, pack_s

    def _encode_common(self, prev, curr: np.ndarray,
                       b_bits: Optional[int]):
        """Phases 1-4 for one step; prev is a host array or the sharded
        chain state (a list of padded per-shard tensors).  Also returns
        the stage seconds (zero with telemetry off)."""
        p = self.params
        curr = np.asarray(curr)
        n = curr.size
        ln = -(-n // self.n_shards)
        if isinstance(prev, list):
            if any(t.numel() != ln for t in prev):
                raise ValueError(
                    "device-resident chain state does not match this "
                    f"step's padded layout ({self.n_shards} x {ln}); "
                    "reset() the compressor before changing shapes")
            prev_sh = prev
        else:
            prev_sh = self._scatter(np.asarray(prev).reshape(-1), ln)
        curr_sh = self._scatter(curr.reshape(-1), ln)
        tele = telemetry.enabled()
        with telemetry.span("encode.analyze", n=n) as sp_an:
            a = self._analyze(prev_sh, curr_sh, n, curr.dtype.itemsize)
            if tele:
                _sync(self.devices)
        bb = int(b_bits if b_bits is not None
                 else (p.b_bits if p.b_bits is not None else a["b_auto"]))
        k_eff = min((1 << bb) - 1, p.max_bins)
        lay = self._layout(n, bb)
        with telemetry.span("encode.index",
                            b_bits=bb) as sp_idx:
            outs = self._encode_shards(a["bin_ids"], a["ids_desc"], lay,
                                       k_eff)
            if tele:
                _sync(self.devices)
        with telemetry.span("encode.exceptions") as sp_exc:
            self._exceptions(outs, lay)
        centers = pipe.topk_centers(a["ids_desc"][:k_eff].cpu().numpy(),
                                    k_eff, float(a["domain_lo"]),
                                    float(a["width"]))
        centers = pipe.round_centers(centers, curr.dtype)
        meta = {"b_auto": int(a["b_auto"]),
                "est_sizes": a["est_sizes"].numpy().tolist(),
                "n_shards": self.n_shards, "pipeline": self._pipeline}
        stage_s = {"analyze_s": sp_an.duration,
                   "encode_s": sp_idx.duration + sp_exc.duration}
        return a, lay, outs, centers, meta, curr_sh, stage_s

    def _device_encode(self, prev, curr: np.ndarray,
                       b_bits: Optional[int] = None) -> DeviceEncoded:
        """Phases 1-5 on the shards; the pre-entropy encode result that
        the finalize and the reference chain consume."""
        a, lay, outs, centers, meta, curr_sh, stage_s = self._encode_common(
            prev, curr, b_bits)
        coded, raws, de_s, pack_s = self._code_or_pack(outs, lay)
        host_chain = (self._chain is not None
                      and self._chain.residency == chainmod.CHAIN_HOST)
        with telemetry.span("encode.idx_fetch") as sp_fetch:
            idx = None
            if host_chain:
                idx = torch.cat([o.idx.cpu() for o in outs]).numpy()[:lay.n]
        enc = pipe.EncodedIndices(
            idx=idx, b_bits=lay.b_bits, block_elems=lay.be, n=lay.n,
            packed=raws, entropy_coded=coded,
            entropy_codec=None if coded is None else self.params.codec,
            exc_positions=np.concatenate([o.exc_pos for o in outs]),
            exc_block_counts=np.concatenate([o.exc_counts for o in outs]))
        if telemetry.enabled():
            # The single-device driver's keys; finalize_step folds them
            # into the canonical per-step record.
            meta["telemetry"] = {
                "analyze_s": stage_s["analyze_s"],
                "encode_s": stage_s["encode_s"] + pack_s + sp_fetch.duration,
                "device_entropy_s": de_s,
            }
        return DeviceEncoded(enc=enc, centers=centers,
                             domain_lo=float(a["domain_lo"]),
                             width=float(a["width"]), meta=meta,
                             idx_dev=[o.idx for o in outs],
                             curr_dev=curr_sh)

    # --------------------------------------------------------- host stage
    def compress_async(self, prev: np.ndarray, curr: np.ndarray,
                       b_bits: Optional[int] = None
                       ) -> "Future[CompressedStep]":
        """Device-encode now; return a future of the finalized step."""
        dev = self._device_encode(prev, curr, b_bits)
        step_i, self._step = self._step, self._step + 1
        curr_s = (np.array(curr, copy=True) if self.overlap
                  else np.asarray(curr))
        return self._q.submit(pipe.finalize_step, curr_s, dev.enc,
                              dev.centers, dev.domain_lo, dev.width,
                              self.params, dev.meta,
                              label=f"finalize step {step_i}")

    def compress(self, prev: np.ndarray, curr: np.ndarray,
                 b_bits: Optional[int] = None) -> CompressedStep:
        return self.compress_async(prev, curr, b_bits).result()

    def _make_chain(self, dtype) -> chainmod.ReferenceChain:
        if (chainmod.resolve_residency(self.chain, dtype)
                == chainmod.CHAIN_DEVICE):
            return _ShardedDeviceChain(self)
        return chainmod.HostReferenceChain()

    # ------------------------------------------------- temporal streaming
    def add_async(self, arr: np.ndarray) -> "Future[CompressedStep]":
        """Streaming interface over a temporal series (the first call
        stores a lossless anchor); the chain advances before returning."""
        arr = np.asarray(arr)
        step_i, self._step = self._step, self._step + 1
        if self._chain is None or self._chain.empty:
            self._chain = self._make_chain(arr.dtype)
            self._chain.seed(arr)
            return self._q.submit(pipe.finalize_anchor, arr.copy(),
                                  self.params,
                                  label=f"anchor step {step_i}")
        dev = self._device_encode(self._chain.peek(), arr)
        if self.params.reference == REF_RECONSTRUCTED:
            self._chain.advance(dev, arr)
        else:
            self._chain.replace(arr)
        curr_s = np.array(arr, copy=True) if self.overlap else arr
        return self._q.submit(pipe.finalize_step, curr_s, dev.enc,
                              dev.centers, dev.domain_lo, dev.width,
                              self.params, dev.meta,
                              label=f"finalize step {step_i}")

    def add(self, arr: np.ndarray) -> CompressedStep:
        return self.add_async(arr).result()

    def compress_series(self, arrays) -> List[CompressedStep]:
        """Compress a temporal series; double-buffered when overlap=True."""
        self.reset()
        return _drain(self.add_async, arrays)

    def flush(self):
        self._q.flush()

    def close(self):
        self._q.close()

    def reference_state(self) -> Optional[np.ndarray]:
        """Host copy of the current chain state (None before the anchor)."""
        if self._chain is None or self._chain.empty:
            return None
        return self._chain.to_host()

    def reset(self):
        """Drop the temporal chain state (next add() writes an anchor)."""
        self._chain = None
        self._step = 0


def _drain(submit, arrays) -> list:
    """Submit every array, keeping at most two results in flight."""
    out: list = []
    futs: Deque[Future] = deque()
    for a in arrays:
        futs.append(submit(a))
        while len(futs) > 2:
            out.append(futs.popleft().result())
    out.extend(f.result() for f in futs)
    return out


class _ShardedDeviceChain(chainmod.ReferenceChain):
    """Sharded reference chain: the padded per-shard tensors the encode
    stages consume directly, in the data's precision, advanced per shard
    by the fused chain-advance (dequantize) kernel."""

    residency = chainmod.CHAIN_DEVICE

    def __init__(self, driver: ShardedCompressor):
        super().__init__()
        self._d = driver
        self._n = 0
        self._shape: Optional[tuple] = None
        self._dtype = None

    def seed(self, arr) -> None:
        arr = np.asarray(arr)
        if not chainmod.device_supports(arr.dtype):
            raise ValueError(f"sharded device chain cannot hold {arr.dtype} "
                             "bit-exactly")
        self._n, self._shape, self._dtype = arr.size, arr.shape, arr.dtype
        ln = -(-arr.size // self._d.n_shards)
        self._state = self._d._scatter(arr.reshape(-1), ln)

    def advance(self, dev: DeviceEncoded, curr) -> None:
        bb = dev.enc.b_bits
        new = []
        for d, idx, prev_l, curr_l in zip(self._d.devices, dev.idx_dev,
                                          self._state, dev.curr_dev):
            # Centers are a float64 view of values already rounded to the
            # data dtype, so this cast is exact.
            centers = torch.as_tensor(dev.centers, device=d).to(prev_l.dtype)
            with _on(d):
                new.append(kops.chain_advance(idx, prev_l, curr_l, centers,
                                              b_bits=bb))
        self._state = new

    def to_host(self) -> np.ndarray:
        """This process's shards; the whole array in one process."""
        flat = torch.cat([t.cpu() for t in self._state]).numpy()
        return flat[:self._n].astype(self._dtype).reshape(self._shape)


class ShardedDecompressor:
    """Sharded reconstruction, the mirror image of the sharded encode.

    Steps on the device decode route (``compress.device_decode_route``)
    entropy-decode on the shards: each shard takes a contiguous run of
    blocks through the rANS decode kernel (and the unpack kernel for v1
    blobs), then the dequantize kernel and the exception patch.  Other
    steps inflate on the host and upload each shard's slice.  Both routes
    and the single-device driver are bit-identical.  One process.
    """

    def __init__(self, devices: Optional[Sequence] = None):
        devices = _check_devices([None] if devices is None else devices)
        self.group = coll.ShardGroup(devices, False)
        self.devices = self.group.devices
        self.n_shards = self.group.size

    def _index_shards(self, step: CompressedStep):
        """(element start, index tensor) per shard."""
        n, be, P = step.n, step.block_elems, self.n_shards
        if comp.device_decode_route(step):
            nb = len(step.index_blocks)
            per = -(-nb // P)
            out = []
            for j, d in enumerate(self.devices):
                b0, b1 = min(j * per, nb), min((j + 1) * per, nb)
                start = b0 * be
                if b0 == b1:
                    out.append((start, torch.zeros(0, dtype=torch.int32,
                                                   device=d)))
                    continue
                with _on(d):
                    idx = rans.decode_blocks_device(
                        step.index_blocks[b0:b1], step.b_bits, be, d)
                out.append((start, idx.reshape(-1)[:n - start]))
            return out
        idx = comp._decode_index_host(step)
        ln = -(-n // P)
        return [(j * ln, torch.from_numpy(idx[j * ln:(j + 1) * ln].copy()
                                          ).to(d))
                for j, d in enumerate(self.devices)]

    def decompress(self, step: CompressedStep, prev) -> np.ndarray:
        if step.is_anchor:
            return comp.decode_anchor(step, self.devices[0])
        if prev is None:
            raise ValueError("non-anchor steps need the previous state")
        tele = telemetry.enabled()
        cdt = pipe.reconstruction_dtype(step.dtype)
        tdt = step_dtype(cdt).torch
        marker = (1 << step.b_bits) - 1
        prev_flat = np.asarray(prev).reshape(-1).astype(cdt, copy=False)
        with telemetry.span("decode.entropy") as sp_e:
            parts = self._index_shards(step)
            if tele:
                _sync(self.devices)
        with telemetry.span("decode.dequant") as sp_d:
            recon = []
            for d, (start, idx) in zip(self.devices, parts):
                if not idx.numel():
                    recon.append(None)
                    continue
                prev_l = torch.from_numpy(
                    prev_flat[start:start + idx.numel()].copy()).to(d)
                centers = torch.tensor(step.centers, device=d).to(tdt)
                with _on(d):
                    recon.append(kops.dequantize(idx.contiguous(), prev_l,
                                                 centers,
                                                 b_bits=step.b_bits))
            if tele:
                _sync(self.devices)
        with telemetry.span("decode.patch") as sp_p:
            counts = [int((idx == marker).sum()) for _, idx in parts]
            offs = coll.exclusive_scan_sum(counts, self.group)
            values = torch.from_numpy(np.asarray(step.incomp_values, cdt))
            for j, ((_, idx), off, cnt) in enumerate(zip(parts, offs,
                                                        counts)):
                if cnt:
                    recon[j] = patch_exceptions(
                        recon[j], idx, values[off:off + cnt].to(idx.device),
                        b_bits=step.b_bits)
            if tele:
                _sync(self.devices)
        with telemetry.span("decode.fetch") as sp_f:
            res = torch.cat([r.cpu() for r in recon if r is not None]).numpy()
            res = res.astype(step.dtype).reshape(step.shape)
        if tele:
            comp._record_read(step, entropy_s=sp_e.duration,
                              dequant_s=sp_d.duration, patch_s=sp_p.duration,
                              fetch_s=sp_f.duration,
                              device=comp.device_decode_route(step))
        return res

    def decompress_series(self, steps: Sequence[CompressedStep]
                          ) -> List[np.ndarray]:
        out: List[np.ndarray] = []
        prev = None
        for s in steps:
            prev = self.decompress(s, prev)
            out.append(prev)
        return out


class MultiProcessCompressor(ShardedCompressor):
    """Multi-process NUMARCK: the sharded stages run over every process's
    shards (collectives through ``torch.distributed``); each process then
    writes ONLY its own blocks (paper Sec. IV-D collective write
    analogue) as a ``StepFragment`` per step, published by `save_series`
    as a ``<path>.g<gen>.rank<k>`` NCK shard file plus a rank-0 NCKM
    manifest.

    Every process holds the same host input (SPMD).  Exceptions and the
    entropy stage run per process over its own blocks, so payload bytes
    never cross processes: on this process's cards (the rANS encode
    kernel) where ``compress.device_entropy_route`` holds for the whole
    step, which every rank decides alike, else on its host coder (small
    steps, ``codec="auto"``, ``device_entropy=False``, and the anchor).
    Blobs are byte-identical to the single-process driver over as many
    shards for every concrete codec (``codec="auto"`` picks per block
    from a global budget the ranks cannot see, so it is only
    split-identical).  The reference chain must be device-resident.
    ``torch.distributed`` must be initialized (``launch.distributed``);
    a fleet of one rank a card gives each rank its card as ``"cuda"``.
    """

    _pipeline = "multiprocess"
    _distributed = True

    def __init__(self, devices: Optional[Sequence] = None,
                 params: NumarckParams = NumarckParams(),
                 overlap: bool = False, chain: str = chainmod.CHAIN_AUTO):
        if params.symbol_rans:
            raise ValueError("symbol-level rANS blobs code the whole "
                             "index table; the multi-process driver codes "
                             "each rank's packed blocks, as v1 blobs on its "
                             "cards or on its host (set symbol_rans=False)")
        if chain == chainmod.CHAIN_HOST:
            raise ValueError("multi-process compression needs the device-"
                             "resident reference chain (chain='host' "
                             "would gather the index table)")
        super().__init__(devices, params, overlap=overlap, chain=chain)
        self.rank = self.group.rank
        self.num_ranks = self.group.num_ranks

    def _make_chain(self, dtype) -> chainmod.ReferenceChain:
        if (chainmod.resolve_residency(self.chain, dtype)
                != chainmod.CHAIN_DEVICE):
            raise ValueError(f"multi-process compression of "
                             f"{np.dtype(dtype)} needs the device-resident "
                             "chain")
        return _ShardedDeviceChain(self)

    def _device_encode_local(self, prev, curr: np.ndarray):
        """Phases 1-5 over every process's shards, and phase 6 on this
        process's cards where ``device_entropy_route`` holds; this process
        keeps only its own blocks (coded, or packed for the host coder)
        and exceptions."""
        a, lay, outs, centers, meta, curr_sh, stage_s = self._encode_common(
            prev, curr, None)
        meta.update(rank=self.rank, num_ranks=self.num_ranks)
        coded, raws, de_s, pack_s = self._code_or_pack(outs, lay)
        if telemetry.enabled():
            meta["telemetry"] = {
                "analyze_s": stage_s["analyze_s"],
                "encode_s": stage_s["encode_s"] + pack_s,
                "device_entropy_s": de_s,
            }
        local = {"raws": raws, "coded": coded,
                 "block_start": outs[0].g0, "nblocks": lay.nblocks,
                 "exc_pos": np.concatenate([o.exc_pos for o in outs]),
                 "exc_counts": np.concatenate([o.exc_counts for o in outs])}
        enc = pipe.EncodedIndices(idx=None, b_bits=lay.b_bits,
                                  block_elems=lay.be, n=lay.n)
        dev = DeviceEncoded(enc=enc, centers=centers,
                            domain_lo=float(a["domain_lo"]),
                            width=float(a["width"]), meta=meta,
                            idx_dev=[o.idx for o in outs], curr_dev=curr_sh)
        return dev, local

    def _fragment_finalize(self, curr: np.ndarray, dev: DeviceEncoded,
                           local: dict) -> StepFragment:
        """Per-rank finalize: this rank's exception values and its own
        blocks, taken as the device entropy stage coded them or coded
        here by the host coder; block for block byte-identical to
        ``core.pipeline.finalize_step`` on the concatenated fragments."""
        p = self.params
        curr = np.asarray(curr)
        bb, be, n = dev.enc.b_bits, dev.enc.block_elems, int(dev.enc.n)
        marker = (1 << bb) - 1
        meta = dict(dev.meta)
        drv_tele = meta.pop("telemetry", None) or {}
        with telemetry.span("finalize", n=n, b_bits=bb) as sp_fin:
            with telemetry.span("finalize.exceptions") as sp_exc:
                values = curr.reshape(-1)[local["exc_pos"]].astype(
                    curr.dtype, copy=False)
            raws, blks = local["raws"], local["coded"]
            device_entropy = blks is not None
            block_codecs: Optional[List[str]] = None
            with telemetry.span("finalize.entropy") as sp_ent:
                if device_entropy:
                    codec = p.codec
                elif p.codec == entropy.AUTO_CODEC and len(raws) > 1:
                    per = entropy.choose_block_codecs(raws, p.zlib_level)
                    if len(set(per)) > 1:
                        codec = pipe._primary_codec(per)
                        block_codecs = per
                        blks = entropy.compress_blocks_per_codec(
                            raws, per, level=p.zlib_level,
                            parallel=p.parallel_entropy)
                    else:
                        codec = per[0]
                        blks = entropy.compress_blocks(
                            raws, codec=codec, level=p.zlib_level,
                            parallel=p.parallel_entropy)
                else:
                    codec = entropy.resolve_codec(p.codec, raws,
                                                  p.zlib_level)
                    blks = entropy.compress_blocks(
                        raws, codec=codec, level=p.zlib_level,
                        parallel=p.parallel_entropy)
                sp_ent.set(codec=codec, blocks=len(blks))
            centers = dev.centers
            if centers.size > marker:
                centers = centers[:marker]
            bytes_in = (len(blks) * (be * bb // 8) if device_entropy
                        else sum(len(r) for r in raws))
            bytes_out = sum(len(b) for b in blks)
            sp_fin.set(codec=codec, bytes_in=bytes_in, bytes_out=bytes_out)
        info = dict(
            total_data_num=n, shape=list(curr.shape), dtype=str(curr.dtype),
            bin_centers_number=int(centers.size), elements_per_block=be,
            B=bb, error_bound=p.error_bound, strategy=p.strategy,
            reference=p.reference, domain_lo=dev.domain_lo,
            bin_width=dev.width, is_anchor=False,
            n_blocks=int(local["nblocks"]), codec=codec)
        frag = StepFragment(
            is_anchor=False, block_start=int(local["block_start"]),
            info=info, index_blocks=blks,
            centers=centers if self.rank == 0 else None,
            incomp_values=values, incomp_block_counts=local["exc_counts"],
            block_codecs=block_codecs)
        if telemetry.enabled():
            meta["telemetry"] = {
                "analyze_s": float(drv_tele.get("analyze_s", 0.0)),
                "encode_s": float(drv_tele.get("encode_s", 0.0)),
                "exceptions_s": sp_exc.duration,
                "entropy_s": (float(drv_tele.get("device_entropy_s", 0.0))
                              if device_entropy else sp_ent.duration),
                "finalize_s": sp_fin.duration,
                "bytes_in": bytes_in, "bytes_out": bytes_out,
                "entropy_ratio": bytes_in / max(bytes_out, 1),
                "codec": codec, "device_entropy": device_entropy,
            }
        frag.meta = meta
        return frag

    def _anchor_fragment(self, arr: np.ndarray) -> StepFragment:
        """Lossless anchor, split by block index: rank k owns the global
        anchor blocks [k*nb/R, (k+1)*nb/R) of the single-process block
        grid, so per-block bytes match it exactly."""
        p = self.params
        arr = np.asarray(arr)
        flat = arr.reshape(-1)
        be_a = max(1, p.block_bytes // flat.dtype.itemsize)
        slices = pipe.block_slices(flat.size, be_a)
        nb = len(slices)
        g_lo = self.rank * nb // self.num_ranks
        g_hi = (self.rank + 1) * nb // self.num_ranks
        with telemetry.span("finalize.anchor", n=arr.size) as sp:
            raws = [flat[s:e].tobytes() for s, e in slices[g_lo:g_hi]]
            codec = entropy.resolve_codec(p.codec, raws, p.zlib_level)
            blks = entropy.compress_blocks(raws, codec=codec,
                                           level=p.zlib_level,
                                           parallel=p.parallel_entropy)
            sp.set(codec=codec)
        info = dict(
            total_data_num=arr.size, shape=list(arr.shape),
            dtype=str(arr.dtype), bin_centers_number=0,
            elements_per_block=be_a, B=0, error_bound=p.error_bound,
            strategy=p.strategy, reference=p.reference, domain_lo=0.0,
            bin_width=0.0, is_anchor=True, n_blocks=nb, codec=codec)
        frag = StepFragment(is_anchor=True, block_start=g_lo, info=info,
                            index_blocks=blks)
        if telemetry.enabled():
            frag.meta["telemetry"] = pipe.anchor_telemetry(
                sum(len(r) for r in raws), blks, codec, sp.duration)
        return frag

    # ------------------------------------------------- temporal streaming
    def add_fragment_async(self, arr: np.ndarray) -> "Future[StepFragment]":
        """Like `add_async`, but the future resolves to this rank's
        StepFragment (the first call seeds the chain and fragments a
        lossless anchor)."""
        arr = np.asarray(arr)
        step_i, self._step = self._step, self._step + 1
        # Fleet fault-injection sites (no-ops without REPRO_FAULTS): a rank
        # dying mid-encode, or stalling as a straggler, exercises rank 0's
        # quarantine/rollback commit path.
        inject.fire("rank_crash", step=step_i, rank=self.rank)
        inject.fire("straggler", step=step_i, rank=self.rank)
        if self._chain is None or self._chain.empty:
            self._chain = self._make_chain(arr.dtype)
            self._chain.seed(arr)
            return self._q.submit(self._anchor_fragment, arr.copy(),
                                  label=f"anchor fragment {step_i}")
        dev, local = self._device_encode_local(self._chain.peek(), arr)
        if self.params.reference == REF_RECONSTRUCTED:
            self._chain.advance(dev, arr)
        else:
            self._chain.replace(arr)
        curr_s = np.array(arr, copy=True) if self.overlap else arr
        return self._q.submit(self._fragment_finalize, curr_s, dev, local,
                              label=f"fragment step {step_i}")

    def add_fragment(self, arr: np.ndarray) -> StepFragment:
        return self.add_fragment_async(arr).result()

    def compress_series_fragments(self, arrays) -> List[StepFragment]:
        """This rank's fragments of a temporal series, device work in
        lockstep across ranks."""
        self.reset()
        return _drain(self.add_fragment_async, arrays)

    def save_series(self, path: str, arrays, names=None, *,
                    generation: Optional[int] = None,
                    manifest_timeout: float = 60.0) -> str:
        """Compress a series and publish it multi-process: every rank
        writes its own ``<path>.g<gen>.rank<k>`` shard file (atomic), rank
        0 waits for the full file set and commits the NCKM manifest.
        Returns the manifest path on rank 0, this rank's shard path
        elsewhere.  A crashed rank leaves the previous manifest loadable.
        """
        frags = self.compress_series_fragments(arrays)
        names = (list(names) if names is not None
                 else [f"step{i:04d}" for i in range(len(frags))])
        if len(names) != len(frags):
            raise ValueError(f"{len(names)} names for {len(frags)} steps")
        w = ShardNCKWriter(path, self.rank, self.num_ranks,
                           generation=generation)
        for name, frag in zip(names, frags):
            w.add_fragment(name, frag)
        w.write()
        if self.rank == 0:
            return w.commit_manifest(timeout=manifest_timeout)
        return w.rank_path


__all__ = ["ShardedCompressor", "ShardedDecompressor", "analyze_device",
           "MultiProcessCompressor"]
