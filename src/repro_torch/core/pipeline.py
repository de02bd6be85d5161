"""Shared NUMARCK pipeline stages: analyze -> encode -> finalize.

The port's counterpart of the reference's ``core/pipeline.py``.  A driver
produces an :class:`EncodedIndices` (device work) and everything after it
-- exception compaction, per-block entropy coding, blob assembly -- is
this module's host finalize, so the port emits the reference's
``CompressedStep`` blobs byte for byte.

Stage map:

  analyze   device  ratios, global range, histogram, auto-B
  encode    device  rank-LUT indexing + bit-packing
  finalize  host    exceptions, entropy stage, blob assembly  (HERE)

With telemetry enabled (``repro_torch.obs``) finalize records the
reference's spans (``finalize``, ``finalize.exceptions``,
``finalize.entropy``, ``finalize.anchor``) and the canonical per-step
``meta["telemetry"]`` record (``obs.report.STEP_TELEMETRY_KEYS``); blobs
are the same either way.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np

from repro_torch.core import entropy, packing
from repro_torch.core.types import CompressedStep, NumarckParams
from repro_torch.obs import telemetry


class StepMeta(dict):
    """Step metadata dict with the deprecated ``"zlib_ratio"`` alias
    (reading it warns once per process, as in the reference)."""

    _warned = False

    @classmethod
    def _warn_alias(cls):
        if not cls._warned:
            cls._warned = True
            warnings.warn(
                "meta['zlib_ratio'] is deprecated: the entropy stage is "
                "codec-pluggable; read meta['entropy_ratio'] instead",
                DeprecationWarning, stacklevel=4)

    def __getitem__(self, key):
        if key == "zlib_ratio":
            self._warn_alias()
        return dict.__getitem__(self, key)

    def get(self, key, default=None):
        if key == "zlib_ratio":
            self._warn_alias()
        return dict.get(self, key, default)


def reconstruction_dtype(dtype) -> np.dtype:
    """Arithmetic precision of the reconstruction R_i = R_{i-1}*(1+c):
    float64 data in float64, everything else in float32, so every chain
    and decompressor produces bit-identical state."""
    dt = np.dtype(dtype)
    return np.dtype(np.float64) if dt == np.float64 else np.dtype(np.float32)


def block_slices(n: int, block_elems: int) -> List[Tuple[int, int]]:
    return [(s, min(s + block_elems, n)) for s in range(0, n, block_elems)]


@dataclass
class EncodedIndices:
    """Driver-produced encode output: the contract between encode/finalize.

    ``packed`` holds the raw (pre-entropy) packed bytes of every index
    block in global order; the final block is marker-padded to the full
    ``block_elems``.  The port's driver fills it from the bit-pack kernel;
    None defers packing to the host packer here.

    ``entropy_coded`` is the already-coded variant of that contract: the
    device entropy stage (``kernels.rans``) hands finalize the finished
    per-block blobs and the codec that made them, and finalize skips the
    host entropy stage.

    ``exc_positions``/``exc_block_counts`` carry the device-computed
    exception compaction (``kernels.ops.exception_compact``).
    """

    # (n,) int32 bin ranks, marker = 2**B - 1.  None when nothing host-side
    # reads the table (device chain + device-packed blocks); set ``n`` then.
    idx: Optional[np.ndarray]
    b_bits: int
    block_elems: int
    n: Optional[int] = None    # element count; defaults to idx.size
    packed: Optional[List[bytes]] = None
    entropy_coded: Optional[List[bytes]] = None
    entropy_codec: Optional[str] = None
    exc_positions: Optional[np.ndarray] = None
    exc_block_counts: Optional[np.ndarray] = None

    @property
    def marker(self) -> int:
        return (1 << self.b_bits) - 1


@dataclass
class DeviceEncoded:
    """Output of the device analyze+encode stages (pre-entropy).

    ``idx_dev``/``curr_dev`` are device tensors of the index table and the
    current step, kept so a device-resident chain advances without a host
    round trip.  Host consumers only read ``enc``.
    """

    enc: EncodedIndices
    centers: np.ndarray          # rounded to the data dtype (float64 view)
    domain_lo: float
    width: float
    meta: dict
    idx_dev: Optional[Any] = None
    curr_dev: Optional[Any] = None


def topk_centers(ids_desc: np.ndarray, k_eff: int, domain_lo: float,
                 width: float) -> np.ndarray:
    """Bin centers of the top-k candidate bins (host float64)."""
    sel = np.asarray(ids_desc)[:k_eff]
    return (np.float64(domain_lo)
            + (sel.astype(np.float64) + 0.5) * np.float64(width))


def round_centers(centers: np.ndarray, dtype) -> np.ndarray:
    """Centers are stored in the data's own float type (paper Fig. 2);
    round now so in-memory and from-file reconstructions agree."""
    return np.asarray(centers).astype(dtype).astype(np.float64)


def split_packed(packed: bytes, nblocks: int, block_elems: int,
                 b_bits: int) -> List[bytes]:
    """Slice the packed marker-padded table at block boundaries.  Exact:
    block_elems is a multiple of 32, so every block spans whole words."""
    bpb = block_elems * b_bits // 8          # bytes per block (exact)
    return [packed[s:s + bpb] for s in range(0, nblocks * bpb, bpb)]


def pack_blocks_host(idx: np.ndarray, b_bits: int,
                     block_elems: int) -> List[bytes]:
    """Host bit-pack stage: B-bit indices -> raw bytes per block, the final
    partial block padded with markers."""
    marker = (1 << b_bits) - 1
    n = idx.size
    if n == 0:
        return []
    nblocks = -(-n // block_elems)
    total = nblocks * block_elems
    padded = idx if total == n else np.concatenate(
        [idx, np.full(total - n, marker, idx.dtype)])
    packed = packing.pack_indices_np(padded, b_bits).tobytes()
    return split_packed(packed, nblocks, block_elems, b_bits)


def exception_offsets(incomp_mask: np.ndarray,
                      block_elems: int) -> np.ndarray:
    """Exclusive per-block prefix of incompressible counts."""
    n = incomp_mask.size
    per_block = np.add.reduceat(incomp_mask,
                                np.arange(0, n, block_elems)).astype(np.int64)
    return np.concatenate([[0], np.cumsum(per_block)])[:-1]


def exception_table(idx: np.ndarray, marker: int, block_elems: int,
                    curr_flat: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Compact incompressible values + their per-block offset table."""
    incomp_mask = idx == marker
    return curr_flat[incomp_mask], exception_offsets(incomp_mask, block_elems)


def entropy_ratio(blobs: List[bytes], raw_sizes: np.ndarray) -> float:
    """Average entropy-stage compression ratio (paper Table 9)."""
    comp = sum(len(b) for b in blobs)
    return float(np.asarray(raw_sizes).sum()) / max(comp, 1)


def _primary_codec(block_codecs: List[str]) -> str:
    """Most common per-block codec (ties break by name)."""
    counts: dict = {}
    for c in block_codecs:
        counts[c] = counts.get(c, 0) + 1
    return max(sorted(counts), key=lambda c: counts[c])


def finalize_step(curr: np.ndarray, enc: EncodedIndices,
                  centers: np.ndarray, domain_lo: float, width: float,
                  params: NumarckParams,
                  meta: Optional[dict] = None) -> CompressedStep:
    """Shared host finalize: exceptions, parallel entropy stage, assembly.
    Blocks the device entropy stage already coded (``enc.entropy_coded``)
    are taken as they are.  A rank of ``MultiProcessCompressor`` finalizes
    its own blocks and exceptions here (``enc`` holds no others), then
    turns the result into its ``StepFragment``."""
    curr = np.asarray(curr)
    n = int(enc.n if enc.n is not None else enc.idx.size)
    # Driver-side stage timings (encode_device and the sharded
    # _device_encode attach them when telemetry is enabled); never
    # persisted into blob bytes -- the NCK container stores `info` attrs,
    # not `meta`.
    meta = dict(meta or {})
    drv_tele = meta.pop("telemetry", None) or {}
    with telemetry.span("finalize", n=n, b_bits=enc.b_bits) as sp_fin:
        with telemetry.span("finalize.exceptions") as sp_exc:
            if enc.exc_positions is not None:
                incomp_values = curr.reshape(-1)[enc.exc_positions]
                incomp_off = np.concatenate(
                    [[0],
                     np.cumsum(enc.exc_block_counts)])[:-1].astype(np.int64)
            else:
                incomp_values, incomp_off = exception_table(
                    enc.idx, enc.marker, enc.block_elems, curr.reshape(-1))

        block_codecs: Optional[List[str]] = None
        with telemetry.span("finalize.entropy") as sp_ent:
            if enc.entropy_coded is not None:
                blks = enc.entropy_coded
                codec = enc.entropy_codec or entropy.DEFAULT_CODEC
                bpb = enc.block_elems * enc.b_bits // 8
                raw_sizes = np.full(len(blks), bpb, np.int64)
            else:
                raws = (enc.packed if enc.packed is not None
                        else pack_blocks_host(enc.idx, enc.b_bits,
                                              enc.block_elems))
                raw_sizes = np.asarray([len(r) for r in raws], np.int64)
                if params.codec == entropy.AUTO_CODEC and len(raws) > 1:
                    # Per-block adaptive pick; the step records concrete
                    # ids only (one per block when they differ).
                    per = entropy.choose_block_codecs(raws,
                                                      params.zlib_level)
                    if len(set(per)) > 1:
                        codec = _primary_codec(per)
                        block_codecs = per
                        blks = entropy.compress_blocks_per_codec(
                            raws, per, level=params.zlib_level,
                            parallel=params.parallel_entropy)
                    else:
                        codec = per[0]
                        blks = entropy.compress_blocks(
                            raws, codec=codec, level=params.zlib_level,
                            parallel=params.parallel_entropy)
                else:
                    codec = entropy.resolve_codec(params.codec, raws,
                                                  params.zlib_level)
                    blks = entropy.compress_blocks(
                        raws, codec=codec, level=params.zlib_level,
                        parallel=params.parallel_entropy)
            sp_ent.set(codec=codec, blocks=len(blks))
        centers = round_centers(centers, curr.dtype)
        if centers.size > enc.marker:
            centers = centers[:enc.marker]
        ratio = entropy_ratio(blks, raw_sizes)
        bytes_in = int(np.asarray(raw_sizes).sum())
        bytes_out = sum(len(b) for b in blks)
        sp_fin.set(codec=codec, bytes_in=bytes_in, bytes_out=bytes_out)
    full_meta = StepMeta({"entropy_ratio": ratio, "zlib_ratio": ratio,
                          "entropy_codec": codec})
    full_meta.update(meta)
    if telemetry.enabled():
        # Canonical per-step rollup: one fixed key set whatever the driver
        # or overlap mode (obs.report.STEP_TELEMETRY_KEYS).
        device_entropy = enc.entropy_coded is not None
        full_meta["telemetry"] = {
            "analyze_s": float(drv_tele.get("analyze_s", 0.0)),
            "encode_s": float(drv_tele.get("encode_s", 0.0)),
            "exceptions_s": sp_exc.duration,
            "entropy_s": (float(drv_tele.get("device_entropy_s", 0.0))
                          if device_entropy else sp_ent.duration),
            "finalize_s": sp_fin.duration,
            "bytes_in": bytes_in, "bytes_out": bytes_out,
            "entropy_ratio": ratio, "codec": codec,
            "device_entropy": device_entropy,
        }
    return CompressedStep(
        n=n, shape=tuple(curr.shape), dtype=str(curr.dtype),
        b_bits=enc.b_bits, error_bound=params.error_bound,
        strategy=params.strategy, reference=params.reference,
        domain_lo=float(domain_lo), bin_width=float(width),
        centers=centers, block_elems=enc.block_elems, codec=codec,
        block_codecs=block_codecs,
        index_blocks=blks, index_block_nbytes=raw_sizes,
        incomp_values=incomp_values, incomp_block_offsets=incomp_off,
        meta=full_meta)


def anchor_telemetry(bytes_in: int, blks: List[bytes], codec: str,
                     seconds: float) -> dict:
    """The canonical ``meta["telemetry"]`` record of an anchor (or of one
    rank's anchor fragment): the whole step is the entropy stage."""
    bytes_out = sum(len(b) for b in blks)
    return {"analyze_s": 0.0, "encode_s": 0.0, "exceptions_s": 0.0,
            "entropy_s": seconds, "finalize_s": seconds,
            "bytes_in": bytes_in, "bytes_out": bytes_out,
            "entropy_ratio": bytes_in / max(bytes_out, 1), "codec": codec,
            "device_entropy": False}


def anchor_block_elems(params: NumarckParams, dtype) -> int:
    """Elements in a block of a lossless anchor: ``block_bytes`` worth."""
    return max(1, params.block_bytes // np.dtype(dtype).itemsize)


def finalize_anchor(arr: np.ndarray, params: NumarckParams,
                    dtype_name: Optional[str] = None) -> CompressedStep:
    """Lossless anchor through the same entropy stage (codec-aware).
    `dtype_name` is the dtype the step records over `arr`'s bytes when
    it is not ``str(arr.dtype)``: ``"bfloat16"`` over the uint16 storage
    that ``types.host_storage`` gives a bfloat16 tensor or ml_dtypes
    array, so the step is the reference's byte for byte."""
    arr = np.asarray(arr)
    dtype_name = dtype_name or str(arr.dtype)
    flat = arr.reshape(-1)
    block_elems = anchor_block_elems(params, flat.dtype)
    with telemetry.span("finalize.anchor", n=arr.size) as sp:
        raws = [flat[s:e].tobytes() for s, e in block_slices(flat.size,
                                                             block_elems)]
        codec = entropy.resolve_codec(params.codec, raws, params.zlib_level)
        blks = entropy.compress_blocks(raws, codec=codec,
                                       level=params.zlib_level,
                                       parallel=params.parallel_entropy)
        sp.set(codec=codec)
    meta: dict = {"kind": "anchor"}
    if telemetry.enabled():
        meta["telemetry"] = anchor_telemetry(arr.size * flat.dtype.itemsize,
                                             blks, codec, sp.duration)
    return CompressedStep(
        n=arr.size, shape=tuple(arr.shape), dtype=dtype_name,
        b_bits=0, error_bound=params.error_bound, strategy=params.strategy,
        reference=params.reference, domain_lo=0.0, bin_width=0.0,
        centers=np.zeros(0), block_elems=block_elems, codec=codec,
        index_blocks=blks, meta=meta)


def reconstruct_from_indices(prev: np.ndarray, enc: EncodedIndices,
                             centers: np.ndarray, dtype,
                             incomp_values: Optional[np.ndarray] = None,
                             curr: Optional[np.ndarray] = None) -> np.ndarray:
    """Reconstruct R_i from the *pre-entropy* encode result (the host
    chain advance), in ``reconstruction_dtype(dtype)``; bit-identical to
    ``decompress_step`` on the finalized blob and to the device chain."""
    marker = enc.marker
    prev = np.asarray(prev)
    cdt = reconstruction_dtype(dtype)
    prev_flat = prev.reshape(-1).astype(cdt, copy=False)
    centers = np.asarray(centers, np.float64).astype(cdt)
    lut = np.concatenate([centers, np.zeros(marker + 1 - centers.size,
                                            cdt)])
    out = prev_flat * (1 + lut[enc.idx])
    mask = enc.idx == marker
    if mask.any():
        if incomp_values is None:
            if curr is None:
                raise ValueError("marker lanes need incomp_values or curr")
            incomp_values = np.asarray(curr).reshape(-1)[mask]
        out[mask] = incomp_values.astype(cdt)
    return out.astype(dtype).reshape(prev.shape)


__all__ = ["StepMeta", "EncodedIndices", "DeviceEncoded", "block_slices",
           "topk_centers", "round_centers", "split_packed",
           "pack_blocks_host", "exception_offsets", "exception_table",
           "entropy_ratio", "finalize_step", "finalize_anchor",
           "anchor_telemetry", "anchor_block_elems",
           "reconstruct_from_indices", "reconstruction_dtype"]
