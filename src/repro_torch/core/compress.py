"""Single-device NUMARCK compress / decompress driver.

The port's counterpart of the reference's ``core/compress.py``.  Device
stages, on the compressor's device:

  1. `_analyze`     -- ratios and their global range, candidate-bin ids
                       and ratios (change-ratio kernel), histogram
                       (histogram kernel), stable descending sort, auto-B
  2. indexing       -- `encode_topk`: rank LUT + per-element index
                       assignment (top-k), or `_encode_centers`: the
                       nearest of the equal-width, log-scale or k-means
                       centers (``binning``; the centers themselves are a
                       host computation, as small as the histogram);
                       then exception compaction and bit-packing of the
                       whole marker-padded table (bit-pack kernel)

  3. device entropy (``codec="rans"``, payloads of at least
                       ``rans.DEVICE_MIN_BYTES``) -- the rANS encode
                       kernel codes the packed bytes (v1 blobs) or, with
                       ``symbol_rans`` and top-k, the indices themselves
                       (v2)

then the shared host finalize of ``core.pipeline``.  The REF_RECONSTRUCTED
chain advances through the fused chain-advance kernel when it is
device-resident.  ``TemporalCompressor`` is the streaming shell of
``core.stream`` (step loop, chain, finalize queue, series drain) with two
hooks of its own: ``_make_chain`` (``chain.make_reference_chain``) and
``_device_encode`` (the staged upload, then ``encode_device``); its
finalize hooks are the shell's, ``finalize_anchor`` and ``finalize_step``.
On ``device="cpu"`` every kernel call takes its plain PyTorch version;
both give the reference's steps byte for byte.
``NumarckParams.fixed_domain`` is ignored here, as by the reference's
single-device driver; the sharded driver reads it.

Decompression of rANS steps runs on the decompressor's device
(``device_decode_route``): the rANS decode kernel, the dequantize kernel,
then the exception patch, with the chain state kept there between steps.
Other codecs take the host route, as in the reference.

Telemetry (``repro_torch.obs``): the reference's ``encode.*`` and
``decode.*`` spans, the driver timings in ``meta["telemetry"]`` that
finalize folds into the per-step record, and the per-read record
``meta["telemetry_read"]``.  With telemetry enabled each device stage
ends in a ``torch.cuda.synchronize`` so a span means stage time, as the
reference's ``block_until_ready``; disabled, nothing waits.  Beyond the
reference's spans, each ``add_async`` of the shell is one
``compress.step`` span, and every call of a delta step that blocks the
host on the device (a copy either way, a ``nonzero``, a ``tolist``) is a
``sync.<site>`` span of its own, where the call is made (ratios,
select_b, ops, rans, chain).  The stage syncs are not program syncs and
stay outside the ``sync.*`` family (``stage_sync``).  The step's upload
does not block: its host staging is the ``upload.stage`` span (`_upload`).
``encode_topk``, ``decode_index_host``, ``record_read`` and
``stage_sync`` are shared with the sharded driver.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import binning, blocks, entropy, ratios, select_b
from repro_torch.core import chain as chainmod
from repro_torch.core import pipeline as pipe
from repro_torch.core.pipeline import DeviceEncoded
from repro_torch.core.stream import StreamCompressor
from repro_torch.core.types import (STRATEGY_EQUAL, STRATEGY_LOG,
                                    STRATEGY_TOPK, CompressedStep,
                                    NumarckParams, step_dtype, storage_tensor)
from repro_torch.faults.errors import IntegrityError
from repro_torch.kernels import ops as kops
from repro_torch.kernels import rans
from repro_torch.kernels.dequant import patch_exceptions
from repro_torch.obs import telemetry


def _to_device(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.tensor(np.asarray(x), device=device)


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A private copy of ``arr`` on ``device``, the bytes that
    ``torch.tensor(arr, device=device)`` gives, without waiting for the
    device.  torch's intra-op threads copy ``arr`` into a staging tensor
    (pinned host memory for a CUDA device), which is sent whole on the
    current stream; returns once ``arr`` has been read.  The caching host
    allocator reuses a staging block only after the copy out of it has
    ended.  An array ``torch.from_numpy`` refuses takes ``torch.tensor``."""
    try:
        src = torch.from_numpy(arr)     # a read-only array is only read
    except (TypeError, ValueError):
        return torch.tensor(arr, device=device)
    stage = torch.empty(src.shape, dtype=src.dtype,
                        pin_memory=device.type == "cuda")
    stage.copy_(src)
    out = torch.empty(src.shape, dtype=src.dtype, device=device)
    out.copy_(stage, non_blocking=True)
    return out


def stage_sync(dev: torch.device) -> None:
    """End a device stage under telemetry: wait for the work queued on
    ``dev`` (the reference's ``block_until_ready``).  Callers guard it
    with ``telemetry.enabled()``, so a disabled run never waits."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _analyze(prev: torch.Tensor, curr: torch.Tensor, params: NumarckParams,
             elem_bytes: int) -> dict:
    """Ratios' range, candidate bins, histogram, descending sort, auto-B.

    The range pass is plain PyTorch (the reference's ``ratio_range``);
    the change-ratio kernel then recomputes the ratios with the domain in
    hand, as the reference's sharded analyze does.  The range also bounds
    the ids, which sizes the histogram kernel's table.  The kernel's
    ratios and the range pass's validity mask are kept for the strategies
    that assign the nearest center.
    """
    r, valid = ratios.change_ratios(prev, curr)
    lo, hi = ratios.ratio_range(r, valid)
    del r
    domain_lo, width, bound = ratios.histogram_domain(
        lo, hi, params.error_bound, params.max_bins)
    r, bin_ids = kops.change_ratio_bins(prev, curr, domain_lo, width,
                                        max_bins=params.max_bins)
    counts = kops.histogram(bin_ids, max_bins=params.max_bins,
                            id_bound=bound)
    counts_desc, ids_desc = binning.sort_histogram(counts)
    b_auto, est_sizes = select_b.choose_b(counts_desc, curr.numel(),
                                          elem_bytes, params.b_max)
    return dict(ratios=r, valid=valid, bin_ids=bin_ids, counts=counts,
                counts_desc=counts_desc, ids_desc=ids_desc,
                domain_lo=domain_lo, width=width, b_auto=b_auto,
                est_sizes=est_sizes, lo=lo, hi=hi)


def encode_topk(bin_ids, ids_desc, b_bits: int, k_eff: int, max_bins: int):
    """Top-k indexing: each element's rank among the k_eff most frequent
    bins, the B-bit marker for every other bin and every invalid ratio."""
    marker = (1 << b_bits) - 1
    lut = binning.rank_lut(ids_desc[:k_eff], k_eff, max_bins)
    # rank_lut fills non-selected with k_eff; remap to the B-bit marker.
    ranks = lut[bin_ids.clamp(0, max_bins - 1).to(torch.int64)]
    ranks = torch.where(ranks >= k_eff, marker, ranks)
    return torch.where(bin_ids >= 0, ranks, marker).to(torch.int32)


# The names encode_device calls them by (the benchmark's fault tests patch
# `_encode_topk` here).
_sync, _encode_topk = stage_sync, encode_topk


def _strategy_centers(a: dict, params: NumarckParams, k: int) -> np.ndarray:
    """Sorted float32 centers of the equal-width, log-scale or k-means
    strategy (``params.strategy``, not top-k) for one step, on the host
    (``binning``)."""
    if params.strategy == STRATEGY_EQUAL:
        cs = binning.equal_width_centers(a["lo"], a["hi"], k)
    elif params.strategy == STRATEGY_LOG:
        cs = binning.log_scale_centers(
            *binning.log_range(a["ratios"], a["valid"]), k)
    else:
        cs = binning.kmeans_centers(a["counts"].cpu().numpy(), a["domain_lo"],
                                    a["width"], min(k, params.kmeans_max_k),
                                    params.kmeans_iters)
    return np.sort(cs)


def _encode_centers(r, valid, centers_sorted, error_bound, b_bits: int):
    marker = (1 << b_bits) - 1
    idx = binning.assign_nearest(r, valid, centers_sorted, error_bound)
    return torch.where(idx >= centers_sorted.numel(), marker, idx).to(
        torch.int32)


def _pad_blocks(idx: torch.Tensor, b_bits: int,
                block_elems: int) -> torch.Tensor:
    """The index table padded with markers to whole blocks."""
    n = idx.numel()
    padded = torch.full((-(-n // block_elems) * block_elems,),
                        (1 << b_bits) - 1, dtype=torch.int32,
                        device=idx.device)
    padded[:n] = idx
    return padded


def _pack_blocks_device(padded: torch.Tensor, b_bits: int,
                        block_elems: int) -> List[bytes]:
    """Pack the whole marker-padded table in one kernel launch, fetch the
    words once and slice them per block on the host."""
    words = kops.pack_bits(padded, b_bits=b_bits)
    with telemetry.span("sync.packed"):
        raw = words.cpu().numpy()
    raw = raw.astype("<u4", copy=False).tobytes()
    return pipe.split_packed(raw, padded.numel() // block_elems, block_elems,
                             b_bits)


def symbol_entropy_route(params: NumarckParams, b_bits: int,
                         k_eff: int) -> bool:
    """Use the symbol-level (v2/NCK3) coder for this step's blocks?
    Top-k only, and the {rank, marker} alphabet must fit the frequency
    budget (k_eff + 1 <= 2^SCALE_BITS)."""
    return (params.symbol_rans and params.strategy == STRATEGY_TOPK
            and k_eff + 1 <= rans.M)


def device_entropy_route(params: NumarckParams, n: int, b_bits: int) -> bool:
    """Route the entropy stage to the codec's device encoder?  Blobs are
    byte-identical either way; small payloads stay on the host codec."""
    if not params.device_entropy or params.codec == entropy.AUTO_CODEC:
        return False
    try:
        codec = entropy.get_codec(params.codec)
    except ValueError:
        return False
    return codec.device and n * b_bits // 8 >= rans.DEVICE_MIN_BYTES


def device_decode_route(step: CompressedStep) -> bool:
    """Read a step through the device decode path?  Homogeneous
    device-codec blocks and a payload of at least DEVICE_MIN_BYTES.  The
    reconstruction is bit-identical either way, float64 included (torch
    holds it natively, where the reference needs x64), so this is purely
    a wall-clock choice."""
    if step.block_codecs is not None:
        return False
    try:
        codec = entropy.get_codec(step.codec)
    except ValueError:
        return False
    if not codec.device:
        return False
    if step.is_anchor:
        nbytes = step.n * step_dtype(step.dtype).itemsize
    else:
        nbytes = step.n * step.b_bits // 8
    return nbytes >= rans.DEVICE_MIN_BYTES


def encode_device(prev, curr, params: NumarckParams,
                  need_host_idx: bool = True, device=None) -> DeviceEncoded:
    """Device stages for one step: analyze + strategy indexing + packing.

    `prev`/`curr` may be host ndarrays or tensors (a device-resident chain
    feeds its state straight back in).  Tensors run on their own device;
    ndarrays are copied to ``device`` (CUDA unless the caller asks for
    another).  ``need_host_idx=False`` skips the host copy of the index
    table, which only a host-resident chain reads.
    """
    if isinstance(curr, torch.Tensor):
        dev = curr.device
    elif isinstance(prev, torch.Tensor):
        dev = prev.device
    else:
        dev = chainmod.resolve_device(device)
    prev_t = _to_device(prev, dev)
    curr_t = _to_device(curr, dev)
    if prev_t.shape != curr_t.shape:
        raise ValueError("temporal steps must share a shape")
    dtype = np.dtype(str(curr_t.dtype).removeprefix("torch."))
    n = curr_t.numel()
    tele = telemetry.enabled()
    with telemetry.span("encode.analyze") as sp_an:
        a = _analyze(prev_t.reshape(-1), curr_t.reshape(-1), params,
                     dtype.itemsize)
        if tele:
            _sync(dev)
    with telemetry.span("encode.index", strategy=params.strategy) as sp_idx:
        if params.strategy == STRATEGY_TOPK:
            b_bits = int(params.b_bits if params.b_bits is not None
                         else a["b_auto"])
            k_eff = min((1 << b_bits) - 1, params.max_bins)
            idx = _encode_topk(a["bin_ids"], a["ids_desc"], b_bits, k_eff,
                               params.max_bins)
            with telemetry.span("sync.centers"):
                sel = a["ids_desc"][:k_eff].cpu().numpy()
            centers = pipe.topk_centers(sel, k_eff, float(a["domain_lo"]),
                                        float(a["width"]))
        else:
            b_bits = int(params.b_bits if params.b_bits is not None else 8)
            k_eff = (1 << b_bits) - 1
            cs = _strategy_centers(a, params, k_eff)
            idx = _encode_centers(a["ratios"], a["valid"],
                                  torch.from_numpy(cs).to(dev),
                                  params.error_bound, b_bits)
            centers = cs.astype(np.float64)
        if tele:
            _sync(dev)
    del a["ratios"], a["valid"]         # free before packing
    centers = pipe.round_centers(centers, dtype)
    be = params.block_elems(b_bits)
    marker = (1 << b_bits) - 1
    exc_counts = exc_pos = packed = coded = coded_name = None
    with telemetry.span("encode.exceptions") as sp_exc:
        if n:
            exc_counts, exc_pos = kops.exception_compact(idx, n, marker, be)
    on_device = bool(n) and device_entropy_route(params, n, b_bits)
    with telemetry.span("encode.device_entropy") as sp_de:
        # Device entropy stage: finalize takes the finished blobs.
        if on_device:
            padded = _pad_blocks(idx, b_bits, be)
            nblocks = padded.numel() // be
            if symbol_entropy_route(params, b_bits, k_eff):
                with telemetry.span("sync.counts"):
                    counts = a["counts_desc"][:k_eff].cpu().numpy()
                coded = rans.compress_blocks_device_symbols(
                    padded, b_bits, k_eff, nblocks, be, counts)
            else:
                coded = rans.compress_blocks_device(padded, b_bits, nblocks,
                                                    be)
            coded_name = params.codec
    pack_s = 0.0
    if n and not on_device:
        # The bit-pack kernel and one copy of the words to the host (the
        # reference's sharded driver's stage of the same name).
        with telemetry.span("encode.pack_fetch") as sp_pack:
            packed = _pack_blocks_device(_pad_blocks(idx, b_bits, be),
                                         b_bits, be)
        pack_s = sp_pack.duration
    with telemetry.span("encode.idx_fetch") as sp_fetch:
        idx_host = None
        if need_host_idx:
            with telemetry.span("sync.idx"):
                idx_host = idx.cpu().numpy()
    enc = pipe.EncodedIndices(
        idx=idx_host, b_bits=b_bits, block_elems=be, n=n, packed=packed,
        entropy_coded=coded, entropy_codec=coded_name,
        exc_positions=exc_pos, exc_block_counts=exc_counts)
    meta = {"b_auto": int(a["b_auto"]),
            "est_sizes": a["est_sizes"].numpy().tolist(),
            "ratio_min": float(a["lo"]), "ratio_max": float(a["hi"])}
    if tele:
        # Driver stage timings; finalize_step folds them into the
        # canonical per-step meta["telemetry"] record and pops this dict.
        meta["telemetry"] = {
            "analyze_s": sp_an.duration,
            "encode_s": (sp_idx.duration + sp_exc.duration + pack_s
                         + sp_fetch.duration),
            "device_entropy_s": sp_de.duration,
        }
    return DeviceEncoded(enc=enc, centers=centers,
                         domain_lo=float(a["domain_lo"]),
                         width=float(a["width"]), meta=meta, idx_dev=idx,
                         curr_dev=(curr if isinstance(curr, torch.Tensor)
                                   else None))


def make_anchor(arr: np.ndarray, params: NumarckParams,
                dtype_name: Optional[str] = None) -> CompressedStep:
    """Losslessly stored first iteration, in entropy-coded blocks; see
    ``pipeline.finalize_anchor`` for `dtype_name`."""
    return pipe.finalize_anchor(arr, params, dtype_name)


def compress_step(prev: np.ndarray, curr: np.ndarray, params: NumarckParams,
                  device=None) -> CompressedStep:
    """Compress `curr` against the reference state `prev` (Eq. 1/4)."""
    dev = encode_device(prev, curr, params, need_host_idx=False,
                        device=device)
    return pipe.finalize_step(np.asarray(curr), dev.enc, dev.centers,
                              dev.domain_lo, dev.width, params, dev.meta)


def record_read(step: CompressedStep, entropy_s: float = 0.0,
                dequant_s: float = 0.0, patch_s: float = 0.0,
                fetch_s: float = 0.0, device: bool = False) -> None:
    """Fold the decode-side span durations into the canonical per-read
    telemetry record (``obs.report.READ_TELEMETRY_KEYS``), identical
    across the single-device, sharded and anchor read paths."""
    step.meta["telemetry_read"] = {
        "entropy_s": entropy_s, "dequant_s": dequant_s, "patch_s": patch_s,
        "fetch_s": fetch_s,
        "bytes_in": int(sum(len(b) for b in step.index_blocks)),
        "bytes_out": int(step.n) * step_dtype(step.dtype).itemsize,
        "codec": step.codec, "device_decode": bool(device)}


def _fetch(step: CompressedStep, out: torch.Tensor) -> np.ndarray:
    """The one copy of a device reconstruction to the host, timed as
    ``decode.fetch`` into the step's read record."""
    with telemetry.span("decode.fetch") as sp_f:
        host = out.to("cpu", copy=True).numpy()
    if telemetry.enabled() and "telemetry_read" in step.meta:
        step.meta["telemetry_read"]["fetch_s"] = sp_f.duration
    return host


def decode_anchor(step: CompressedStep, device=None) -> np.ndarray:
    """Reconstruction of a losslessly stored anchor step, on the host.
    On the device decode route the rANS decode kernel inflates the blocks
    on ``device`` (CUDA unless the caller asks for the CPU) and only the
    finished bytes come back; otherwise the host codecs inflate them.
    The array has the step's storage dtype: a bfloat16 step comes back as
    its uint16 bits (``types.storage_tensor`` views them as bfloat16)."""
    dev = chainmod.resolve_device(device)
    sd = step_dtype(step.dtype)
    route = device_decode_route(step)
    with telemetry.span("decode.entropy") as sp_e:
        if route:
            raw = rans.decode_bytes_blocks_device(
                step.index_blocks, dev).cpu().numpy().tobytes()
        else:
            raw = b"".join(entropy.decompress_blocks(step.index_blocks,
                                                     step.codec))
    try:
        out = np.frombuffer(raw, dtype=sd.storage).reshape(step.shape).copy()
    except ValueError as e:
        raise IntegrityError(
            f"anchor decode produced {len(raw)} bytes, expected "
            f"{step.n * sd.itemsize} for shape "
            f"{tuple(step.shape)} {step.dtype} ({e}) -- payload corrupt "
            "or truncated") from e
    if telemetry.enabled():
        record_read(step, entropy_s=sp_e.duration, device=route)
    return out


def decode_anchor_device(step: CompressedStep, device=None) -> torch.Tensor:
    """Anchor decode that leaves the reconstruction on ``device``: on the
    device decode route the decoded bytes are viewed in place as
    ``step.dtype``; otherwise the host decode is uploaded once.  The
    result is identical either way.  A bfloat16 step is viewed as
    ``torch.bfloat16`` on the device (the reference decodes it on the
    host); the bits are the same."""
    dev = chainmod.resolve_device(device)
    sd = step_dtype(step.dtype)
    if not device_decode_route(step):
        return storage_tensor(decode_anchor(step, dev), sd.name).to(dev)
    tele = telemetry.enabled()
    with telemetry.span("decode.entropy") as sp_e:
        flat = rans.decode_bytes_blocks_device(step.index_blocks, dev)
        want = step.n * sd.itemsize
        if flat.numel() != want:
            raise IntegrityError(
                f"anchor decode produced {flat.numel()} bytes, expected "
                f"{want} for shape {tuple(step.shape)} {step.dtype} -- "
                "payload corrupt or truncated")
        out = flat.view(sd.torch).reshape(step.shape)
        if tele:
            stage_sync(dev)
    if tele:
        record_read(step, entropy_s=sp_e.duration, device=True)
    return out


def decode_index_host(step: CompressedStep) -> np.ndarray:
    """Inflate every index block into one (n,) int32 buffer, block-parallel
    over the shared entropy pool for payloads worth the dispatch."""
    idx = np.empty(step.n, np.int32)
    slices = list(blocks.block_slices(step.n, step.block_elems))

    def inflate(bi: int) -> None:
        s, e = slices[bi]
        idx[s:e] = blocks.inflate_block(step.index_blocks[bi], e - s,
                                        step.b_bits,
                                        codec=step.codec_for_block(bi))

    payload = sum(len(b) for b in step.index_blocks)
    if len(slices) > 1 and payload >= entropy._MIN_PARALLEL_BYTES:
        list(entropy._shared_pool().map(inflate, range(len(slices))))
    else:
        for bi in range(len(slices)):
            inflate(bi)
    return idx


def decompress_step_device(step: CompressedStep, prev,
                           device=None) -> torch.Tensor:
    """Device-resident reconstruction of one delta step: the rANS decode
    kernel, the dequantize kernel, then the exception patch, with no host
    round trip.  ``prev`` may be a host array or a tensor (the device
    decompressor feeds its state straight back in).  Returns a
    ``step.shape`` tensor of the source dtype, bit-identical to the host
    ``decompress_step`` (same IEEE operations on the same values)."""
    if prev is None:
        raise ValueError("non-anchor steps need the previous state")
    dev = (prev.device if isinstance(prev, torch.Tensor)
           else chainmod.resolve_device(device))
    tele = telemetry.enabled()
    cdt = step_dtype(pipe.reconstruction_dtype(step.dtype)).torch
    with telemetry.span("decode.entropy") as sp_e:
        idx = rans.decode_blocks_device(step.index_blocks, step.b_bits,
                                        step.block_elems, dev)
        idx = idx.reshape(-1)[:step.n].contiguous()
        if tele:
            stage_sync(dev)
    with telemetry.span("decode.dequant") as sp_d:
        prev_t = _to_device(prev, dev).reshape(-1).to(cdt).contiguous()
        centers = torch.tensor(step.centers, device=dev).to(cdt)
        recon = kops.dequantize(idx, prev_t, centers, b_bits=step.b_bits)
        if tele:
            stage_sync(dev)
    with telemetry.span("decode.patch") as sp_p:
        if step.n_incompressible:
            recon = patch_exceptions(
                recon, idx, torch.tensor(step.incomp_values, device=dev),
                b_bits=step.b_bits)
        out = recon.to(step_dtype(step.dtype).torch).reshape(step.shape)
        if tele:
            stage_sync(dev)
    if tele:
        record_read(step, entropy_s=sp_e.duration, dequant_s=sp_d.duration,
                    patch_s=sp_p.duration, device=True)
    return out


def decompress_step(step: CompressedStep, prev: Optional[np.ndarray],
                    device=None) -> np.ndarray:
    """Reconstruct R_i = R_{i-1} * (1 + center)  (corrected Eq. 4) in the
    step's source precision (``reconstruction_dtype``).  Steps on the
    device decode route run on ``device`` (CUDA unless the caller asks
    for the CPU) with one final copy to the host; the rest decode on the
    host.  The result is bit-identical either way."""
    dev = chainmod.resolve_device(device)
    if step.is_anchor:
        return decode_anchor(step, dev)
    if prev is None:
        raise ValueError("non-anchor steps need the previous state")
    if device_decode_route(step):
        return _fetch(step, decompress_step_device(step, prev, dev))
    cdt = pipe.reconstruction_dtype(step.dtype)
    marker = (1 << step.b_bits) - 1
    with telemetry.span("decode.entropy") as sp_e:
        idx = decode_index_host(step)
    with telemetry.span("decode.dequant") as sp_d:
        prev_flat = np.asarray(prev).reshape(-1).astype(cdt, copy=False)
        centers = np.concatenate([step.centers,
                                  np.zeros(marker + 1 - step.centers.size)
                                  ]).astype(cdt)
        out = prev_flat * (1 + centers[idx])
    with telemetry.span("decode.patch") as sp_p:
        if step.n_incompressible:
            # Exception values are compacted in stream order == block
            # order.
            out[idx == marker] = step.incomp_values.astype(cdt)
    if telemetry.enabled():
        record_read(step, entropy_s=sp_e.duration, dequant_s=sp_d.duration,
                    patch_s=sp_p.duration, device=False)
    return out.astype(step.dtype).reshape(step.shape)


class TemporalCompressor(StreamCompressor):
    """Streaming compressor over a temporal series on one device: the
    shell of ``core.stream`` with ``encode_device`` as its device stages.
    ``chain`` picks the residency of the reference chain ("auto" = on
    ``device``, "host", "device").  ``device`` defaults to CUDA; pass
    ``"cpu"`` for the plain versions.
    """

    def __init__(self, params: NumarckParams = NumarckParams(),
                 overlap: bool = False, chain: str = chainmod.CHAIN_AUTO,
                 device=None):
        super().__init__(params, overlap, chain)
        self.device = chainmod.resolve_device(device)

    def _make_chain(self, dtype) -> chainmod.ReferenceChain:
        return chainmod.make_reference_chain(self.chain, dtype, self.device)

    def _device_encode(self, prev, curr: np.ndarray) -> DeviceEncoded:
        on_device = self._chain.residency == chainmod.CHAIN_DEVICE
        # One upload of `curr`, shared by the encode and the chain advance;
        # a private copy, read before `_upload` returns, since callers may
        # reuse their buffers at once.
        curr_in = curr
        if on_device:
            with telemetry.span("upload.stage"):
                curr_in = _upload(curr, self.device)
        return encode_device(prev, curr_in, self.params,
                             need_host_idx=not on_device, device=self.device)


class TemporalDecompressor:
    """Streaming decompressor; mirrors TemporalCompressor state chaining.

    Runs on ``device`` (CUDA unless the caller asks for the CPU; no GPU
    raises).  While consecutive steps take the device decode route the
    state stays a tensor on the device between steps; ``add`` returns a
    host copy.  Reconstructions are bit-identical across routes.
    """

    def __init__(self, device=None):
        self.device = chainmod.resolve_device(device)
        self._state = None          # np.ndarray, or a tensor on the device

    def add(self, step: CompressedStep) -> np.ndarray:
        if not step.is_anchor and device_decode_route(step):
            self._state = decompress_step_device(step, self._state,
                                                 self.device)
            return _fetch(step, self._state)
        prev = (self._state.cpu().numpy()
                if isinstance(self._state, torch.Tensor) else self._state)
        self._state = decompress_step(step, prev, self.device)
        return self._state

    def reset(self):
        self._state = None


def compress_series(arrays, params: NumarckParams = NumarckParams(),
                    overlap: bool = False, chain: str = chainmod.CHAIN_AUTO,
                    device=None) -> List[CompressedStep]:
    """Compress a temporal series on ``device`` (CUDA unless the caller
    asks for the CPU); at most two finalizes are in flight at once."""
    c = TemporalCompressor(params, overlap=overlap, chain=chain,
                           device=device)
    try:
        return c.compress_series(arrays)
    finally:
        c.close()


def decompress_series(steps: List[CompressedStep],
                      device=None) -> List[np.ndarray]:
    """Decompress a series on ``device`` (CUDA unless the caller asks for
    the CPU)."""
    d = TemporalDecompressor(device)
    return [d.add(s) for s in steps]


__all__ = ["compress_step", "decompress_step", "decompress_step_device",
           "make_anchor", "decode_anchor", "decode_anchor_device",
           "encode_device", "device_entropy_route", "device_decode_route",
           "symbol_entropy_route", "DeviceEncoded", "TemporalCompressor",
           "encode_topk", "decode_index_host", "record_read", "stage_sync",
           "TemporalDecompressor", "compress_series", "decompress_series"]
