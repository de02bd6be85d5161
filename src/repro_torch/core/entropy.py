"""Pluggable host-side entropy stage with a parallel block dispatcher.

Copy of the reference's ``core/entropy.py``: ``zlib`` (default), ``raw``
(store), ``lzma``, ``bz2`` and ``rans`` (the interleaved rANS coder of
``kernels.rans``, whose device flavor the drivers call directly), plus
the ``"auto"`` pseudo-codec (per-payload and per-block choice from a
sampled zlib probe).  The C codecs release the GIL, so one shared thread
pool gives real parallel speedup.  Codecs that *hold* the GIL
(``Codec.holds_gil = True``) are dispatched over a forked process pool
instead, whose workers run the codec's Python code only (never a torch
operation, so a CUDA context inherited by the fork is never touched);
a failed or wedged pool is retired and the blocks go through the thread
pool, which re-raises the codec's own error if the codec is at fault.

Blocks are grouped into tasks of at least ``_TARGET_TASK_BYTES`` so that
submission overhead stays small; output is byte-identical to the serial
loop, because per-block codec streams are independent.
"""
from __future__ import annotations

import bz2
import lzma
import multiprocessing
import os
import threading
import time
import zlib
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

from repro_torch.faults import inject
from repro_torch.faults.errors import IntegrityError
from repro_torch.obs import telemetry

# --------------------------------------------------------------------- codecs


class Codec:
    """Entropy codec interface: bytes -> bytes, self-inverse via decompress."""

    name: str = "abstract"
    # Pure-python codecs that never release the GIL get no speedup from the
    # thread pool; mark them and compress_blocks dispatches them over a
    # forked process pool instead.
    holds_gil: bool = False
    # Codecs with a device encoder and decoder (kernels.rans): the drivers
    # code index blocks on the device, byte-identical to this host flavor.
    device: bool = False

    def compress(self, raw: bytes, level: int) -> bytes:
        raise NotImplementedError

    def decompress(self, blob: bytes) -> bytes:
        raise NotImplementedError


class ZlibCodec(Codec):
    name = "zlib"

    def compress(self, raw: bytes, level: int) -> bytes:
        return zlib.compress(raw, level)

    def decompress(self, blob: bytes) -> bytes:
        return zlib.decompress(blob)


class RawCodec(Codec):
    """Store-only codec: no entropy coding."""

    name = "raw"

    def compress(self, raw: bytes, level: int) -> bytes:
        return raw

    def decompress(self, blob: bytes) -> bytes:
        return blob


class LzmaCodec(Codec):
    """LZMA: slowest, highest ratio; level maps to preset 0-9."""

    name = "lzma"

    def compress(self, raw: bytes, level: int) -> bytes:
        return lzma.compress(raw, preset=min(max(level, 0), 9))

    def decompress(self, blob: bytes) -> bytes:
        return lzma.decompress(blob)


class Bz2Codec(Codec):
    name = "bz2"

    def compress(self, raw: bytes, level: int) -> bytes:
        return bz2.compress(raw, compresslevel=min(max(level, 1), 9))

    def decompress(self, blob: bytes) -> bytes:
        return bz2.decompress(blob)


class RansCodec(Codec):
    """Block-parallel interleaved rANS (``kernels.rans``).

    This registry entry is the host flavor; ``device=True`` tells
    the drivers to code index blocks with the device flavor instead
    (``kernels.rans.compress_blocks_device``), which emits the same
    self-describing blobs, so files do not record which one made them.
    Not ``holds_gil``, as in the reference: the process pool would fork
    while the device stage may be running on other threads, so the host
    flavor serializes under the GIL (throughput comes from the device).
    """

    name = "rans"
    device = True

    def compress(self, raw: bytes, level: int) -> bytes:
        from repro_torch.kernels import rans
        return rans.compress(raw)

    def decompress(self, blob: bytes) -> bytes:
        from repro_torch.kernels import rans
        return rans.decompress(blob)


DEFAULT_CODEC = "zlib"
AUTO_CODEC = "auto"
_REGISTRY: Dict[str, Codec] = {}


def register_codec(codec: Codec) -> Codec:
    _REGISTRY[codec.name] = codec
    return codec


def get_codec(name: str) -> Codec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown codec {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def codec_names() -> List[str]:
    return sorted(_REGISTRY)


def validate_codec_id(name: str) -> str:
    """Accept any registered codec plus the ``"auto"`` pseudo-id."""
    if name != AUTO_CODEC:
        get_codec(name)                  # raises on unknown codec
    return name


for _c in (ZlibCodec(), RawCodec(), LzmaCodec(), Bz2Codec(), RansCodec()):
    register_codec(_c)

# ------------------------------------------------------ adaptive selection

# The reference's auto policy, constant for constant: deflate a bounded
# prefix at level 1 and read the achieved ratio.
_AUTO_SAMPLE_BYTES = 64 << 10
_AUTO_RAW_THRESHOLD = 0.95       # probe ratio above this -> store raw
_AUTO_LZMA_THRESHOLD = 0.30      # probe ratio below this -> lzma pays off
_AUTO_LZMA_MAX_BYTES = 256 << 20  # lzma latency cap on the total payload


def _probe_one(raw: bytes, allow_lzma: bool = True) -> str:
    """One compressibility probe -> concrete codec (the auto policy)."""
    if not raw:
        return DEFAULT_CODEC
    sample = raw[:_AUTO_SAMPLE_BYTES]
    ratio = len(zlib.compress(sample, 1)) / len(sample)
    if ratio >= _AUTO_RAW_THRESHOLD:
        return "raw"
    if ratio <= _AUTO_LZMA_THRESHOLD and allow_lzma:
        return "lzma"
    return DEFAULT_CODEC


def choose_codec(raws: Sequence[bytes], level: int = 6) -> str:
    """Pick a concrete codec from the first non-empty block's probe."""
    del level
    total = sum(len(r) for r in raws)
    for r in raws:
        if r:
            return _probe_one(r, allow_lzma=total <= _AUTO_LZMA_MAX_BYTES)
    return DEFAULT_CODEC


def resolve_codec(codec: str, raws: Sequence[bytes], level: int = 6) -> str:
    """Map the parameter-level codec id to the concrete one used for this
    payload.  Identity for everything but ``"auto"``."""
    if codec == AUTO_CODEC:
        return choose_codec(raws, level)
    get_codec(codec)
    return codec


def choose_block_codecs(raws: Sequence[bytes], level: int = 6) -> List[str]:
    """Per-*block* codec choice: the ``"auto"`` probe applied to every
    block; the lzma cap stays a bound on the total payload."""
    del level
    total = sum(len(r) for r in raws)
    allow_lzma = total <= _AUTO_LZMA_MAX_BYTES
    if len(raws) >= 4 and total >= _MIN_PARALLEL_BYTES:
        picks = list(_shared_pool().map(
            lambda r: _probe_one(r, allow_lzma), raws))
    else:
        picks = [_probe_one(r, allow_lzma) for r in raws]
    if telemetry.enabled():
        for p in set(picks):
            telemetry.counter(f"entropy.auto.pick.{p}",
                              float(picks.count(p)))
    return picks

# ----------------------------------------------------------- parallel stage

# Below this total payload the pool overhead exceeds the win; stay serial.
_MIN_PARALLEL_BYTES = 1 << 20
# Batch consecutive blocks until each task carries at least this much.
_TARGET_TASK_BYTES = 2 << 20
# Per-task ceiling for process-pool results; beyond it the pool is marked
# broken and the codec degrades to the (serializing but correct) threads.
_PROC_RESULT_TIMEOUT_S = 120.0

_pool_lock = threading.Lock()
_pool: Optional[ThreadPoolExecutor] = None
_proc_pool: Optional[ProcessPoolExecutor] = None
_proc_pool_broken = False


def _shared_pool() -> ThreadPoolExecutor:
    """Process-wide entropy pool (created at first use; sized to the host
    CPUs)."""
    global _pool
    with _pool_lock:
        if _pool is None:
            workers = min(32, os.cpu_count() or 1)
            _pool = ThreadPoolExecutor(max_workers=workers,
                                       thread_name_prefix="entropy")
        return _pool


def _shared_proc_pool() -> Optional[ProcessPoolExecutor]:
    """Forked process pool for GIL-holding codecs.

    Fork (not spawn) so workers inherit the codec registry, including
    codecs registered after import; codecs registered after the pool's
    first use are not visible to workers -- register before compressing.
    Returns None where fork is unavailable (callers fall back to the
    thread pool, which is correct, just not parallel).
    """
    global _proc_pool, _proc_pool_broken
    with _pool_lock:
        if _proc_pool is None and not _proc_pool_broken:
            try:
                ctx = multiprocessing.get_context("fork")
                workers = min(8, os.cpu_count() or 1)
                _proc_pool = ProcessPoolExecutor(max_workers=workers,
                                                 mp_context=ctx)
            except (ValueError, OSError):
                _proc_pool_broken = True
        return _proc_pool


def _retire_proc_pool(px: ProcessPoolExecutor):
    """Permanently disable process dispatch and tear the pool down (without
    waiting on possibly-wedged workers)."""
    global _proc_pool, _proc_pool_broken
    with _pool_lock:
        _proc_pool_broken = True
        if _proc_pool is px:
            _proc_pool = None
    px.shutdown(wait=False, cancel_futures=True)


def _compress_batch(codec_name: str, raws: List[bytes],
                    level: int) -> List[bytes]:
    """Process-pool task body: resolve the codec by name in the worker."""
    # Injection site: a dying pool worker must exercise the
    # retire-and-degrade path in _dispatch_blocks, not hang the driver.
    inject.fire("entropy_worker_death", codec=codec_name, blocks=len(raws))
    c = get_codec(codec_name)
    return [c.compress(r, level) for r in raws]


def _task_plan(sizes: Sequence[int], workers: int) -> List[range]:
    """Group consecutive block indices into tasks, in order, at least
    `workers` of them unless the payload is small."""
    total = sum(sizes)
    n = len(sizes)
    n_tasks = max(workers, total // _TARGET_TASK_BYTES)
    n_tasks = max(1, min(n, n_tasks))
    step = -(-n // n_tasks)
    return [range(s, min(s + step, n)) for s in range(0, n, step)]


def _serial(raws: Sequence[bytes], parallel: bool) -> bool:
    return (not parallel or len(raws) < 2
            or sum(len(r) for r in raws) < _MIN_PARALLEL_BYTES)


def compress_blocks(raws: Sequence[bytes], codec: str = DEFAULT_CODEC,
                    level: int = 6, parallel: bool = True,
                    pool: Optional[ThreadPoolExecutor] = None) -> List[bytes]:
    """Entropy-code every block; the single finalize entry point.

    Serial for small payloads, thread-parallel (shared pool or ``pool``,
    batched tasks) otherwise, process-parallel for GIL-holding codecs.
    Output is byte-identical to the serial loop in every mode.
    """
    codec = resolve_codec(codec, raws, level)
    c = get_codec(codec)
    sizes = [len(r) for r in raws]
    with telemetry.span("entropy.compress", codec=codec,
                        blocks=len(raws)) as sp:
        out = _dispatch_blocks(c, codec, raws, sizes, level, parallel, pool)
        if telemetry.enabled():
            bytes_in, bytes_out = sum(sizes), sum(len(b) for b in out)
            telemetry.counter(f"entropy.bytes_in.{codec}", float(bytes_in))
            telemetry.counter(f"entropy.bytes_out.{codec}", float(bytes_out))
            sp.set(bytes_in=bytes_in, bytes_out=bytes_out)
    return out


def _dispatch_blocks(c: Codec, codec: str, raws: Sequence[bytes],
                     sizes: List[int], level: int, parallel: bool,
                     pool: Optional[ThreadPoolExecutor]) -> List[bytes]:
    """Serial / thread-pool / process-pool dispatch of compress_blocks."""
    if _serial(raws, parallel):
        return [c.compress(r, level) for r in raws]

    if c.holds_gil and pool is None:
        # GIL-holding codec: threads would serialize, so fan batches out to
        # forked worker processes instead (payload ships by pickle; the
        # >= _TARGET_TASK_BYTES batching keeps the IPC amortized).  Workers
        # run pure-python codec code only -- never torch -- and the result
        # timeout is the backstop: a wedged child degrades us to the
        # thread path instead of hanging the finalize stage.
        px = _shared_proc_pool()
        if px is not None:
            plan = _task_plan(sizes, px._max_workers)
            try:
                futs = [px.submit(_compress_batch, codec,
                                  [raws[i] for i in rng], level)
                        for rng in plan]
                out = []
                for f in futs:
                    out.extend(f.result(timeout=_PROC_RESULT_TIMEOUT_S))
                return out
            except Exception:  # noqa: BLE001 -- degrade; threads re-raise
                # Sandboxed fork, wedged worker, codec error in the child:
                # retire the pool entirely (a wedged pool would otherwise
                # re-stall every later call) and degrade to threads.  If
                # the codec itself is at fault the thread path below
                # re-raises the same error to the caller.
                _retire_proc_pool(px)

    ex = pool or _shared_pool()
    # Submit->start latency of each pool task: a loaded pool shows up as a
    # fat entropy.queue_wait_s histogram, not as mystery finalize time.
    tele = telemetry.enabled()
    t_submit = time.perf_counter() if tele else 0.0

    def run(rng: range) -> List[bytes]:
        if not tele:
            return [c.compress(raws[i], level) for i in rng]
        telemetry.histo("entropy.queue_wait_s",
                        time.perf_counter() - t_submit)
        with telemetry.span("entropy.batch", codec=codec, blocks=len(rng)):
            return [c.compress(raws[i], level) for i in rng]

    out: List[bytes] = []
    for part in ex.map(run, _task_plan(sizes, ex._max_workers)):
        out.extend(part)
    return out


def compress_blocks_per_codec(raws: Sequence[bytes], codecs: Sequence[str],
                              level: int = 6,
                              parallel: bool = True) -> List[bytes]:
    """Entropy-code every block with its *own* codec id (one pool
    dispatch over all blocks)."""
    if len(raws) != len(codecs):
        raise ValueError("one codec id per block")
    pairs = [(r, get_codec(c)) for r, c in zip(raws, codecs)]
    with telemetry.span("entropy.compress_per_codec", blocks=len(raws)):
        if _serial(raws, parallel):
            out = [c.compress(r, level) for r, c in pairs]
        else:
            out = list(_shared_pool().map(
                lambda rc: rc[1].compress(rc[0], level), pairs))
    if telemetry.enabled():
        for cname in set(codecs):
            bi = sum(len(r) for r, c in zip(raws, codecs) if c == cname)
            bo = sum(len(b) for b, c in zip(out, codecs) if c == cname)
            telemetry.counter(f"entropy.bytes_in.{cname}", float(bi))
            telemetry.counter(f"entropy.bytes_out.{cname}", float(bo))
    return out


def _decompress_one(c: Codec, codec: str, blob: bytes) -> bytes:
    """Decode one blob; codec failures become :class:`IntegrityError`."""
    try:
        return c.decompress(blob)
    except Exception as e:
        raise IntegrityError(
            f"entropy decode failed: codec {codec!r} rejected a "
            f"{len(blob)}-byte blob ({e!r}) -- block is corrupt or "
            "truncated") from e


def decompress_block(blob: bytes, codec: str = DEFAULT_CODEC) -> bytes:
    return _decompress_one(get_codec(codec), codec, blob)


def decompress_blocks(blobs: Sequence[bytes], codec: str = DEFAULT_CODEC,
                      parallel: bool = True) -> List[bytes]:
    """Inverse of compress_blocks (parallel when the payload warrants it)."""
    c = get_codec(codec)
    if _serial(blobs, parallel):
        return [_decompress_one(c, codec, b) for b in blobs]
    return list(_shared_pool().map(lambda b: _decompress_one(c, codec, b),
                                   blobs))


__all__ = ["Codec", "ZlibCodec", "RawCodec", "LzmaCodec", "Bz2Codec",
           "RansCodec",
           "DEFAULT_CODEC", "AUTO_CODEC", "register_codec", "get_codec",
           "codec_names", "validate_codec_id", "choose_codec",
           "choose_block_codecs", "resolve_codec", "compress_blocks",
           "compress_blocks_per_codec", "decompress_block",
           "decompress_blocks"]
