"""NCK container: netCDF-analogue file format (paper Sec. IV-D, Fig. 2).

No netCDF library is available in this environment, so we use a
self-describing single-file container with the *same logical layout* as the
paper's netCDF output:

  magic "NCK1" | u64 header_len | JSON header | pad->64 | section bytes ...

The JSON header mirrors netCDF dimensions/variables/attributes.  Each
compressed variable V (one per iteration per field) stores, exactly as in
Fig. 2:

  V_info                      -- attributes (total_data_num, bin_centers_number,
                                 elements_per_block, B, E, strategy, ...)
  V_bin_centers               -- float array
  V_index_table_offset        -- int64 byte offsets of deflated blocks
  V_incompressible_table_offset -- int64 per-block exception count prefix
  V_index_table               -- concatenated deflated blocks (byte array)
  V_incompressible_table      -- original-dtype exception values

Multiple variables per file are supported (paper: "NUMARCK allows multiple
compressed variables stored in one netCDF file").  Reads are offset-based so
partial decompression touches only the needed byte ranges.

Format versions: files whose steps all use one codec per step keep the
original "NCK1" magic (readable by every reader ever shipped); files
carrying per-*block* codec ids -- a layout older readers cannot decode
correctly -- are stamped "NCK2", so old readers reject them cleanly at
open instead of mis-decoding blocks.  Files carrying symbol-level rANS
blocks (kernels.rans v2 blobs, coding pre-pack B-bit indices -- bytes
older rANS decoders cannot parse) are stamped "NCK3" by the same
mechanism: the writer peeks each rans block's self-describing version
byte when the step is added.  Files carrying the *checksum frame* --
CRC-32 digests stamped into the header so every read path can verify
payload bytes before decoding them -- are "NCK4":

  magic "NCK4" | u64 header_len | u32 header_crc | JSON header | pad->64
              | section bytes ...

``header_crc`` is crc32(header + pad), so a flipped bit anywhere in the
metadata is caught before it can misdirect a read.  Each variable record
carries ``crc32`` (whole payload); blocked variables (index tables,
anchors, fragment tables) additionally carry ``block_crc32``, a per-block
digest list, so partial and sharded reads verify exactly the blocks they
slice.  Writers stamp the frame by default (``checksums=False`` restores
the NCK1/2/3 matrix for compatibility tests); this reader accepts all
four versions and raises a structured
:class:`repro_torch.faults.errors.CorruptBlockError` -- naming file, variable,
block and both digests -- instead of decoding garbage.

Multi-process output (paper Sec. IV-D collective write analogue): the
reference's fleet writes each rank's blocks to a rank file
``<path>.g<gen>.rank<k>`` -- a normal NCK file holding *step fragments*
-- and rank 0 publishes ``<path>`` as an "NCKM" manifest (schema 2: a
crc32 trailer, each rank file's size and crc32, the previous durable
generation under ``previous``).  This module holds the whole read side:
`NCKReader` opens a manifest as one logical file, verifies every rank
file, merges fragments back into `CompressedStep`s identical to a
single-process write, and falls back to the ``previous`` generation when
the newest one fails verification (``recovered_generation``).  The write
side is here too: `ShardNCKWriter` publishes one rank's fragments and
`write_manifest` is rank 0's self-healing commit of the manifest.

Every publish goes through `atomic_commit`: content is fsynced *before*
the rename makes it visible.  Under telemetry the publishes record the
reference's spans: ``nck.write``, ``nck.fsync``, ``nck.rename`` and
``nck.manifest``.  This module is the port's copy of the
reference's ``core/container.py``; the files it writes are byte-identical.
"""
from __future__ import annotations

import glob
import json
import os
import struct
import time
import zlib
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.types import CompressedStep, step_dtype
from repro_torch.faults import inject
from repro_torch.faults.errors import (CommitTimeoutError, CorruptBlockError,
                                       CorruptShardError, IntegrityError)
from repro_torch.faults.retry import Backoff
from repro_torch.kernels import rans
from repro_torch.obs import telemetry

_MAGIC_V1 = b"NCK1"
_MAGIC_V2 = b"NCK2"
_MAGIC_V3 = b"NCK3"
_MAGIC_V4 = b"NCK4"
_MAGICS = {_MAGIC_V1: 1, _MAGIC_V2: 2, _MAGIC_V3: 3, _MAGIC_V4: 4}
_MANIFEST_MAGIC = b"NCKM"       # multi-process manifest (not a data file)
_ALIGN = 64

# Checksum frame keys inside each variable record (NCK4 only).
_CRC_KEY = "crc32"              # crc32 of the whole variable payload
_BLOCK_CRC_KEY = "block_crc32"  # per-block crc32 list for blocked variables

_MANIFEST_SCHEMA = 2            # 2: crc trailer + per-rank crcs + previous


def atomic_commit(path: str, data: Union[bytes, Iterable[bytes]]) -> None:
    """Durable atomic publish: write to `path`.tmp, fsync, then rename.

    The one sanctioned way to make a file appear under a published name
    (NCK files route here, and so will the manifests of the sharded
    slice).  fsync runs BEFORE the rename so a crash can never publish a
    name whose content is not yet on disk.

    Fault-injection sites (active only under ``REPRO_FAULTS=``):
    ``fsync_fail`` / ``rename_fail`` raise OSError at the corresponding
    syscall; ``torn_shard`` / ``bitflip_shard`` corrupt the tmp file of a
    ``.rank`` shard publish so the damage rides the atomic rename exactly
    like real silent corruption would.
    """
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        if isinstance(data, (bytes, bytearray, memoryview)):
            f.write(data)
        else:
            for chunk in data:
                f.write(chunk)
        f.flush()
        inject.fire("fsync_fail", path=path)
        # durable BEFORE the rename publishes it
        with telemetry.span("nck.fsync"):
            os.fsync(f.fileno())
    inject.mangle_file(tmp, path)
    inject.fire("rename_fail", path=path)
    with telemetry.span("nck.rename"):
        os.replace(tmp, path)  # atomic publish (fault tolerance)


def _blobs_have_symbol_rans(blobs: List[bytes], codec: str,
                            block_codecs: Optional[List[str]]) -> bool:
    """Does any rans blob in this list carry the symbol-level (v2) blob
    format?  Old readers' rANS decoders cannot parse those bytes, so the
    file must not present itself as NCK1/NCK2."""
    for bi, blob in enumerate(blobs):
        c = block_codecs[bi] if block_codecs else codec
        if c != "rans" or len(blob) < 5:
            continue
        if rans.blob_version(blob) == 2:
            return True
    return False


def _has_symbol_blobs(step: CompressedStep) -> bool:
    return _blobs_have_symbol_rans(step.index_blocks, step.codec,
                                   step.block_codecs)


def _pad(n: int) -> int:
    return (-n) % _ALIGN


def _file_crc32(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                return crc
            crc = zlib.crc32(chunk, crc)


class NCKWriter:
    """Assemble sections then write the file in one shot (or via append).

    ``checksums=True`` (the default) stamps the NCK4 checksum frame:
    header crc + per-variable (and per-block, where blocked) payload
    digests.  ``checksums=False`` restores the NCK1/2/3 magic matrix for
    compatibility with pre-checksum readers.
    """

    def __init__(self, *, checksums: bool = True):
        self._sections: List[bytes] = []
        self._vars: Dict[str, dict] = {}
        self._dims: Dict[str, int] = {}
        self._offset = 0
        self._checksums = bool(checksums)
        # Bumped to 2 the moment a step with per-block codec ids is added;
        # NCK1 files must stay readable by pre-per-block readers.
        self._format_version = 1

    @property
    def checksums(self) -> bool:
        return self._checksums

    def add_array(self, name: str, arr: np.ndarray, attrs: Optional[dict] = None):
        arr = np.ascontiguousarray(arr)
        self._add_bytes(name, arr.tobytes(), str(arr.dtype), list(arr.shape),
                        attrs)

    def add_bytes(self, name: str, raw: bytes, attrs: Optional[dict] = None,
                  *, block_crcs: Optional[Sequence[int]] = None):
        self._add_bytes(name, raw, "uint8", [len(raw)], attrs,
                        block_crcs=block_crcs)

    def _add_bytes(self, name, raw, dtype, shape, attrs, *, block_crcs=None):
        if name in self._vars:
            raise ValueError(f"duplicate variable {name}")
        rec = dict(dtype=dtype, shape=shape, offset=self._offset,
                   nbytes=len(raw), attributes=attrs or {})
        if self._checksums:
            rec[_CRC_KEY] = zlib.crc32(raw)
            if block_crcs is not None:
                rec[_BLOCK_CRC_KEY] = [int(c) for c in block_crcs]
        self._vars[name] = rec
        self._dims[f"{name}_dim"] = int(np.prod(shape)) if shape else 1
        self._sections.append(raw)
        self._offset += len(raw) + _pad(len(raw))

    def _block_crcs(self, blocks: List[bytes]) -> Optional[List[int]]:
        if not self._checksums:
            return None
        return [zlib.crc32(b) for b in blocks]

    def add_step(self, name: str, step: CompressedStep):
        """Store one CompressedStep under variable prefix `name` (Fig. 2)."""
        info = dict(
            total_data_num=step.n, shape=list(step.shape), dtype=step.dtype,
            bin_centers_number=int(step.centers.size),
            elements_per_block=step.block_elems, B=step.b_bits,
            error_bound=step.error_bound, strategy=step.strategy,
            reference=step.reference, domain_lo=step.domain_lo,
            bin_width=step.bin_width, is_anchor=bool(step.is_anchor),
            n_blocks=step.n_blocks,
            n_incompressible=step.n_incompressible,
            codec=step.codec,
        )
        if step.block_codecs is not None:
            info["block_codecs"] = [str(c) for c in step.block_codecs]
            self._format_version = max(self._format_version, 2)
        if _has_symbol_blobs(step):
            self._format_version = 3
        offs_all = np.concatenate(
            [step.index_table_offsets(),
             [sum(len(b) for b in step.index_blocks)]]).astype(np.int64)
        if step.is_anchor:
            self.add_array(f"{name}_anchor_info", np.zeros(1, np.int32),
                           attrs=info)
            self.add_array(f"{name}_anchor_offset", offs_all)
            self.add_bytes(f"{name}_anchor", b"".join(step.index_blocks),
                           block_crcs=self._block_crcs(step.index_blocks))
            return
        self.add_array(f"{name}_info", np.zeros(1, np.int32), attrs=info)
        self.add_array(f"{name}_bin_centers",
                       step.centers.astype(step.dtype))
        self.add_array(f"{name}_index_table_offset", offs_all)
        self.add_array(f"{name}_incompressible_table_offset",
                       np.asarray(step.incomp_block_offsets, np.int64))
        self.add_bytes(f"{name}_index_table",
                       b"".join(step.index_blocks),
                       block_crcs=self._block_crcs(step.index_blocks))
        self.add_array(f"{name}_incompressible_table", step.incomp_values)

    def bump_format(self, version: int):
        """Raise the file format floor (2: per-block codec ids, 3: symbol
        rANS blobs) -- `add_step` does this itself; fragment writers that
        assemble steps from raw variables declare it explicitly."""
        self._format_version = max(self._format_version, version)

    def _chunks(self) -> Iterable[bytes]:
        header = json.dumps({"dimensions": self._dims,
                             "variables": self._vars}).encode()
        version = 4 if self._checksums else self._format_version
        magic = {1: _MAGIC_V1, 2: _MAGIC_V2, 3: _MAGIC_V3,
                 4: _MAGIC_V4}[version]
        prefix = len(magic) + 8 + (4 if version >= 4 else 0)
        pad = b"\0" * _pad(prefix + len(header))
        yield magic
        yield struct.pack("<Q", len(header))
        if version >= 4:
            # Header digest covers header + pad: a flipped bit anywhere in
            # the metadata region is caught before it misdirects a read.
            yield struct.pack("<I", zlib.crc32(header + pad))
        yield header
        yield pad
        for raw in self._sections:
            yield raw
            yield b"\0" * _pad(len(raw))

    def write(self, path: str):
        with telemetry.span("nck.write", path=path,
                            sections=len(self._sections)):
            atomic_commit(path, self._chunks())


# --------------------------------------------------------------------------
# Multi-process tier: per-rank fragment files + rank-0 manifest.
# --------------------------------------------------------------------------

@dataclass
class StepFragment:
    """One process's contiguous slice of a CompressedStep (paper Sec.
    IV-D: every rank writes its own blocks; nothing is gathered).

    ``info`` carries the *global* step attributes every rank knows from
    the replicated analyze outputs (n, shape, B, domain, codec, ...);
    ``block_start`` anchors this fragment's blocks in the global block
    order.  ``centers`` is set on rank 0 only -- it is replicated data,
    so one copy per logical file suffices.
    """

    is_anchor: bool
    block_start: int
    info: dict
    index_blocks: List[bytes] = field(default_factory=list)
    centers: Optional[np.ndarray] = None
    incomp_values: Optional[np.ndarray] = None
    incomp_block_counts: Optional[np.ndarray] = None
    block_codecs: Optional[List[str]] = None
    # Driver telemetry (per-rank phase seconds etc.); never persisted --
    # the rank file stores `info` attrs only, mirroring CompressedStep.
    meta: dict = field(default_factory=dict)

    @property
    def nbytes(self) -> int:
        """Payload size as ``ShardNCKWriter`` lays the fragment out: its
        blobs and their offset table; for a delta step also its exception
        counts and values, and the centers where it holds them."""
        nb = len(self.index_blocks)
        total = sum(len(b) for b in self.index_blocks) + 8 * (nb + 1)
        if self.is_anchor:
            return total
        total += 8 * nb
        if self.incomp_values is not None:
            total += int(self.incomp_values.nbytes)
        if self.centers is not None:
            total += (int(self.centers.size)
                      * step_dtype(self.info["dtype"]).itemsize)
        return total


def read_manifest(path: str) -> Optional[dict]:
    """Parse an NCKM manifest at `path`; None when absent or not a
    manifest (plain NCK data files return None).  Schema-2 manifests are
    crc-verified; any truncation or flip raises IntegrityError -- a
    damaged manifest must never be mistaken for a durable one."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except FileNotFoundError:
        return None
    if raw[:4] != _MANIFEST_MAGIC:
        return None
    if len(raw) < 12:
        raise IntegrityError(
            f"{path}: truncated NCKM manifest ({len(raw)} bytes; even the "
            "magic+length prefix is incomplete)")
    (hlen,) = struct.unpack("<Q", raw[4:12])
    body_end = 12 + hlen
    if len(raw) == body_end + 4:
        (stored,) = struct.unpack("<I", raw[body_end:body_end + 4])
        actual = zlib.crc32(raw[:body_end])
        if stored != actual:
            raise CorruptBlockError(path, "<manifest>", None, stored, actual)
    elif len(raw) != body_end:
        raise IntegrityError(
            f"{path}: manifest is {len(raw)} bytes; header declares "
            f"{body_end} (+4-byte checksum trailer) -- truncated or corrupt")
    try:
        m = json.loads(raw[12:body_end])
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise IntegrityError(
            f"{path}: manifest JSON unparseable ({e}) -- corrupt or "
            "truncated") from e
    if not isinstance(m, dict):
        raise IntegrityError(f"{path}: manifest payload is not an object")
    # A schema>=2 manifest is ALWAYS written with its trailer; seeing one
    # without it means the trailer was truncated away.
    if int(m.get("schema", 1)) >= _MANIFEST_SCHEMA and len(raw) == body_end:
        raise IntegrityError(
            f"{path}: schema {m['schema']} manifest is missing its checksum "
            "trailer (truncated)")
    return m


def rank_file_path(path: str, generation: int, rank: int) -> str:
    """Per-rank NCK shard file name: ``<path>.g<gen>.rank<k>``.  The
    generation suffix keeps a crashed save's partial output disjoint from
    every published generation -- a mixed-generation file set can never
    be referenced by one manifest."""
    return f"{path}.g{generation:04d}.rank{rank}"


def _manifest_bytes(payload: dict) -> bytes:
    """Serialize a manifest payload with its u32 crc32 trailer (schema 2:
    the digest covers magic + length + JSON, so any flip in the committed
    manifest -- even inside the length field -- fails verification)."""
    body = json.dumps(payload).encode()
    head = _MANIFEST_MAGIC + struct.pack("<Q", len(body)) + body
    return head + struct.pack("<I", zlib.crc32(head))


def next_generation(path: str) -> int:
    """Generation for the next multi-process save at `path` (0 when no
    manifest exists yet).  Every rank derives this from the same on-disk
    state before any rank writes, so the fleet agrees without a
    collective."""
    m = read_manifest(path)
    return int(m["generation"]) + 1 if m else 0


def _gc_stale_generations(path: str, keep: Iterable[int]) -> None:
    """Drop rank files of unreferenced generations after a successful
    publish.  ``keep`` is the set of generations the just-committed
    manifest can reach: the current one plus the embedded ``previous``
    (the rollback target must stay loadable)."""
    keep_set = {int(k) for k in keep}
    prefix = path + ".g"
    for f in glob.glob(glob.escape(path) + ".g*.rank*"):
        try:
            gen = int(f[len(prefix):].split(".rank")[0])
        except ValueError:
            continue
        if gen not in keep_set:
            try:
                os.remove(f)
            except OSError:
                pass


def _quarantine(path: str) -> str:
    """Move a corrupt rank file aside as ``<path>.quarantine`` so a
    healthy re-publish of the same name can land while the evidence is
    preserved for postmortem."""
    q = path + ".quarantine"
    i = 0
    while os.path.exists(q):
        i += 1
        q = f"{path}.quarantine{i}"
    # Not a durable publish: the corrupt bytes are LEAVING the committed
    # namespace, and fsyncing known-garbage buys nothing.
    os.replace(path, q)  # repro-lint: disable=format-closure
    return q


def write_manifest(path: str, generation: int, num_ranks: int,
                   steps: List[str], *, timeout: float = 60.0,
                   poll: float = 0.05) -> str:
    """Rank 0's self-healing commit: poll (bounded jittered backoff, hard
    deadline) until every rank file of this generation is published AND
    verifies -- structure, header crc, per-variable digests.  A published
    file that fails verification is quarantined aside and treated as
    not-yet-complete (the writing rank may still re-publish).  Only then
    is the schema-2 manifest (rank sizes + crcs + previous generation)
    atomically committed, and stale generations GC'd -- keeping the
    previous generation as the rollback target.

    On deadline, raises :class:`CommitTimeoutError` BEFORE the manifest
    is touched: its ``report`` names the missing ranks, the quarantined
    files and the generation the logical file remains at.  The previous
    manifest and its rank files stay intact byte for byte.
    """
    files = [rank_file_path(path, generation, r) for r in range(num_ranks)]
    previous = read_manifest(path)  # last durable generation (may be None)
    deadline = time.monotonic() + timeout
    backoff = Backoff(base=poll, factor=1.6, cap=max(poll * 8, 0.25),
                      jitter=0.25).repolling()
    quarantined: List[dict] = []
    crcs: Dict[int, int] = {}

    def scan() -> List[int]:
        missing = []
        for r, f in enumerate(files):
            if r in crcs:
                continue
            if not os.path.exists(f):
                missing.append(r)
                continue
            try:
                verify_nck(f)
                crcs[r] = _file_crc32(f)
            except IntegrityError as e:
                q = _quarantine(f)
                quarantined.append({
                    "rank": r, "file": os.path.basename(f),
                    "quarantined_as": os.path.basename(q),
                    "error": str(e)})
                missing.append(r)  # checksum mismatch == not yet complete
        return missing

    missing = scan()
    for delay in backoff.sleep_until(deadline):
        if not missing:
            break
        time.sleep(delay)
        missing = scan()
    if missing:
        prev_gen = int(previous["generation"]) if previous else None
        report = {
            "path": path, "generation": int(generation),
            "missing_ranks": sorted(missing),
            "quarantined": [q["quarantined_as"] for q in quarantined],
            "quarantine_detail": quarantined,
            "rolled_back_to": prev_gen,
        }
        names = ", ".join(os.path.basename(files[r]) for r in sorted(missing))
        rollback = (f"rolled back to durable generation {prev_gen}"
                    if prev_gen is not None
                    else "no previous durable generation exists")
        raise CommitTimeoutError(
            f"manifest commit for {path}: rank file(s) {names} missing or "
            f"quarantined after {timeout:.0f}s; previous manifest left "
            f"intact ({rollback})", report)
    entries = [{"rank": r, "file": os.path.basename(f),
                "nbytes": os.path.getsize(f), _CRC_KEY: crcs[r]}
               for r, f in enumerate(files)]
    payload = {"schema": _MANIFEST_SCHEMA, "generation": int(generation),
               "num_ranks": int(num_ranks), "ranks": entries,
               "steps": list(steps)}
    keep = {int(generation)}
    if previous is not None:
        # Embed the rollback target (one level deep: its own `previous`
        # is dropped, bounding manifest growth at two generations).
        payload["previous"] = {k: v for k, v in previous.items()
                               if k != "previous"}
        keep.add(int(previous["generation"]))
    with telemetry.span("nck.manifest", path=path, ranks=num_ranks):
        atomic_commit(path, _manifest_bytes(payload))
    _gc_stale_generations(path, keep)
    return path


class ShardNCKWriter:
    """Per-process shard file writer: collects this rank's StepFragments
    and publishes them as one normal NCK file (same magic matrix, same
    atomic_commit discipline).  Rank 0 additionally commits the manifest
    via `commit_manifest` once every rank's file is visible."""

    def __init__(self, path: str, rank: int, num_ranks: int,
                 generation: Optional[int] = None, *,
                 checksums: bool = True):
        self.path = path
        self.rank = rank
        self.num_ranks = num_ranks
        self.generation = (next_generation(path) if generation is None
                           else generation)
        self._w = NCKWriter(checksums=checksums)
        self.steps: List[str] = []

    @property
    def rank_path(self) -> str:
        return rank_file_path(self.path, self.generation, self.rank)

    def add_fragment(self, name: str, frag: StepFragment):
        info = dict(frag.info)
        info["block_start"] = int(frag.block_start)
        info["frag_blocks"] = len(frag.index_blocks)
        info["frag_rank"] = self.rank
        if frag.block_codecs is not None:
            info["block_codecs"] = [str(c) for c in frag.block_codecs]
            self._w.bump_format(2)
        if _blobs_have_symbol_rans(frag.index_blocks,
                                   info.get("codec", "zlib"),
                                   frag.block_codecs):
            self._w.bump_format(3)
        sizes = np.array([len(b) for b in frag.index_blocks], np.int64)
        offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        counts = None
        if not frag.is_anchor:
            counts = (frag.incomp_block_counts
                      if frag.incomp_block_counts is not None
                      else np.zeros(len(frag.index_blocks), np.int64))
            info["frag_n_incompressible"] = int(np.sum(counts))
        self._w.add_array(f"{name}_frag_info", np.zeros(1, np.int32),
                          attrs=info)
        self._w.add_array(f"{name}_frag_index_table_offset", offs)
        self._w.add_bytes(f"{name}_frag_index_table",
                          b"".join(frag.index_blocks),
                          block_crcs=self._w._block_crcs(frag.index_blocks))
        if not frag.is_anchor:
            self._w.add_array(f"{name}_frag_incompressible_counts",
                              np.asarray(counts, np.int64))
            values = (frag.incomp_values if frag.incomp_values is not None
                      else np.zeros(0, info.get("dtype", "float32")))
            self._w.add_array(f"{name}_frag_incompressible_table", values)
            if frag.centers is not None:
                self._w.add_array(f"{name}_bin_centers",
                                  frag.centers.astype(info["dtype"]))
        self.steps.append(name)

    def write(self) -> str:
        """Atomically publish this rank's shard file; returns its path."""
        self._w.write(self.rank_path)
        return self.rank_path

    def commit_manifest(self, *, timeout: float = 60.0) -> str:
        """Rank 0 only: publish the manifest once all rank files exist."""
        if self.rank != 0:
            raise ValueError("only rank 0 commits the manifest")
        return write_manifest(self.path, self.generation, self.num_ranks,
                              self.steps, timeout=timeout)


class NCKReader:
    """Offset-based reader; `read` pulls only the requested byte range.

    Opening an NCKM manifest presents the per-rank shard files as one
    logical file: `step_names`/`read_step`/`attrs`/`read_array` work
    unchanged, with fragments merged back into CompressedSteps identical
    to a single-process write.  A manifest referencing a missing or
    damaged rank file is rejected at open with an error naming the shard
    -- unless the manifest embeds a previous durable generation, in which
    case the reader falls back to it (``recovered_generation`` records
    the fallback, ``fallback_cause`` the error that forced it).

    Integrity: NCK4 headers are crc-verified at open; every version gets
    a structural truncation check (file size vs. variable extents); full
    reads verify the whole-variable digest and block-sliced reads verify
    per-block digests via :meth:`verify_blocks`.  Parse failures surface
    as :class:`IntegrityError`, never a raw json/struct traceback.
    """

    def __init__(self, path: str):
        self.path = path
        self.manifest: Optional[dict] = None
        self._rank_readers: List["NCKReader"] = []
        self.recovered_generation: Optional[int] = None
        self.fallback_cause: Optional[Exception] = None
        with open(path, "rb") as f:
            magic = f.read(4)
            if magic == _MANIFEST_MAGIC:
                self.manifest = read_manifest(path)
                if self.manifest is None:
                    raise IntegrityError(f"{path}: unreadable NCKM manifest")
                try:
                    self._open_ranks(path)
                except (FileNotFoundError, IntegrityError) as e:
                    prev = self.manifest.get("previous")
                    if not prev:
                        raise
                    # Newest generation unverifiable: fall back to the
                    # last durable one (its rank files survive GC).
                    self._rank_readers = []
                    self.manifest = prev
                    self._open_ranks(path)
                    self.recovered_generation = int(prev["generation"])
                    self.fallback_cause = e
                return
            if magic not in _MAGICS:
                raise IntegrityError(
                    f"{path}: not an NCK file (magic {magic!r} unknown; "
                    "corrupt, truncated, or not written by this format)")
            self.format_version = _MAGICS[magic]
            raw8 = f.read(8)
            if len(raw8) != 8:
                raise IntegrityError(f"{path}: truncated NCK length prefix")
            (hlen,) = struct.unpack("<Q", raw8)
            # Bound the declared length BEFORE allocating for it: a
            # flipped high bit in the u64 must raise, not MemoryError.
            if hlen > os.path.getsize(path):
                raise IntegrityError(
                    f"{path}: header length field claims {hlen} bytes in a "
                    f"{os.path.getsize(path)}-byte file (corrupt length "
                    "prefix)")
            prefix = 4 + 8
            stored_crc: Optional[int] = None
            if self.format_version >= 4:
                raw4 = f.read(4)
                if len(raw4) != 4:
                    raise IntegrityError(
                        f"{path}: truncated NCK4 header checksum")
                (stored_crc,) = struct.unpack("<I", raw4)
                prefix += 4
            hdr = f.read(hlen)
            if len(hdr) != hlen:
                raise IntegrityError(
                    f"{path}: truncated NCK header ({len(hdr)} of {hlen} "
                    "bytes)")
            padlen = _pad(prefix + hlen)
            pad = f.read(padlen)
            if stored_crc is not None:
                actual = zlib.crc32(hdr + pad)
                if len(pad) != padlen or actual != stored_crc:
                    raise CorruptBlockError(path, "<header>", None,
                                            stored_crc, actual)
            try:
                header = json.loads(hdr)
            except (json.JSONDecodeError, UnicodeDecodeError) as e:
                raise IntegrityError(
                    f"{path}: NCK header is not valid JSON ({e}) -- file "
                    "corrupt or truncated") from e
        try:
            self.variables = header["variables"]
            self.dimensions = header["dimensions"]
            end = max((int(v["offset"]) + int(v["nbytes"])
                       for v in self.variables.values()), default=0)
        except (KeyError, TypeError, ValueError, AttributeError) as e:
            raise IntegrityError(
                f"{path}: NCK header is structurally malformed ({e!r}) -- "
                "file corrupt") from e
        self._data_start = prefix + hlen + padlen
        size = os.path.getsize(path)
        if size < self._data_start + end:
            raise IntegrityError(
                f"{path}: file is {size} bytes but variables extend to "
                f"byte {self._data_start + end} (truncated)")

    # ------------------------------------------------- manifest handling
    def _open_ranks(self, path: str):
        base = os.path.dirname(os.path.abspath(path))
        for e in self.manifest["ranks"]:
            rp = os.path.join(base, e["file"])
            if not os.path.exists(rp):
                raise FileNotFoundError(
                    f"manifest {path} references missing shard file "
                    f"{e['file']} (rank {e['rank']}); the rank file set "
                    "is incomplete")
            size = os.path.getsize(rp)
            if size != e["nbytes"]:
                raise CorruptShardError(
                    path, e["file"], e["rank"],
                    f"file is {size} bytes, manifest recorded "
                    f"{e['nbytes']} (modified or torn after commit)")
            if _CRC_KEY in e:
                actual = _file_crc32(rp)
                if actual != e[_CRC_KEY]:
                    raise CorruptShardError(
                        path, e["file"], e["rank"],
                        f"whole-file checksum mismatch: expected "
                        f"crc32=0x{e[_CRC_KEY]:08x}, got 0x{actual:08x}")
            try:
                self._rank_readers.append(NCKReader(rp))
            except IntegrityError as err:
                raise CorruptShardError(path, e["file"], e["rank"],
                                        str(err)) from err
        self.format_version = max(r.format_version
                                  for r in self._rank_readers)
        # Union view of the per-rank variable spaces (fragment names are
        # disjoint across ranks except replicated extras like centers,
        # where any copy serves).
        self.variables = {}
        self.dimensions = {}
        self._var_owner: Dict[str, "NCKReader"] = {}
        for r in self._rank_readers:
            for v, rec in r.variables.items():
                if v not in self.variables:
                    self.variables[v] = rec
                    self._var_owner[v] = r
            self.dimensions.update(r.dimensions)

    def attrs(self, name: str) -> dict:
        return self.variables[name]["attributes"]

    def read(self, name: str, byte_start: int = 0,
             byte_stop: Optional[int] = None) -> bytes:
        if self.manifest is not None:
            return self._var_owner[name].read(name, byte_start, byte_stop)
        v = self.variables[name]
        stop = v["nbytes"] if byte_stop is None else min(byte_stop,
                                                         v["nbytes"])
        want = max(stop - byte_start, 0)
        with open(self.path, "rb") as f:
            f.seek(self._data_start + v["offset"] + byte_start)
            data = f.read(want)
        if len(data) != want:
            raise IntegrityError(
                f"{self.path}: variable {name!r} byte range [{byte_start},"
                f"{stop}) short by {want - len(data)} bytes (file "
                "truncated)")
        # Full reads of unblocked variables verify the whole-payload
        # digest here; blocked variables are verified per sliced block at
        # the slicing site (verify_blocks) to avoid digesting twice.
        if (byte_start == 0 and stop == v["nbytes"] and _CRC_KEY in v
                and _BLOCK_CRC_KEY not in v):
            actual = zlib.crc32(data)
            if actual != v[_CRC_KEY]:
                raise CorruptBlockError(self.path, name, None,
                                        v[_CRC_KEY], actual)
        return data

    def read_array(self, name: str) -> np.ndarray:
        v = self.variables[name]
        raw = self.read(name)
        try:
            return np.frombuffer(raw, dtype=step_dtype(v["dtype"]).storage
                                 ).reshape(v["shape"])
        except (ValueError, TypeError) as e:
            raise IntegrityError(
                f"{self.path}: variable {name!r} payload does not match "
                f"its recorded dtype/shape ({e}) -- header or data "
                "corrupt") from e

    def verify_blocks(self, name: str, blocks: Sequence[bytes],
                      first_block: int = 0) -> None:
        """Check sliced block payloads against the per-block checksum
        frame.  No-op for files without one (NCK1/2/3 or checksums=False
        writers); raises :class:`CorruptBlockError` naming the first bad
        block otherwise.  ``first_block`` is the global index of
        ``blocks[0]`` (partial reads verify only the slice they touch)."""
        if self.manifest is not None:
            return self._var_owner[name].verify_blocks(name, blocks,
                                                       first_block)
        crcs = self.variables[name].get(_BLOCK_CRC_KEY)
        if crcs is None:
            return
        for i, b in enumerate(blocks):
            bi = first_block + i
            if bi >= len(crcs):
                raise IntegrityError(
                    f"{self.path}: variable {name!r} records "
                    f"{len(crcs)} checksummed blocks but block {bi} was "
                    "requested (offset table corrupt)")
            actual = zlib.crc32(b)
            if actual != crcs[bi]:
                raise CorruptBlockError(self.path, name, bi, crcs[bi],
                                        actual)

    def _read_step_merged(self, name: str) -> CompressedStep:
        """Merge one step's per-rank fragments (inverse of the
        ShardNCKWriter tier): blocks, exception values and per-block
        counts concatenate in global block order; replicated attrs come
        from the lowest-ranked fragment.  The result is field-identical
        to the same data written by a single process."""
        frags = []
        for r in self._rank_readers:
            if f"{name}_frag_info" in r.variables:
                frags.append((r.attrs(f"{name}_frag_info"), r))
        if not frags:
            raise KeyError(f"step {name} not present in any shard file "
                           f"of manifest {self.path}")
        frags.sort(key=lambda fr: fr[0]["block_start"])
        info = frags[0][0]
        blks: List[bytes] = []
        for fi, r in frags:
            offs = r.read_array(f"{name}_frag_index_table_offset")
            table = r.read(f"{name}_frag_index_table")
            fr_blks = [table[offs[i]:offs[i + 1]]
                       for i in range(len(offs) - 1)]
            r.verify_blocks(f"{name}_frag_index_table", fr_blks)
            blks += fr_blks
        if info["is_anchor"]:
            return CompressedStep(
                n=info["total_data_num"], shape=tuple(info["shape"]),
                dtype=info["dtype"], b_bits=0,
                error_bound=info["error_bound"], strategy=info["strategy"],
                reference=info["reference"], domain_lo=0.0, bin_width=0.0,
                centers=np.zeros(0),
                block_elems=info["elements_per_block"],
                codec=info.get("codec", "zlib"), index_blocks=blks)
        counts = np.concatenate(
            [r.read_array(f"{name}_frag_incompressible_counts")
             for _, r in frags]) if frags else np.zeros(0, np.int64)
        values = np.concatenate(
            [r.read_array(f"{name}_frag_incompressible_table")
             for _, r in frags])
        incomp_off = np.concatenate(
            [[0], np.cumsum(counts)])[:-1].astype(np.int64)
        # Per-block codec ids merge in block order; a uniform result
        # collapses back to the step-level codec (format parity with the
        # single-process writer).
        per: List[str] = []
        for fi, r in frags:
            nb = fi["frag_blocks"]
            per += (list(fi["block_codecs"]) if "block_codecs" in fi
                    else [fi.get("codec", "zlib")] * nb)
        block_codecs: Optional[List[str]] = None
        codec = info.get("codec", "zlib")
        if len(set(per)) > 1:
            from repro_torch.core.pipeline import _primary_codec
            block_codecs, codec = per, _primary_codec(per)
        return CompressedStep(
            n=info["total_data_num"], shape=tuple(info["shape"]),
            dtype=info["dtype"], b_bits=info["B"],
            error_bound=info["error_bound"], strategy=info["strategy"],
            reference=info["reference"], domain_lo=info["domain_lo"],
            bin_width=info["bin_width"],
            centers=self.read_array(f"{name}_bin_centers"
                                    ).astype(np.float64),
            block_elems=info["elements_per_block"], codec=codec,
            block_codecs=block_codecs, index_blocks=blks,
            incomp_values=values, incomp_block_offsets=incomp_off)

    def read_step(self, name: str) -> CompressedStep:
        """Inverse of NCKWriter.add_step."""
        if self.manifest is not None:
            return self._read_step_merged(name)
        if f"{name}_anchor" in self.variables:
            info = self.attrs(f"{name}_anchor_info")
            offs = self.read_array(f"{name}_anchor_offset")
            table = self.read(f"{name}_anchor")
            blks = [table[offs[i]:offs[i + 1]] for i in range(len(offs) - 1)]
            self.verify_blocks(f"{name}_anchor", blks)
            return CompressedStep(
                n=info["total_data_num"], shape=tuple(info["shape"]),
                dtype=info["dtype"], b_bits=0,
                error_bound=info["error_bound"], strategy=info["strategy"],
                reference=info["reference"], domain_lo=0.0, bin_width=0.0,
                centers=np.zeros(0),
                block_elems=info["elements_per_block"],
                codec=info.get("codec", "zlib"), index_blocks=blks)
        info = self.attrs(f"{name}_info")
        offs = self.read_array(f"{name}_index_table_offset")
        table = self.read(f"{name}_index_table")
        blks = [table[offs[i]:offs[i + 1]] for i in range(len(offs) - 1)]
        self.verify_blocks(f"{name}_index_table", blks)
        return CompressedStep(
            n=info["total_data_num"], shape=tuple(info["shape"]),
            dtype=info["dtype"], b_bits=info["B"],
            error_bound=info["error_bound"], strategy=info["strategy"],
            reference=info["reference"], domain_lo=info["domain_lo"],
            bin_width=info["bin_width"],
            centers=self.read_array(f"{name}_bin_centers").astype(np.float64),
            block_elems=info["elements_per_block"],
            codec=info.get("codec", "zlib"),
            block_codecs=info.get("block_codecs"), index_blocks=blks,
            incomp_values=self.read_array(f"{name}_incompressible_table"),
            incomp_block_offsets=self.read_array(
                f"{name}_incompressible_table_offset"))

    def step_names(self) -> List[str]:
        if self.manifest is not None:
            return sorted(set(self.manifest["steps"]))
        names = set()
        for v in self.variables:
            if v.endswith("_anchor_info"):
                names.add(v[: -len("_anchor_info")])
            elif v.endswith("_frag_info"):
                names.add(v[: -len("_frag_info")])
            elif v.endswith("_info"):
                names.add(v[: -len("_info")])
        return sorted(names)


def verify_nck(path: str) -> None:
    """Full structural + checksum verification of one NCK data file:
    header parse, truncation extents, every variable's whole-payload
    digest (NCK4).  Raises :class:`IntegrityError` (or a subclass) on
    any damage; returns None on a clean file.  Used by rank 0's manifest
    commit to decide published-and-complete vs. quarantine."""
    r = NCKReader(path)
    if r.manifest is not None:
        raise IntegrityError(f"{path}: is an NCKM manifest, not a data file")
    for name, v in r.variables.items():
        data = r.read(name)  # verifies unblocked digests itself
        if _CRC_KEY in v and _BLOCK_CRC_KEY in v:
            actual = zlib.crc32(data)
            if actual != v[_CRC_KEY]:
                raise CorruptBlockError(path, name, None, v[_CRC_KEY],
                                        actual)


__all__ = ["NCKWriter", "NCKReader", "StepFragment", "ShardNCKWriter",
           "atomic_commit", "rank_file_path", "next_generation",
           "read_manifest", "write_manifest", "verify_nck"]
