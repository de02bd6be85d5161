"""Core datatypes for the NUMARCK compression pipeline (copy of the
reference's ``core/types.py``; the port keeps its field set so
``NumarckParams.to_json`` and ``CompressedStep`` match byte for byte).

Terminology follows the paper:
  E        -- user-defined tolerable (relative) error bound
  B        -- number of bits used to index a data point
  k        -- number of bins = 2**B - 1 (index 2**B - 1 marks incompressible)
  n        -- number of data points in the variable
  alpha    -- incompressible-data ratio (Eq. 5)
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

# Strategy names (paper Sec. III-B / IV-B).
STRATEGY_TOPK = "topk"
STRATEGY_EQUAL = "equal"
STRATEGY_LOG = "log"
STRATEGY_KMEANS = "kmeans"
STRATEGIES = (STRATEGY_TOPK, STRATEGY_EQUAL, STRATEGY_LOG, STRATEGY_KMEANS)

# Reference modes (DESIGN.md Sec. 3): the paper compresses step i against the
# *original* previous step but reconstructs against the *reconstructed* one,
# so errors compound; "reconstructed" closes the loop and keeps the per-step
# bound exact.
REF_ORIGINAL = "original"
REF_RECONSTRUCTED = "reconstructed"


@dataclass(frozen=True)
class NumarckParams:
    """User-controllable parameters (paper Sec. IV contributions #4)."""

    error_bound: float = 1e-3          # E
    b_bits: Optional[int] = None       # None => auto-select via Eq. (6)
    b_max: int = 16                    # search range for auto-B
    max_bins: int = 1 << 16            # histogram candidate-bin cap (DESIGN 3)
    strategy: str = STRATEGY_TOPK
    block_bytes: int = 1 << 20         # index-table block size (paper: 1 MB)
    codec: str = "zlib"                # entropy codec (registry id or "auto")
    zlib_level: int = 6                # codec level (name kept for compat)
    parallel_entropy: bool = True      # thread-pool host finalize
    # Route the entropy stage through the codec's device encoder when it
    # has one (Codec.device, e.g. "rans"): blocks are entropy-coded on
    # the accelerator and finalize consumes pre-compressed blobs.  Blobs
    # are byte-identical to the host flavor either way.
    device_entropy: bool = True
    # Symbol-level rANS (top-k only): entropy-code the pre-pack B-bit
    # indices over the dense {rank, marker} alphabet using the analyze
    # stage's exact global histogram -- no strided sample pass, no
    # bit-pack/unpack stage on either side.  Steps carrying such blocks
    # are stamped NCK3 by the container (old readers reject them
    # cleanly; NCK1/NCK2 files still load either way).
    symbol_rans: bool = False
    reference: str = REF_RECONSTRUCTED
    kmeans_iters: int = 20
    kmeans_max_k: int = 4096           # tractability cap for k-means binning
    # SS Perf (EXPERIMENTS.md): skip the min/max range pass and use the
    # 0-centred capped domain directly.  Saves one full read of prev/curr
    # (the paper's phase-1 Allreduce disappears); ratios outside
    # +-max_bins*E become exceptions, which for temporal data is the far
    # tail anyway.  Off by default (paper-faithful domain selection).
    fixed_domain: bool = False

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if self.reference not in (REF_ORIGINAL, REF_RECONSTRUCTED):
            raise ValueError(f"unknown reference mode {self.reference!r}")
        if not (0 < self.error_bound < 1):
            raise ValueError("error_bound must be in (0, 1)")
        if self.b_bits is not None and not (1 <= self.b_bits <= 24):
            raise ValueError("b_bits must be in [1, 24]")
        if self.max_bins < 2:
            raise ValueError("max_bins must be >= 2")
        from repro_torch.core import entropy  # stdlib-only; no cycle
        entropy.validate_codec_id(self.codec)  # registry name or "auto"

    def block_elems(self, b_bits: int) -> int:
        """Indices per index-table block (paper: block_bits / B).

        Rounded down to a multiple of 32 -- the bit-pack kernel packs
        32-index word groups, so every block spans whole 32-bit words.
        """
        return max(32, ((self.block_bytes * 8) // b_bits) // 32 * 32)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(s: str) -> "NumarckParams":
        return NumarckParams(**json.loads(s))


@dataclass
class CompressedStep:
    """One compressed iteration of one variable.

    Mirrors the netCDF layout of paper Fig. 2: bin centers, blocked+deflated
    index table with a byte-offset table, incompressible value table with a
    per-block count-offset table, and an info/attribute record.
    """

    n: int                              # total_data_num
    shape: tuple                        # original array shape
    dtype: str                          # original dtype string
    b_bits: int                         # index length B
    error_bound: float
    strategy: str
    reference: str
    domain_lo: float                    # histogram domain start (top-k)
    bin_width: float                    # 2E for top-k
    centers: np.ndarray                 # float64 (k,) bin centers
    block_elems: int                    # elements_per_block
    codec: str = "zlib"                 # entropy codec id (registry name)
    # Per-block codec ids (mixed hot/cold ranges); None => every block
    # uses `codec`.  Persisted by the NCK container (format version 2).
    block_codecs: Optional[list] = None
    index_blocks: list = field(default_factory=list)   # entropy-coded bytes
    index_block_nbytes: Optional[np.ndarray] = None    # raw (pre-zlib) sizes
    incomp_values: Optional[np.ndarray] = None         # original dtype
    incomp_block_offsets: Optional[np.ndarray] = None  # int64 (nblocks,)
    meta: dict = field(default_factory=dict)

    def codec_for_block(self, bi: int) -> str:
        """Entropy codec of block `bi` (the per-block id when present)."""
        return self.block_codecs[bi] if self.block_codecs else self.codec

    @property
    def is_anchor(self) -> bool:
        """Anchors (losslessly stored steps) are marked by b_bits == 0; their
        raw value blocks live in index_blocks (deflated, block_elems each)."""
        return self.b_bits == 0

    @property
    def n_blocks(self) -> int:
        return len(self.index_blocks)

    @property
    def n_incompressible(self) -> int:
        return 0 if self.incomp_values is None else int(self.incomp_values.size)

    @property
    def alpha(self) -> float:
        """Incompressible data ratio (Eq. 5)."""
        return self.n_incompressible / max(self.n, 1)

    def index_table_offsets(self) -> np.ndarray:
        """Start byte offset of each deflated block (paper's offset table)."""
        sizes = np.array([len(b) for b in self.index_blocks], dtype=np.int64)
        return np.concatenate([[0], np.cumsum(sizes)])[:-1]

    @property
    def nbytes(self) -> int:
        """Compressed payload size as laid out in the NCK container."""
        if self.is_anchor:
            return (sum(len(b) for b in self.index_blocks)
                    + 8 * (self.n_blocks + 1))
        total = int(self.centers.size) * step_dtype(self.dtype).itemsize
        total += sum(len(b) for b in self.index_blocks)
        total += 8 * (self.n_blocks + 1) * 2          # two offset tables
        if self.incomp_values is not None:
            total += int(self.incomp_values.nbytes)
        return total

    def compression_ratio(self) -> float:
        """CR = original size / compressed size (Eq. 2)."""
        orig = self.n * step_dtype(self.dtype).itemsize
        return orig / max(self.nbytes, 1)


def mean_error_rate(original: np.ndarray, recon: np.ndarray) -> float:
    """ME (Eq. 3): mean |D - R| / |D| over elements with D != 0."""
    original = np.asarray(original, dtype=np.float64).ravel()
    recon = np.asarray(recon, dtype=np.float64).ravel()
    nz = original != 0
    if not nz.any():
        return 0.0
    return float(np.mean(np.abs((original[nz] - recon[nz]) / original[nz])))


def dtype_nbytes(dtype) -> int:
    return step_dtype(dtype).itemsize


def required_b_for_k(k: int) -> int:
    """Smallest B such that 2**B - 1 >= k."""
    b = 1
    while (1 << b) - 1 < k:
        b += 1
    return b


@dataclass(frozen=True)
class StepDtype:
    """A step's recorded dtype: the name the reference writes
    (``str(arr.dtype)``), its itemsize, its torch dtype, and the numpy
    dtype that holds its bytes on the host."""

    name: str
    itemsize: int
    torch: torch.dtype
    storage: np.dtype


# numpy has no bfloat16 without ml_dtypes (which the reference's jax
# registers): the port holds its bytes as uint16.
_BF16 = StepDtype("bfloat16", 2, torch.bfloat16, np.dtype(np.uint16))


def step_dtype(dtype) -> StepDtype:
    """The ``StepDtype`` of a recorded dtype name, a numpy dtype (an
    ml_dtypes bfloat16 included) or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).removeprefix("torch.")
    elif isinstance(dtype, str):
        name = dtype
    else:
        name = str(np.dtype(dtype))
    if name == _BF16.name:
        return _BF16
    storage = np.dtype(name)
    return StepDtype(storage.name, storage.itemsize,
                     torch.from_numpy(np.zeros(0, storage)).dtype, storage)


def host_storage(x) -> tuple:
    """(host ndarray of ``x``'s bytes in its storage dtype, recorded dtype
    name) for a tensor or an ndarray; bfloat16 comes out as uint16.  A
    CPU tensor's array shares its memory."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), _BF16.name
        x = x.numpy()
    arr = np.asarray(x)
    if arr.dtype.name == _BF16.name:          # an ml_dtypes array
        return arr.view(np.uint16), _BF16.name
    return arr, str(arr.dtype)


def storage_tensor(arr: np.ndarray, dtype) -> torch.Tensor:
    """A CPU tensor of the recorded ``dtype`` over the storage bytes
    ``arr`` (no copy): the inverse of ``host_storage``."""
    sd = step_dtype(dtype)
    if sd.torch == torch.bfloat16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr.view(sd.storage))


__all__ = [
    "NumarckParams",
    "CompressedStep",
    "mean_error_rate",
    "dtype_nbytes",
    "required_b_for_k",
    "StepDtype",
    "step_dtype",
    "host_storage",
    "storage_tensor",
    "STRATEGIES",
    "STRATEGY_TOPK",
    "STRATEGY_EQUAL",
    "STRATEGY_LOG",
    "STRATEGY_KMEANS",
    "REF_ORIGINAL",
    "REF_RECONSTRUCTED",
]
