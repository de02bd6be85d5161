"""The port's NCK container and partial reads against the JAX package's.

For the same steps the two writers must give the same file bytes (NCK1 to
NCK4, NCK3 with symbol blobs); each package must read the other's files,
a two-rank NCKM manifest of the JAX fleet writer included; partial reads
must equal the reference's; corruption must raise the integrity errors.
"""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.core import compress as jcompress  # noqa: E402
from repro.core.container import NCKReader as JReader  # noqa: E402
from repro.core.container import ShardNCKWriter, StepFragment  # noqa: E402
from repro.core.partial import TemporalArchive as JArchive  # noqa: E402
from repro.core.types import NumarckParams as JParams  # noqa: E402
from repro.kernels import rans as jrans  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import compress as tcompress  # noqa: E402
from repro_torch.core import container  # noqa: E402
from repro_torch.data.temporal import generate_series  # noqa: E402
from repro_torch.faults import inject  # noqa: E402
from repro_torch.faults.errors import (CorruptBlockError,  # noqa: E402
                                       CorruptShardError, IntegrityError)
from repro_torch.kernels import rans as trans  # noqa: E402

# Series -> (params, magic with checksums=False), blocks of 4 KB so a step
# has several.  "auto" on a step whose blocks differ in compressibility
# stores per-block codec ids (NCK2).
CASES = {"zlib": (dict(block_bytes=1 << 12), b"NCK1"),
         "auto": (dict(codec="auto", block_bytes=1 << 12), b"NCK2"),
         "rans": (dict(codec="rans", block_bytes=1 << 12), b"NCK1"),
         "rans_symbols": (dict(codec="rans", symbol_rans=True,
                               block_bytes=1 << 12), b"NCK3")}
WINDOWS = ((0, 1), (1000, 1200), (4095, 4097), (8191, 20_000))


def _series():
    """Stir at scale 4 (24,336 f32 elements), its last step with a
    near-random half so that "auto" picks raw for some blocks."""
    arrays = list(generate_series("stir", 4, seed=0, scale=4))
    rng = np.random.default_rng(4)
    last = arrays[-1].reshape(-1).copy()
    half = last.size // 2
    last[half:] *= (1 + 0.3 * rng.standard_normal(last.size - half)
                    ).astype(np.float32)
    arrays[-1] = last.reshape(arrays[-1].shape)
    return arrays


@pytest.fixture(scope="module")
def series():
    return _series()


@pytest.fixture(scope="module", params=sorted(CASES))
def steps(request, series):
    """(case, JAX steps, port steps) with the device stages on at every
    size (the port on the CPU: the kernels' plain versions)."""
    kw, _ = CASES[request.param]
    saved = jrans.DEVICE_MIN_BYTES, trans.DEVICE_MIN_BYTES
    jrans.DEVICE_MIN_BYTES = trans.DEVICE_MIN_BYTES = 0
    try:
        want = jcompress.compress_series(series, JParams(**kw))
        got = repro_torch.compress_series(
            series, repro_torch.NumarckParams(**kw), device="cpu")
    finally:
        jrans.DEVICE_MIN_BYTES, trans.DEVICE_MIN_BYTES = saved
    return request.param, want, got


def _fields_equal(a, b):
    fa, fb = interop.step_to_fields(a), interop.step_to_fields(b)
    for k in fa:
        if k in ("meta", "index_block_nbytes"):
            continue                   # never persisted
        if isinstance(fb[k], np.ndarray):
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
            assert fa[k].dtype == fb[k].dtype, k
        else:
            assert fa[k] == fb[k], k


@pytest.mark.parametrize("checksums", [True, False])
def test_writer_bytes_match_reference(steps, checksums, tmp_path):
    case, want, got = steps
    if case == "auto":
        assert got[-1].block_codecs is not None
    jp, tp = str(tmp_path / "jax.nck"), str(tmp_path / "port.nck")
    JArchive.write(jp, "v", want, checksums=checksums)
    repro_torch.TemporalArchive.write(tp, "v", got, checksums=checksums)
    raw = open(tp, "rb").read()
    assert raw == open(jp, "rb").read()
    assert raw[:4] == (b"NCK4" if checksums else CASES[case][1])


def test_files_load_both_ways(steps, tmp_path):
    case, want, got = steps
    jp, tp = str(tmp_path / "jax.nck"), str(tmp_path / "port.nck")
    JArchive.write(jp, "v", want)
    repro_torch.TemporalArchive.write(tp, "v", got)
    tr, jr = repro_torch.NCKReader(jp), JReader(tp)
    assert tr.step_names() == jr.step_names()
    for i, (w, g) in enumerate(zip(want, got)):
        name = repro_torch.TemporalArchive.step_name("v", i)
        _fields_equal(tr.read_step(name), w)
        _fields_equal(jr.read_step(name), g)
    recon = repro_torch.decompress_series(
        [tr.read_step(n) for n in tr.step_names()], device="cpu")
    for a, b in zip(recon, jcompress.decompress_series(want)):
        np.testing.assert_array_equal(a, b)
    repro_torch.verify_nck(jp)


def test_writer_stamps_checksum_frame(steps, tmp_path):
    """The NCK4 frame's record keys in the port's file, as both readers
    see them: "crc32" on every variable, "block_crc32" on the blocked
    ones (the anchor and the index tables), equal to the reference's."""
    case, want, got = steps
    jp, tp = str(tmp_path / "jax.nck"), str(tmp_path / "port.nck")
    JArchive.write(jp, "v", want)
    repro_torch.TemporalArchive.write(tp, "v", got)
    tr, jr = repro_torch.NCKReader(tp), JReader(jp)
    assert tr.variables == jr.variables
    assert all("crc32" in rec for rec in tr.variables.values())
    blocked = [n for n, rec in tr.variables.items() if "block_crc32" in rec]
    assert any(n.endswith("_anchor") for n in blocked), blocked
    assert any(n.endswith("_index_table") for n in blocked), blocked


def test_read_range_matches_reference(steps, tmp_path):
    case, want, _ = steps
    path = str(tmp_path / "a.nck")
    JArchive.write(path, "v", want)
    mine, ref = repro_torch.TemporalArchive(path), JArchive(path)
    full = jcompress.decompress_series(want)
    assert mine.n_iterations("v") == len(want)
    for it, st in enumerate(want):
        be = st.block_elems            # windows across a block edge too
        for lo, hi in WINDOWS + ((be - 5, be + 7), (0, st.n)):
            got = mine.read_range("v", it, lo, hi)
            np.testing.assert_array_equal(got, ref.read_range("v", it, lo,
                                                              hi))
            np.testing.assert_array_equal(got, full[it].reshape(-1)[lo:hi])
        np.testing.assert_array_equal(mine.read_full("v", it), full[it])


def _fragments(step, num_ranks, rank):
    """Rank `rank`'s share of a finished step, split by block index as
    the JAX fleet writer splits it."""
    nb = step.n_blocks
    lo, hi = rank * nb // num_ranks, (rank + 1) * nb // num_ranks
    info = dict(total_data_num=step.n, shape=list(step.shape),
                dtype=step.dtype, bin_centers_number=int(step.centers.size),
                elements_per_block=step.block_elems, B=step.b_bits,
                error_bound=step.error_bound, strategy=step.strategy,
                reference=step.reference, domain_lo=step.domain_lo,
                bin_width=step.bin_width, is_anchor=step.is_anchor,
                n_blocks=nb, codec=step.codec)
    frag = StepFragment(is_anchor=step.is_anchor, block_start=lo, info=info,
                        index_blocks=list(step.index_blocks[lo:hi]))
    if not step.is_anchor:
        offs = np.append(step.incomp_block_offsets, step.n_incompressible)
        frag.incomp_block_counts = np.diff(offs)[lo:hi]
        frag.incomp_values = step.incomp_values[offs[lo]:offs[hi]]
        frag.centers = step.centers if rank == 0 else None
    return frag


def test_jax_manifest_loads_in_the_port(series, tmp_path):
    want = jcompress.compress_series(
        series, JParams(block_bytes=1 << 12))
    path = str(tmp_path / "m.nck")
    writers = [ShardNCKWriter(path, r, 2) for r in range(2)]
    for r, w in enumerate(writers):
        for i, s in enumerate(want):
            w.add_fragment(f"v_it{i:05d}", _fragments(s, 2, r))
        w.write()
    writers[0].commit_manifest(timeout=10.0)
    tr, jr = repro_torch.NCKReader(path), JReader(path)
    assert tr.manifest is not None and tr.step_names() == jr.step_names()
    assert tr.format_version == jr.format_version
    for name in tr.step_names():
        _fields_equal(tr.read_step(name), jr.read_step(name))
    recon = repro_torch.decompress_series(
        [tr.read_step(n) for n in tr.step_names()], device="cpu")
    for a, b in zip(recon, jcompress.decompress_series(want)):
        np.testing.assert_array_equal(a, b)
    # A rank file damaged after the commit is named at open.
    shard = path + ".g0000.rank1"
    raw = bytearray(open(shard, "rb").read())
    raw[-100] ^= 1
    open(shard, "wb").write(bytes(raw))
    with pytest.raises(CorruptShardError, match="rank 1"):
        repro_torch.NCKReader(path)


def _layout(path):
    r = repro_torch.NCKReader(path)
    return r._data_start, r.variables


def _flip(path, offset):
    raw = bytearray(open(path, "rb").read())
    raw[offset] ^= 0x10
    open(path, "wb").write(bytes(raw))


@pytest.mark.parametrize("where", ["header", "block", "exceptions",
                                   "truncated"])
def test_corruption_raises_like_reference(series, tmp_path, where):
    steps = repro_torch.compress_series(
        series, repro_torch.NumarckParams(block_bytes=1 << 12), device="cpu")
    path = str(tmp_path / "c.nck")
    repro_torch.TemporalArchive.write(path, "v", steps)
    start, variables = _layout(path)
    name = "v_it00002"
    if where == "header":
        _flip(path, 30)
    elif where == "truncated":
        last = max(variables.values(), key=lambda v: v["offset"])
        os.truncate(path, start + last["offset"] + last["nbytes"] // 2)
    else:
        var = variables[f"{name}_index_table" if where == "block"
                        else f"{name}_incompressible_table"]
        _flip(path, start + var["offset"] + var["nbytes"] // 2)
    errs = []
    for reader in (repro_torch.NCKReader, JReader):
        with pytest.raises(ValueError) as e:
            reader(path).read_step(name)
        errs.append(e.value)
    assert isinstance(errs[0], IntegrityError)
    assert type(errs[0]).__name__ == type(errs[1]).__name__
    assert str(errs[0]) == str(errs[1])
    if where in ("header", "block", "exceptions"):
        assert isinstance(errs[0], CorruptBlockError)
    if where == "block":
        with pytest.raises(CorruptBlockError, match="block"):
            repro_torch.TemporalArchive(path).read_full("v", 2)
        with pytest.raises(CorruptBlockError):
            repro_torch.verify_nck(path)


@pytest.mark.parametrize("site", ["fsync_fail", "rename_fail"])
def test_atomic_commit_fault_sites_leave_the_target(tmp_path, site):
    path = str(tmp_path / "f.nck")
    container.atomic_commit(path, b"old")
    inject.configure(site)
    try:
        with pytest.raises(OSError, match=site):
            container.atomic_commit(path, [b"new", b"er"])
    finally:
        inject.reset()
    assert open(path, "rb").read() == b"old"
    container.atomic_commit(path, [b"new", b"er"])
    assert open(path, "rb").read() == b"newer"


def test_quickstart_flow_on_the_port(tmp_path):
    """examples/quickstart.py's flow, on the port's CPU path."""
    series = list(generate_series("stir", 6, seed=0, scale=4))
    params = repro_torch.NumarckParams(error_bound=1e-3)
    steps = repro_torch.compress_series(series, params, device="cpu")
    recon = repro_torch.decompress_series(steps, device="cpu")
    for orig, rec in zip(series, recon):
        assert repro_torch.mean_error_rate(orig, rec) <= 1e-3 * 1.01
    path = str(tmp_path / "quickstart.nck")
    repro_torch.TemporalArchive.write(path, "dens", steps)
    window = repro_torch.TemporalArchive(path).read_range("dens", 5, 1000,
                                                          1200)
    np.testing.assert_array_equal(window, recon[5].reshape(-1)[1000:1200])
    # The file moves: a copy reads the same.
    shutil.copy(path, str(tmp_path / "moved.nck"))
    moved = repro_torch.NCKReader(str(tmp_path / "moved.nck"))
    rebuilt = tcompress.decompress_series(
        [moved.read_step(n) for n in moved.step_names()], device="cpu")
    for a, b in zip(rebuilt, recon):
        np.testing.assert_array_equal(a, b)
