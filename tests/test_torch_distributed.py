"""The port's sharded and multi-process drivers against the single-device
driver and the JAX package's sharded driver, byte for byte.

``repro_torch.distributed.pipeline.ShardedCompressor`` over 1-4 CPU shards
(the kernels' plain versions), ``ShardedDecompressor``, the collectives
in their one-process form, and a two-rank ``MultiProcessCompressor``
spawned over gloo with ``repro_torch.launch.distributed.spawn_emulated``,
whose NCKM file must load in both packages' readers.  The manifest's
generation, GC, quarantine and rollback tests mirror
tests/test_multiprocess.py.
"""
import json
import os
import struct
import subprocess
import sys
import textwrap
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.core import compress as jcompress  # noqa: E402
from repro.core.container import NCKReader as JReader  # noqa: E402
from repro.core.container import NCKWriter as JWriter  # noqa: E402
from repro.core.types import NumarckParams as JParams  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import container  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core.container import (NCKReader, NCKWriter,  # noqa: E402
                                        ShardNCKWriter, StepFragment,
                                        rank_file_path, read_manifest)
from repro_torch.distributed import collectives as coll  # noqa: E402
from repro_torch.distributed.pipeline import (  # noqa: E402
    MultiProcessCompressor, ShardedCompressor, ShardedDecompressor)
from repro_torch.faults.errors import CommitTimeoutError  # noqa: E402
from repro_torch.launch import distributed as ld  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
N_ODD = 20_011            # odd n: the last shard is padded


def _series(n=N_ODD, steps=4, seed=7, dtype=np.float32):
    """A temporal series with exceptions mid-series (every 401st element
    jumps by 40x in one step) and a zero that makes ratios invalid."""
    rng = np.random.default_rng(seed)
    base = rng.normal(1.0, 0.5, n).astype(dtype)
    base[n // 3] = 0.0
    out = [base]
    for t in range(steps - 1):
        nxt = (out[-1] * (1 + 0.01 * rng.standard_normal(n))).astype(dtype)
        nxt[t::401] *= 40.0
        out.append(nxt)
    return out


def _fields(step, skip=("meta",)):
    f = interop.step_to_fields(step)
    return {k: v for k, v in f.items() if k not in skip}


def _assert_same(got, want, skip=("meta",)):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        fg, fw = _fields(g, skip), _fields(w, skip)
        for k, vw in fw.items():
            if isinstance(vw, np.ndarray):
                np.testing.assert_array_equal(fg[k], vw,
                                              err_msg=f"step {i} {k}")
            else:
                assert fg[k] == vw, (i, k)


def _cpu(p):
    return ["cpu"] * p


# ---------------------------------------------------------- collectives

def test_collectives_over_local_shards():
    g = coll.ShardGroup(_cpu(3), False)
    assert coll.axis_size(g) == g.size == 3 and g.first == 0
    lo, hi = coll.allreduce_minmax([0.5, -np.inf, 2.0], [1.0, 7.5, -3.0], g)
    assert (lo, hi) == (np.float32(-np.inf), np.float32(7.5))
    total = coll.allreduce_sum([torch.arange(4, dtype=torch.int32)] * 3, g)
    assert total.tolist() == [0, 3, 6, 9] and total.dtype == torch.int32
    with pytest.raises(TypeError, match="integer"):
        coll.allreduce_sum([torch.ones(2)] * 3, g)
    assert coll.exclusive_scan_sum([4, 0, 5], g) == [0, 4, 4]
    heads = [torch.full((2,), j, dtype=torch.int32) for j in range(3)]
    fill = torch.full((2,), -1, dtype=torch.int32)
    got = coll.right_edge_exchange(heads, g, fill)
    assert [t.tolist() for t in got] == [[1, 1], [2, 2], [-1, -1]]


# ------------------------------------------------- sharded == single-device

@pytest.mark.parametrize("chain", ["auto", "host"])
@pytest.mark.parametrize("shards", [2, 3, 4])
def test_sharded_matches_single_device(shards, chain):
    """Odd n, blocks straddling every shard edge (1,024-byte blocks, which
    fit in a shard), exceptions mid-series, overlap off and on: steps equal
    the port's and the JAX package's single-device steps, and the sharded
    meta names its pipeline."""
    arrays = _series()
    kw = dict(block_bytes=1024)
    single = repro_torch.compress_series(arrays, repro_torch.NumarckParams(
        **kw), device="cpu")
    _assert_same(single, jcompress.compress_series(arrays, JParams(**kw)),
                 skip=())
    for overlap in (False, True):
        sc = ShardedCompressor(_cpu(shards), repro_torch.NumarckParams(**kw),
                               overlap=overlap, chain=chain)
        try:
            got = sc.compress_series(arrays)
            state = sc.reference_state()
        finally:
            sc.close()
        _assert_same(got, single)
        ln = -(-N_ODD // shards)
        assert any(ln % s.block_elems for s in got[1:])   # straddling
        assert all(s.n_incompressible for s in got[1:])
        assert got[1].meta["n_shards"] == shards
        assert got[1].meta["pipeline"] == "sharded"
        np.testing.assert_array_equal(
            state, repro_torch.decompress_series(got, device="cpu")[-1])


@pytest.mark.parametrize("fixed_domain", [False, True])
def test_one_shard_matches_jax_sharded(fixed_domain):
    """P = 1 against the JAX ShardedCompressor on a one-device mesh
    (use_pallas=False), every field including meta; fixed_domain is read
    by both sharded drivers and ignored by the port's single-device one,
    as by the reference's."""
    import jax
    from jax.sharding import Mesh
    from repro.distributed.pipeline import ShardedCompressor as JSharded

    arrays = _series(n=9_001, steps=3)
    kw = dict(fixed_domain=fixed_domain, block_bytes=4096)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    js = JSharded(mesh, "data", JParams(**kw), use_pallas=False)
    want = js.compress_series(arrays)
    js.close()
    sc = ShardedCompressor(_cpu(1), repro_torch.NumarckParams(**kw))
    got = sc.compress_series(arrays)
    sc.close()
    _assert_same(got, want, skip=())
    single = repro_torch.compress_series(
        arrays, repro_torch.NumarckParams(**kw), device="cpu")
    _assert_same(single, repro_torch.compress_series(
        arrays, repro_torch.NumarckParams(block_bytes=4096), device="cpu"),
        skip=())
    if fixed_domain:
        coverage = np.float32(2e-3) * np.float32(1 << 16)
        assert got[1].domain_lo == np.float32(-0.5) * coverage
        assert got[1].domain_lo != single[1].domain_lo


@pytest.mark.parametrize("chain", ["auto", "host"])
@pytest.mark.parametrize("shards", [1, 3])
def test_sharded_original_reference_matches_jax(shards, chain):
    """reference="original" through the sharded driver (its chain.replace
    branch): steps equal the port's single-device ones, which equal the
    JAX package's; at P = 1 every field, meta included, equals the JAX
    ShardedCompressor's on a one-device mesh."""
    import jax
    from jax.sharding import Mesh
    from repro.distributed.pipeline import ShardedCompressor as JSharded

    arrays = _series()
    kw = dict(reference="original", block_bytes=1024)
    single = repro_torch.compress_series(arrays, repro_torch.NumarckParams(
        **kw), device="cpu")
    _assert_same(single, jcompress.compress_series(arrays, JParams(**kw)),
                 skip=())
    sc = ShardedCompressor(_cpu(shards), repro_torch.NumarckParams(**kw),
                           chain=chain)
    try:
        got = sc.compress_series(arrays)
        state = sc.reference_state()
    finally:
        sc.close()
    _assert_same(got, single)
    np.testing.assert_array_equal(state, arrays[-1])
    if shards == 1:
        js = JSharded(Mesh(np.array(jax.devices()[:1]), ("data",)), "data",
                      JParams(**kw), use_pallas=False)
        want = js.compress_series(arrays)
        js.close()
        _assert_same(got, want, skip=())


_SHRINK = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import numpy as np, jax
    from jax.sharding import Mesh
    from repro.core.types import NumarckParams as JParams
    from repro.distributed.pipeline import ShardedCompressor as JSharded
    from repro_torch import interop
    from repro_torch.core.types import NumarckParams
    from repro_torch.distributed.pipeline import ShardedCompressor
    rng = np.random.default_rng(3)
    n = 30_007
    arrays = [rng.normal(1.0, 0.5, n).astype(np.float32)]
    for t in range(2):
        arrays.append((arrays[-1] * (1 + 0.01 * rng.standard_normal(n))
                       ).astype(np.float32))
    for kw in ({}, {"codec": "rans"}):
        js = JSharded(Mesh(np.array(jax.devices()), ("data",)), "data",
                      JParams(**kw), use_pallas=False)
        want = js.compress_series(arrays)
        js.close()
        sc = ShardedCompressor(["cpu", "cpu"], NumarckParams(**kw))
        got = sc.compress_series(arrays)
        sc.close()
        ln = -(-n // 2)
        assert got[1].block_elems == ln // 32 * 32 < \\
            NumarckParams().block_elems(got[1].b_bits)
        for g, w in zip(got, want):
            fg, fw = interop.step_to_fields(g), interop.step_to_fields(w)
            for k, v in fw.items():
                ok = (np.array_equal(fg[k], v) if isinstance(v, np.ndarray)
                      else fg[k] == v)
                assert ok, k
    print("SHRINK_OK")
""")


def test_shrunk_blocks_match_jax_sharded():
    """Where block_elems(B) exceeds a shard, blocks shrink to ln // 32 * 32
    and the single-device bytes legitimately differ: the port is held to
    the JAX sharded driver over two host devices (zlib and rans)."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _SHRINK], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "SHRINK_OK" in out.stdout, out.stderr


# ----------------------------------------------------------- decompressor

@pytest.mark.parametrize("codec", ["zlib", "rans", "rans_v2"])
def test_sharded_decompressor_round_trip(codec, monkeypatch):
    """ShardedDecompressor over 3 shards reads the steps back bit-identical
    to the single-device decompressor (host route for zlib, the device
    decode route for rans: v1 blobs from the sharded driver, v2 blobs
    from the single-device symbol coder) and within E."""
    from repro_torch.kernels import rans

    monkeypatch.setattr(rans, "DEVICE_MIN_BYTES", 0)
    arrays = _series(steps=3)
    params = repro_torch.NumarckParams(
        codec="zlib" if codec == "zlib" else "rans", block_bytes=4096,
        symbol_rans=codec == "rans_v2")
    if params.symbol_rans:
        steps = repro_torch.compress_series(arrays, params, device="cpu")
        assert rans.blob_version(steps[1].index_blocks[0]) == 2
    else:
        sc = ShardedCompressor(_cpu(3), params)
        steps = sc.compress_series(arrays)
        sc.close()
    got = ShardedDecompressor(_cpu(3)).decompress_series(steps)
    want = repro_torch.decompress_series(steps, device="cpu")
    for a, b, x in zip(got, want, arrays):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        assert repro_torch.mean_error_rate(x, a) <= 1e-3 * 1.01


def test_sharded_drivers_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedCompressor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedDecompressor(["cuda", "cuda"])
    with pytest.raises(ValueError, match="symbol_rans"):
        MultiProcessCompressor(_cpu(1), repro_torch.NumarckParams(
            symbol_rans=True))
    with pytest.raises(ValueError, match="device-resident"):
        MultiProcessCompressor(_cpu(1), chain="host")


# ------------------------------------------------------------ the launch

def test_launch_environment():
    env = ld.rank_env(1, 4, "127.0.0.1:1234", base={}, preset=False)
    assert env == {ld.ENV_COORDINATOR: "127.0.0.1:1234",
                   ld.ENV_NUM_PROCESSES: "4", ld.ENV_PROCESS_ID: "1"}
    preset = ld.rank_env(1, 4, "127.0.0.1:1234", base={})
    assert preset.items() >= env.items()
    assert preset["TORCH_CPP_LOG_LEVEL"] == "ERROR"
    cfg = ld.env_config(env)
    assert (cfg.coordinator, cfg.num_processes, cfg.process_id) == (
        "127.0.0.1:1234", 4, 1)
    assert ld.env_config({}) is None
    assert ld.initialize(ld.DistributedConfig()).num_processes == 1
    assert (ld.process_rank(), ld.process_count()) == (0, 1)
    code = ("import os,sys;"
            "print('rank', os.environ['REPRO_PROCESS_ID']);"
            "sys.exit(int(os.environ['REPRO_PROCESS_ID']))")
    res = ld.spawn_emulated(2, ["-c", code], timeout=60)
    assert [r.returncode for r in res] == [0, 1]
    assert "rank 1" in res[1].stdout
    with pytest.raises(RuntimeError, match="rank 1 exited 1"):
        ld.check_spawned(res)


# ------------------------------------------------- manifest + shard writers

def _anchor_fragments(arr: np.ndarray, num_ranks: int):
    """A hand-made lossless anchor split across ranks, with the block
    ownership of MultiProcessCompressor._anchor_fragment."""
    flat = arr.reshape(-1)
    slices = tpipe.block_slices(flat.size, 8)
    nb = len(slices)
    info = dict(total_data_num=arr.size, shape=list(arr.shape),
                dtype=str(arr.dtype), bin_centers_number=0,
                elements_per_block=8, B=0, error_bound=1e-3,
                strategy="topk", reference="reconstructed", domain_lo=0.0,
                bin_width=0.0, is_anchor=True, n_blocks=nb, codec="zlib")
    frags = []
    for rank in range(num_ranks):
        lo, hi = rank * nb // num_ranks, (rank + 1) * nb // num_ranks
        frags.append(StepFragment(
            is_anchor=True, block_start=lo, info=dict(info),
            index_blocks=[zlib.compress(flat[s:e].tobytes(), 6)
                          for s, e in slices[lo:hi]]))
    return frags


def _write_logical(path, arr, num_ranks, generation=None):
    frags = _anchor_fragments(arr, num_ranks)
    writers = []
    for rank in range(num_ranks):
        w = ShardNCKWriter(path, rank, num_ranks, generation=generation)
        w.add_fragment("step0000", frags[rank])
        w.write()
        writers.append(w)
    return writers[0].commit_manifest(timeout=5.0)


def _anchor(path):
    from repro_torch.core.compress import decode_anchor
    return decode_anchor(NCKReader(path).read_step("step0000"), "cpu")


def test_manifest_round_trip_in_both_readers(tmp_path):
    path = str(tmp_path / "series.nck")
    arr = np.arange(100, dtype=np.float32)
    _write_logical(path, arr, 2)
    assert sorted(os.listdir(tmp_path)) == [
        "series.nck", "series.nck.g0000.rank0", "series.nck.g0000.rank1"]
    np.testing.assert_array_equal(_anchor(path), arr)
    assert JReader(path).step_names() == ["step0000"]
    raw = open(path, "rb").read()
    assert raw[:4] == container._MANIFEST_MAGIC
    hlen = struct.unpack("<Q", raw[4:12])[0]
    assert json.loads(raw[12:12 + hlen])["schema"] == 2
    with open(path, "wb") as f:
        f.write(b"XXXX" + raw[4:])
    with pytest.raises(Exception):
        NCKReader(path)


@pytest.mark.parametrize("damage", ["missing", "truncated"])
def test_reader_rejects_damaged_shard(tmp_path, damage):
    path = str(tmp_path / "series.nck")
    _write_logical(path, np.arange(64, dtype=np.float32), 2)
    victim = rank_file_path(path, 0, 1)
    if damage == "missing":
        os.remove(victim)
        with pytest.raises(FileNotFoundError, match="rank 1"):
            NCKReader(path)
    else:
        data = open(victim, "rb").read()
        with open(victim, "wb") as f:
            f.write(data[:-3])
        with pytest.raises(ValueError, match="bytes"):
            NCKReader(path)


def test_generation_bump_and_gc(tmp_path):
    path = str(tmp_path / "series.nck")
    arr = np.arange(80, dtype=np.float32)
    _write_logical(path, arr, 2)
    assert read_manifest(path)["generation"] == 0
    _write_logical(path, arr * 2, 2)          # next_generation() picks 1
    m = read_manifest(path)
    assert m["generation"] == 1 and m["previous"]["generation"] == 0
    assert sorted(os.listdir(tmp_path)) == [
        "series.nck",
        "series.nck.g0000.rank0", "series.nck.g0000.rank1",
        "series.nck.g0001.rank0", "series.nck.g0001.rank1"]
    _write_logical(path, arr * 3, 2)          # generation 0 is GC'd
    assert sorted(os.listdir(tmp_path)) == [
        "series.nck",
        "series.nck.g0001.rank0", "series.nck.g0001.rank1",
        "series.nck.g0002.rank0", "series.nck.g0002.rank1"]
    np.testing.assert_array_equal(_anchor(path), arr * 3)


def test_commit_timeout_preserves_previous_manifest(tmp_path):
    path = str(tmp_path / "series.nck")
    arr = np.arange(48, dtype=np.float32)
    _write_logical(path, arr, 2)              # generation 0, loadable
    w = ShardNCKWriter(path, 0, 2)            # rank 1 never publishes
    w.add_fragment("step0000", _anchor_fragments(arr, 2)[0])
    w.write()
    with pytest.raises(CommitTimeoutError, match="previous manifest") as ei:
        w.commit_manifest(timeout=0.3)
    assert ei.value.report["missing_ranks"] == [1]
    assert read_manifest(path)["generation"] == 0
    np.testing.assert_array_equal(_anchor(path), arr)


def test_corrupt_rank_file_is_quarantined(tmp_path):
    """A published rank file that fails verification is moved aside and
    the commit waits; the writer's re-publish then lands."""
    path = str(tmp_path / "series.nck")
    arr = np.arange(64, dtype=np.float32)
    frags = _anchor_fragments(arr, 2)
    ws = []
    for rank in range(2):
        w = ShardNCKWriter(path, rank, 2)
        w.add_fragment("step0000", frags[rank])
        w.write()
        ws.append(w)
    victim = ws[1].rank_path
    raw = bytearray(open(victim, "rb").read())
    raw[-5] ^= 0x10
    open(victim, "wb").write(bytes(raw))
    with pytest.raises(CommitTimeoutError) as ei:
        ws[0].commit_manifest(timeout=0.3)
    assert ei.value.report["quarantined"] == [
        os.path.basename(victim) + ".quarantine"]
    ws[1].write()
    ws[0].commit_manifest(timeout=5.0)
    np.testing.assert_array_equal(_anchor(path), arr)


# ---------------------------------------------------- two ranks over gloo

_WORKER = textwrap.dedent("""
    import os
    import numpy as np
    from repro_torch.launch import distributed as ld
    cfg = ld.initialize()
    from repro_torch.core.types import NumarckParams
    from repro_torch.distributed.pipeline import MultiProcessCompressor
    rng = np.random.default_rng(7)
    n = {n}
    series = [rng.normal(1.0, 0.5, n).astype(np.float32)]
    for t in range(2):
        nxt = (series[-1] * (1 + 0.01 * rng.standard_normal(n))
               ).astype(np.float32)
        nxt[t::401] *= 40.0
        series.append(nxt * {scale})
    mp = MultiProcessCompressor(["cpu"], NumarckParams(block_bytes=4096),
                                overlap=True)
    out = mp.save_series(os.environ["OUT_PATH"], series,
                         manifest_timeout=10.0)
    mp.close()
    ld.shutdown()
    print("WORKER_OK", out)
""")
N_MP = 12_345


def _spawn(path, scale=1.0, faults=None):
    env = dict(os.environ, OUT_PATH=path, PYTHONPATH=SRC)
    env.pop("REPRO_FAULTS", None)
    if faults:
        env["REPRO_FAULTS"] = faults
    return ld.spawn_emulated(2, ["-c", _WORKER.format(n=N_MP, scale=scale)],
                             base_env=env, timeout=240)


def _local_steps(scale=1.0):
    rng = np.random.default_rng(7)
    series = [rng.normal(1.0, 0.5, N_MP).astype(np.float32)]
    for t in range(2):
        nxt = (series[-1] * (1 + 0.01 * rng.standard_normal(N_MP))
               ).astype(np.float32)
        nxt[t::401] *= 40.0
        series.append(nxt * np.float32(scale))
    sc = ShardedCompressor(_cpu(2), repro_torch.NumarckParams(
        block_bytes=4096))
    steps = sc.compress_series(series)
    sc.close()
    return steps


def test_two_rank_save_series_and_crashed_rank(tmp_path):
    """Two gloo ranks publish rank files plus an NCKM manifest that loads
    in both packages' readers and equals the single-process steps (written
    and read back the same way).  Then rank 1 dies mid-series
    (REPRO_FAULTS rank_crash@1): rank 0 fails too, and the previous
    manifest stays loadable."""
    path = str(tmp_path / "series.nck")
    res = _spawn(path)
    ld.check_spawned(res)
    assert "WORKER_OK" in res[0].stdout
    assert sorted(os.listdir(tmp_path)) == [
        "series.nck", "series.nck.g0000.rank0", "series.nck.g0000.rank1"]
    ref = str(tmp_path / "ref.nck")
    w = NCKWriter()
    for i, s in enumerate(_local_steps()):
        w.add_step(f"step{i:04d}", s)
    w.write(ref)
    got, want = NCKReader(path), NCKReader(ref)
    names = got.step_names()
    assert names == ["step0000", "step0001", "step0002"]
    read = [got.read_step(n) for n in names]
    _assert_same(read, [want.read_step(n) for n in names], skip=())
    jread = [JReader(path).read_step(n) for n in names]
    for a, b in zip(repro_torch.decompress_series(read, device="cpu"),
                    jcompress.decompress_series(jread)):
        np.testing.assert_array_equal(a, b)

    res = _spawn(path, scale=2.0, faults="rank_crash@1")
    assert res[1].returncode != 0 and "InjectedFault" in res[1].stderr
    assert res[0].returncode != 0
    assert read_manifest(path)["generation"] == 0
    after = NCKReader(path)
    for n, s in zip(names, read):
        assert after.read_step(n).index_blocks == s.index_blocks


# ------------------------------------------- signed zeros of the range pass

# (shards, shard holding a -0 ratio, shard holding a +0 ratio or None):
# a shard's own minimum is -0 when it holds both (XLA's min), and the
# reference's pmin keeps the zero of the first shard that holds one.
ZERO_CASES = [(1, 0, 0), (2, 1, 0), (2, 0, 1), (2, 1, 1), (4, 2, None),
              (4, 3, 1), (4, 1, 3), (4, 2, 2)]
N_ZERO = 8_192

_ZERO_JAX = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np, jax
    from jax.sharding import Mesh
    from repro.core.container import NCKWriter
    from repro.core.types import NumarckParams
    from repro.distributed.pipeline import ShardedCompressor
    out, cases, n = sys.argv[1], eval(sys.argv[2]), int(sys.argv[3])
    for shards, neg, pos in cases:
        rng = np.random.default_rng(11)
        base = rng.uniform(1.0, 2.0, n).astype(np.float32)
        # every other ratio > 0; a -0 where x == prev < 0, a +0 where
        # x == prev > 0
        nxt = (base * (1 + 1e-3 * (0.5 + rng.random(n)))).astype(np.float32)
        ln = -(-n // shards)
        base[neg * ln + 5] = nxt[neg * ln + 5] = -1.5
        if pos is not None:
            nxt[pos * ln + 9] = base[pos * ln + 9]
        tag = f"{shards}_{neg}_{pos}"
        np.save(f"{out}/series_{tag}.npy", np.stack([base, nxt]))
        js = ShardedCompressor(Mesh(np.array(jax.devices()[:shards]),
                                    ("data",)), "data",
                               NumarckParams(block_bytes=4096),
                               use_pallas=False)
        w = NCKWriter()
        for i, s in enumerate(js.compress_series([base, nxt])):
            w.add_step(f"step{i:04d}", s)
        js.close()
        w.write(f"{out}/jax_{tag}.nck")
    print("ZERO_OK")
""")


@pytest.fixture(scope="module")
def zero_files(tmp_path_factory):
    """The JAX sharded driver's NCK files for ZERO_CASES, written over
    four host devices in one subprocess, beside each case's series."""
    out = tmp_path_factory.mktemp("zeros")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _ZERO_JAX, str(out),
                          repr(ZERO_CASES), str(N_ZERO)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "ZERO_OK" in res.stdout, res.stderr
    return out


def _zero_case(out, case):
    tag = "_".join(map(str, case))
    return (list(np.load(out / f"series_{tag}.npy")),
            (out / f"jax_{tag}.nck").read_bytes())


def _nck_bytes(steps, path):
    w = NCKWriter()
    for i, s in enumerate(steps):
        w.add_step(f"step{i:04d}", s)
    w.write(str(path))
    return path.read_bytes()


@pytest.mark.parametrize("case", ZERO_CASES,
                         ids=["_".join(map(str, c)) for c in ZERO_CASES])
def test_sharded_zero_minimum_keeps_the_reference_sign(case, zero_files,
                                                       tmp_path):
    """A step whose smallest ratio is zero, a -0 on one shard: the
    sharded NCK bytes (domain_lo's sign among them) equal the JAX
    sharded driver's over 1, 2 and 4 shards."""
    shards, neg, pos = case
    arrays, want = _zero_case(zero_files, case)
    sc = ShardedCompressor(_cpu(shards), repro_torch.NumarckParams(
        block_bytes=4096))
    steps = sc.compress_series(arrays)
    sc.close()
    first_zero = neg if pos is None else min(neg, pos)
    assert np.signbit(steps[1].domain_lo) == (first_zero == neg)
    assert steps[1].domain_lo == 0
    assert _nck_bytes(steps, tmp_path / "port.nck") == want


_ZERO_WORKER = textwrap.dedent("""
    import os
    import numpy as np
    from repro_torch.launch import distributed as ld
    ld.initialize()
    from repro_torch.core.types import NumarckParams
    from repro_torch.distributed.pipeline import MultiProcessCompressor
    mp = MultiProcessCompressor(["cpu"], NumarckParams(block_bytes=4096))
    mp.save_series(os.environ["OUT_PATH"],
                   list(np.load(os.environ["SERIES"])),
                   manifest_timeout=10.0)
    mp.close()
    ld.shutdown()
""")


@pytest.mark.parametrize("case", [(2, 1, 0), (2, 0, 1), (2, 1, 1)],
                         ids=["neg_on_rank1", "neg_on_rank0", "both_on_rank1"])
def test_two_ranks_zero_minimum_keeps_the_reference_sign(case, zero_files,
                                                         tmp_path):
    """The same through two gloo ranks: the ends cross processes with
    their signs, and the steps read back through the manifest write the
    JAX sharded driver's NCK bytes."""
    _, want = _zero_case(zero_files, case)
    path = str(tmp_path / "series.nck")
    tag = "_".join(map(str, case))
    env = dict(os.environ, OUT_PATH=path, PYTHONPATH=SRC,
               SERIES=str(zero_files / f"series_{tag}.npy"))
    env.pop("REPRO_FAULTS", None)
    ld.check_spawned(ld.spawn_emulated(2, ["-c", _ZERO_WORKER],
                                       base_env=env, timeout=240))
    r = NCKReader(path)
    steps = [r.read_step(n) for n in r.step_names()]
    assert _nck_bytes(steps, tmp_path / "port.nck") == want


_ORIG_WORKER = textwrap.dedent("""
    import os
    import numpy as np
    from repro_torch.launch import distributed as ld
    ld.initialize()
    from repro_torch.core.types import NumarckParams
    from repro_torch.distributed.pipeline import MultiProcessCompressor
    mp = MultiProcessCompressor(["cpu"], NumarckParams(
        reference="original", block_bytes=1024))
    mp.save_series(os.environ["OUT_PATH"],
                   list(np.load(os.environ["SERIES"])),
                   manifest_timeout=10.0)
    mp.close()
    ld.shutdown()
""")


def test_two_ranks_original_reference_matches_jax(tmp_path):
    """reference="original" through two gloo ranks (the multi-process
    driver's chain.replace branch): the steps merged through the NCKM
    manifest write the NCK bytes of the JAX package's single-device steps
    for the same series and params, and decompress to its arrays."""
    arrays = _series()
    np.save(tmp_path / "series.npy", np.stack(arrays))
    path = str(tmp_path / "series.nck")
    env = dict(os.environ, OUT_PATH=path, PYTHONPATH=SRC,
               SERIES=str(tmp_path / "series.npy"))
    env.pop("REPRO_FAULTS", None)
    ld.check_spawned(ld.spawn_emulated(2, ["-c", _ORIG_WORKER],
                                       base_env=env, timeout=240))
    r = NCKReader(path)
    got = [r.read_step(n) for n in r.step_names()]
    want = jcompress.compress_series(
        arrays, JParams(reference="original", block_bytes=1024))
    jw = JWriter()
    for i, s in enumerate(want):
        jw.add_step(f"step{i:04d}", s)
    jw.write(str(tmp_path / "jax.nck"))
    assert (_nck_bytes(got, tmp_path / "port.nck")
            == (tmp_path / "jax.nck").read_bytes())
    for a, b in zip(repro_torch.decompress_series(got, device="cpu"),
                    jcompress.decompress_series(want)):
        np.testing.assert_array_equal(a, b)
