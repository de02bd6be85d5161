"""The port's single-device top-k slice against the JAX package, end to end.

``repro_torch.compress_series`` (device "cpu": the kernels' plain
versions) must give the JAX package's steps field for field and blob for
blob, for every chain residency, overlap mode and host codec; both
decompressors must agree bit for bit; steps cross between the packages
through ``repro_torch.interop``.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.core import blocks as jblocks  # noqa: E402
from repro.core import compress as jcompress  # noqa: E402
from repro.core.container import NCKWriter  # noqa: E402
from repro.core.types import CompressedStep as JStep  # noqa: E402
from repro.core.types import NumarckParams as JParams  # noqa: E402
from repro.data.temporal import generate_series as jseries  # noqa: E402
from repro.kernels import rans as jrans  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import blocks as tblocks  # noqa: E402
from repro_torch.core import compress as tcompress  # noqa: E402
from repro_torch.data.temporal import generate_series as tseries  # noqa: E402
from repro_torch.kernels import rans as trans  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SERIES = {"stir_f32": ("stir", 4, 4), "sedov_f64": ("sedov", 3, 2)}
CODECS = ("zlib", "raw", "bz2", "lzma", "auto")


def _assert_steps_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        fg, fw = interop.step_to_fields(g), interop.step_to_fields(w)
        assert fg.keys() == fw.keys()
        for k, vg in fg.items():
            vw = fw[k]
            if isinstance(vw, np.ndarray):
                assert isinstance(vg, np.ndarray), k
                assert vg.dtype == vw.dtype and vg.shape == vw.shape, k
                np.testing.assert_array_equal(vg, vw, err_msg=k)
            else:
                assert vg == vw, k


@pytest.fixture(scope="module", params=sorted(SERIES))
def series(request):
    name, steps, scale = SERIES[request.param]
    arrays = list(tseries(name, steps, seed=0, scale=scale))
    for a, b in zip(arrays, jseries(name, steps, seed=0, scale=scale)):
        np.testing.assert_array_equal(a, b)
    return arrays


@pytest.mark.parametrize("codec", CODECS)
def test_compress_series_matches_jax(series, codec):
    want = jcompress.compress_series(series, JParams(codec=codec))
    params = repro_torch.NumarckParams(codec=codec)
    assert params.to_json() == JParams(codec=codec).to_json()
    for chain in ("host", "device"):
        for overlap in (False, True):
            got = repro_torch.compress_series(series, params, overlap=overlap,
                                              chain=chain, device="cpu")
            _assert_steps_equal(got, want)
    # Decompressors agree bit for bit, and each decodes the other's steps.
    recon = jcompress.decompress_series(want)
    for arrs in (repro_torch.decompress_series(got, device="cpu"),
                 repro_torch.decompress_series(
                     [interop.step_from_fields(interop.step_to_fields(s))
                      for s in want], device="cpu")):
        for a, b in zip(arrs, recon):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("symbol_rans", [False, True])
def test_rans_series_matches_jax(series, symbol_rans, monkeypatch):
    """codec="rans" through the device entropy stage (the kernels' plain
    versions on the CPU) and the device read path: steps byte-identical
    to the JAX package's device stage, reconstructions bit-identical to
    its decompressor, f32 and f64."""
    monkeypatch.setattr(jrans, "DEVICE_MIN_BYTES", 0)
    monkeypatch.setattr(trans, "DEVICE_MIN_BYTES", 0)
    calls = {"encode": 0, "decode": 0}

    def spy(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(trans, "encode_plain",
                        spy("encode", trans.encode_plain))
    for name in ("decode_bytes_plain", "decode_syms_plain"):
        monkeypatch.setattr(trans, name, spy("decode", getattr(trans, name)))
    kw = dict(codec="rans", symbol_rans=symbol_rans)
    want = jcompress.compress_series(series, JParams(**kw))
    got = repro_torch.compress_series(series, repro_torch.NumarckParams(**kw),
                                      chain="device", device="cpu")
    _assert_steps_equal(got, want)
    assert calls["encode"] == len(series) - 1
    version = 2 if symbol_rans else 1
    assert all(trans.blob_version(b) == version
               for s in got[1:] for b in s.index_blocks)
    recon = repro_torch.decompress_series(got, device="cpu")
    assert calls["decode"] >= len(series) - 1
    anchor = tcompress.decode_anchor_device(got[0], "cpu")
    np.testing.assert_array_equal(anchor.numpy(), recon[0])
    for a, b in zip(recon, jcompress.decompress_series(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("chain", ["host", "device"])
def test_reference_state_is_the_decompressed_step(series, chain):
    """The compressor's chain state after each step equals what the
    decompressor rebuilds from the finalized blobs."""
    c = repro_torch.TemporalCompressor(chain=chain, device="cpu")
    d = repro_torch.TemporalDecompressor(device="cpu")
    try:
        for a in series:
            recon = d.add(c.add(a))
            state = c.reference_state()
            assert state.dtype == recon.dtype
            np.testing.assert_array_equal(state, recon)
    finally:
        c.close()


def test_deflate_blocks_matches_jax():
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 1 << 6, 40_000).astype(np.int32)
    want = jblocks.deflate_blocks(idx, 6, 4096, codec="bz2")
    got = tblocks.deflate_blocks(idx, 6, 4096, codec="bz2")
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    for bi, (s, e) in enumerate(tblocks.block_slices(idx.size, 4096)):
        np.testing.assert_array_equal(
            tblocks.inflate_block(got[0][bi], e - s, 6, codec="bz2"),
            idx[s:e])


def test_nck_writer_bytes_from_port_steps(series, tmp_path):
    params = repro_torch.NumarckParams()
    got = repro_torch.compress_series(series, params, device="cpu")
    want = jcompress.compress_series(series, JParams())
    paths = []
    for tag, steps in (("jax", want),
                       ("port", [JStep(**interop.step_to_fields(s))
                                 for s in got])):
        w = NCKWriter()
        for i, s in enumerate(steps):
            w.add_step(f"v/{i}", s)
        paths.append(tmp_path / f"{tag}.nck")
        w.write(str(paths[-1]))
    assert paths[0].read_bytes() == paths[1].read_bytes()


@pytest.mark.parametrize("kind", ["unchanged", "grown", "shrunk"])
def test_signed_zero_range_matches_jax(kind, tmp_path):
    """Steps whose extreme ratio is zero, from values that did not change,
    half of them negative: x / negative prev is -0, and the reference's
    min and max (XLA's, -0 below +0) record the signed zeros in
    domain_lo and meta ratio_min/ratio_max.  The port's steps carry the
    same signs, and so the same NCK bytes."""
    rng = np.random.default_rng(5)
    prev = rng.normal(0, 1, 8192).astype(np.float32)
    curr = prev.copy()
    moved = rng.random(prev.size) < 0.5
    if kind == "grown":
        curr[moved] *= np.float32(1.0005)
    elif kind == "shrunk":
        # every value that moved shrinks, and every unchanged one is
        # negative: the largest ratio is -0
        curr[moved] *= np.float32(0.9995)
        curr[~moved] = -np.abs(curr[~moved])
        prev[~moved] = curr[~moved]
    series = [prev, curr]
    want = jcompress.compress_series(series, JParams())
    got = repro_torch.compress_series(series, repro_torch.NumarckParams(),
                                      device="cpu")
    _assert_steps_equal(got, want)
    for key in ("ratio_min", "ratio_max"):
        assert np.signbit(got[1].meta[key]) == np.signbit(want[1].meta[key])
    assert np.signbit(got[1].domain_lo) == np.signbit(want[1].domain_lo)
    assert np.signbit(want[1].meta["ratio_min" if kind != "shrunk"
                                   else "ratio_max"])
    paths = []
    for tag, steps in (("jax", want),
                       ("port", [JStep(**interop.step_to_fields(s))
                                 for s in got])):
        w = NCKWriter()
        for i, st in enumerate(steps):
            w.add_step(f"v/{i}", st)
        paths.append(tmp_path / f"{tag}.nck")
        w.write(str(paths[-1]))
    assert paths[0].read_bytes() == paths[1].read_bytes()


def test_params_round_trip_through_dict():
    jp = JParams(codec="bz2", b_bits=9, max_bins=4096, error_bound=2e-3)
    tp = interop.params_from_dict(jp.__dict__)
    assert tp.to_json() == jp.to_json()


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arrays = list(tseries("stir", 2, seed=0, scale=16))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.compress_series(arrays)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcompress.encode_device(arrays[0], arrays[1],
                                repro_torch.NumarckParams())
    steps = repro_torch.compress_series(arrays, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.decompress_series(steps)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.TemporalDecompressor()


@pytest.mark.parametrize("codec", ["zlib", "rans"])
@pytest.mark.parametrize("strategy", ["equal", "log", "kmeans"])
def test_strategy_series_matches_jax(series, strategy, codec, monkeypatch):
    """The equal-width, log-scale and k-means strategies through
    compress_series: every step field for field and blob for blob, f32 and
    f64, the host zlib stage and the device rANS stage (the kernels' plain
    versions); both decompressors agree bit for bit."""
    monkeypatch.setattr(jrans, "DEVICE_MIN_BYTES", 0)
    monkeypatch.setattr(trans, "DEVICE_MIN_BYTES", 0)
    kw = dict(strategy=strategy, codec=codec)
    want = jcompress.compress_series(series, JParams(**kw))
    got = repro_torch.compress_series(series, repro_torch.NumarckParams(**kw),
                                      device="cpu")
    _assert_steps_equal(got, want)
    for a, b in zip(repro_torch.decompress_series(got, device="cpu"),
                    jcompress.decompress_series(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("chain", ["host", "device"])
@pytest.mark.parametrize("codec", ["zlib", "rans"])
@pytest.mark.parametrize("strategy", ["topk", "equal"])
def test_original_reference_series_matches_jax(series, strategy, codec, chain,
                                               monkeypatch):
    """reference="original" (each step against the original previous step,
    the drivers' chain.replace branch) with the host and the device
    chain: every step field for field and blob for blob, and both
    decompressors' arrays bit for bit, f32 and f64."""
    monkeypatch.setattr(jrans, "DEVICE_MIN_BYTES", 0)
    monkeypatch.setattr(trans, "DEVICE_MIN_BYTES", 0)
    kw = dict(reference="original", strategy=strategy, codec=codec)
    want = jcompress.compress_series(series, JParams(**kw))
    got = repro_torch.compress_series(series, repro_torch.NumarckParams(**kw),
                                      chain=chain, device="cpu")
    _assert_steps_equal(got, want)
    for a, b in zip(repro_torch.decompress_series(got, device="cpu"),
                    jcompress.decompress_series(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("strategy", ["equal", "log", "kmeans"])
def test_port_reads_jax_strategy_series(series, strategy, tmp_path):
    """NCK files the JAX package wrote with each strategy (zlib and rans
    steps): the port decompresses them bit-identically and rewrites them
    byte-identically."""
    from repro.core.container import NCKReader as JReader

    steps = []
    for codec in ("zlib", "rans"):
        steps += jcompress.compress_series(
            series, JParams(strategy=strategy, codec=codec))
    w = NCKWriter()
    for i, s in enumerate(steps):
        w.add_step(f"v/{i}", s)
    path = tmp_path / "jax.nck"
    w.write(str(path))
    r = repro_torch.NCKReader(str(path))
    read = [r.read_step(n) for n in r.step_names()]
    jread = [JReader(str(path)).read_step(n) for n in r.step_names()]
    half = len(series)
    for part in (slice(0, half), slice(half, None)):
        for a, b in zip(repro_torch.decompress_series(read[part],
                                                      device="cpu"),
                        jcompress.decompress_series(jread[part])):
            np.testing.assert_array_equal(a, b)
    tw = repro_torch.NCKWriter()
    for n, s in zip(r.step_names(), read):
        tw.add_step(n, s)
    tw.write(str(tmp_path / "port.nck"))
    assert (tmp_path / "port.nck").read_bytes() == path.read_bytes()


def test_import_leaves_jax_and_repro_out():
    code = ("import sys, repro_torch, repro_torch.core.compress, "
            "repro_torch.kernels.ops, repro_torch.interop, "
            "repro_torch.distributed.pipeline, "
            "repro_torch.launch.distributed, repro_torch.obs, "
            "repro_torch.checkpoint, repro_torch.models.model, "
            "repro_torch.serve.engine, repro_torch.configs, "
            "repro_torch.train.trainer, repro_torch.launch.train, "
            "repro_torch.data.tokens, repro_torch.faults, "
            "repro_torch.models.ssm, repro_torch.launch.mesh, "
            "repro_torch.launch.runtime_env, "
            "repro_torch.distributed.sharding, "
            "repro_torch.distributed.pipeline_parallel, "
            "repro_torch.checkpoint.elastic, repro_torch.launch.dryrun, "
            "repro_torch.launch.cost_model, repro_torch.models.unroll, "
            "repro_torch.analysis, repro_torch.analysis.cli, "
            "repro_torch.analysis.passes\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_no_jax_or_repro_import_in_the_port():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(examples) == 4, examples
    files += examples
    assert len(files) > 20
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "repro",
                                                  "ml_dtypes"), \
                    f"{f}: imports {name}"


# Reference modules without a port module yet, and where the ROADMAP
# queues each.
UNPORTED_MODULES = {
    "repro.kernels.ref": "not ported: the plain versions fill its role",
}
# Reference modules whose __all__ is read from their source: importing
# repro.launch.dryrun sets XLA_FLAGS to 512 host devices in this process,
# which would change every later JAX test of the worker.
READ_BY_AST = ("repro.launch.dryrun",)
_RANS_LOWERINGS = (
    "bytes_to_words", "decode_bytes_group", "decode_idx_group_packed",
    "decode_idx_group_syms", "decode_scan_body", "encode_bytes_body",
    "encode_idx_group", "encode_sym_group", "pack_words", "sample_words",
    "sampled_idx_bytes", "unpack_group", "unpack_words", "words_to_bytes")
# Names in a reference module's __all__ that its port module does not
# export: the jnp lowerings and Pallas entry points that the hand-written
# kernels (their ``*_cuda`` wrappers and ``*_plain`` versions) replace,
# and what the port holds in modules instead.
NOT_EXPORTED = {
    "repro.core.binning": {"topk_centers": "jnp lowering; the centers are "
                           "core.pipeline.topk_centers'"},
    "repro.core.packing": dict.fromkeys(
        ("pack_indices_jnp", "unpack_indices_jnp"),
        "jnp lowerings; kernels.bitpack and packing.pack_indices"),
    "repro.kernels.bitpack": {"GROUP": "core.packing.GROUP",
                              "pack_bits": "pack_bits_cuda / _plain"},
    "repro.kernels.change_ratio": {
        "change_ratio_bins": "change_ratio_bins_cuda / _plain"},
    "repro.kernels.dequant": dict.fromkeys(
        ("dequantize", "dequantize_jnp"), "dequantize_cuda / _plain"),
    "repro.kernels.hist": {"histogram": "histogram_cuda / _plain"},
    "repro.kernels.ops": dict.fromkeys(
        ("chain_advance_core", "patch_exceptions"),
        "jnp lowerings; kernels.dequant.chain_advance_cuda / _plain and "
        "patch_exceptions"),
    "repro.kernels.rans": dict.fromkeys(
        _RANS_LOWERINGS, "the scan bodies and their jnp helpers; "
        "csrc/rans.cu's kernels and the *_plain lane loops"),
    "repro.launch.runtime_env": {
        "merge_xla_flags": "XLA flags: a torch process needs none"},
    "repro.launch.dryrun": {
        "shape_bytes": "sizes HLO type strings; the op counter reads "
                       "tensors"},
    "repro.models.layers": {"rms_norm_init": "the RMSNorm module"},
    "repro.models.lm": {"init_layer": "the Layer module and init_params"},
}


def _public_names(path):
    """A module's __all__ read from its source, or, where it defines
    none, its public top-level functions and classes."""
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return set(ast.literal_eval(node.value))
    return {node.name for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.ClassDef))
            and not node.name.startswith("_")}


def test_every_reference_export_has_a_port_export():
    """Each reference module's __all__ against its port module's: every
    name exported there is exported here, but for the kernels' jnp
    lowerings and the names listed in NOT_EXPORTED; modules not yet
    ported are the ROADMAP's (UNPORTED_MODULES).  Every name a port
    module exports exists."""
    import importlib
    ref_root = ROOT / "src" / "repro"
    seen = set()
    for f in sorted(ref_root.rglob("*.py")):
        parts = f.relative_to(ROOT / "src").with_suffix("").parts
        if parts[-1] == "__main__":
            continue
        name = ".".join(parts).removesuffix(".__init__")
        if any(name == m or name.startswith(m + ".")
               for m in UNPORTED_MODULES):
            seen.add(next(m for m in UNPORTED_MODULES
                          if name == m or name.startswith(m + ".")))
            continue
        port = importlib.import_module("repro_torch" + name[len("repro"):])
        want = (_public_names(f) if name in READ_BY_AST else
                set(getattr(importlib.import_module(name), "__all__", ())))
        got = set(getattr(port, "__all__", ()))
        assert sorted(want - got) == sorted(NOT_EXPORTED.get(name, {})), name
        for n in got:
            assert hasattr(port, n), f"{port.__name__}.{n}"
    assert seen == set(UNPORTED_MODULES)


def test_missing_core_functions_match_the_reference():
    """The four names the port's core modules lacked, value for value."""
    from repro.core import blocks as jb, packing as jp, select_b as js
    from repro.core import types as jt
    from repro_torch.core import blocks as tb, packing as tp
    from repro_torch.core import select_b as ts, types as tt
    for k in range(0, 3000):
        assert tt.required_b_for_k(k) == jt.required_b_for_k(k)
    for n in (0, 1, 7, 8, 9, 1000, 12345):
        for b in range(1, 25):
            assert tp.packed_nbytes(n, b) == jp.packed_nbytes(n, b)
    rng = np.random.default_rng(0)
    for m, n in ((5, 100), (3000, 1 << 20), (70000, 1 << 25)):
        counts = np.sort(rng.integers(0, n // m + 2, m))[::-1].astype(
            np.int32)
        for b_max in (8, 16, 24):
            assert ts.choose_b_host(counts, n, 4, b_max) == \
                js.choose_b_host(counts, n, 4, b_max)
    blocks = [bytes(rng.integers(0, 256, k, dtype=np.uint8)) for k in
              (10, 300, 0)]
    raw = np.array([40, 900, 5])
    assert tb.zlib_ratio(blocks, raw) == jb.zlib_ratio(blocks, raw)
    from repro_torch.core import NCKReader, compress_series  # noqa: F401
    from repro_torch.faults import Backoff, CorruptBlockError  # noqa: F401
