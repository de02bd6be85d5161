"""The port's telemetry layer (src/repro_torch/obs) against the JAX
package's (src/repro/obs), mirroring tests/test_obs.py.

Span semantics, the free disabled path, the Chrome-trace export and the
overlap queue metrics of the port's own copy; then the invariants that tie
it to the reference: telemetry never changes outputs (the port's steps and
NCK file bytes are the same with it on or off, and equal to the JAX
package's with it on in both), and the per-step, per-read and rollup
records have the reference's key sets for both drivers and both overlap
modes.  Everything runs on the CPU (the kernels' plain versions).
"""
import json
import os
import re
import textwrap
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import compress as jcompress  # noqa: E402
from repro.core import entropy as jentropy  # noqa: E402
from repro.core.container import NCKWriter as JWriter  # noqa: E402
from repro.core.types import NumarckParams as JParams  # noqa: E402
from repro.kernels import rans as jrans  # noqa: E402
from repro.obs import report as jreport  # noqa: E402
from repro.obs import telemetry as jtelemetry  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro_torch import compress_series, decompress_series  # noqa: E402
from repro_torch.core import entropy  # noqa: E402
from repro_torch.core.container import NCKWriter  # noqa: E402
from repro_torch.core.overlap import FinalizeQueue, _attach_context  # noqa: E402
from repro_torch.core.types import NumarckParams  # noqa: E402
from repro_torch.distributed.pipeline import (ShardedCompressor,  # noqa: E402
                                              ShardedDecompressor)
from repro_torch.kernels import rans as trans  # noqa: E402
from repro_torch.launch import distributed as ld  # noqa: E402
from repro_torch.obs import report, telemetry, trace  # noqa: E402
from repro_torch.obs.report import (READ_TELEMETRY_KEYS,  # noqa: E402
                                    STEP_TELEMETRY_KEYS)

KW = dict(error_bound=1e-3, max_bins=1024, block_bytes=512)
P = NumarckParams(**KW)
# Per-step fields that do not depend on the clock.
FIXED_KEYS = ("bytes_in", "bytes_out", "entropy_ratio", "codec",
              "device_entropy")


@pytest.fixture(autouse=True)
def _telemetry_off():
    """Tests must never leak an enabled registry into each other."""
    telemetry.stop()
    jtelemetry.stop()
    yield
    telemetry.stop()
    jtelemetry.stop()


def _series(n_steps=4, n=4096, seed=0):
    rng = np.random.default_rng(seed)
    out = [rng.normal(size=n).astype(np.float32)]
    for _ in range(n_steps - 1):
        out.append(out[-1]
                   + rng.normal(scale=1e-4, size=n).astype(np.float32))
    return out


def _blob_sig(steps):
    """Everything that lands in the NCK container, as comparable bytes."""
    return [(s.b_bits, s.codec, tuple(s.block_codecs or ()),
             tuple(s.index_blocks),
             b"" if s.incomp_values is None else s.incomp_values.tobytes())
            for s in steps]


def _nck_bytes(writer_cls, steps, path) -> bytes:
    w = writer_cls()
    for i, s in enumerate(steps):
        w.add_step(f"v_it{i:05d}", s)
    w.write(str(path))
    return path.read_bytes()


# Span names of the port alone: its step, upload, chain and entropy-stage
# spans, the sync.* family (one span per call that blocks on the device)
# and the coll.* family (one span per collective call).
PORT_SPANS = {"compress.step", "upload.stage", "chain.advance",
              "choose_b.model", "entropy.tables", "entropy.assemble"}


def _port_spans(names) -> set:
    return {n for n in names
            if n in PORT_SPANS or n.startswith(("sync.", "coll."))}


def _lane_kinds(doc) -> set:
    """Thread lane names of a Chrome trace without their pool index."""
    return {re.sub(r"_\d+$", "", e["args"]["name"])
            for e in doc["traceEvents"] if e["ph"] == "M"}


# ---------------------------------------------------------------- spans

def test_span_nesting_depth_and_attrs():
    with telemetry.capture() as reg:
        with telemetry.span("a", step=1) as sa:
            with telemetry.span("b"):
                with telemetry.span("c") as sc:
                    sc.set(late=42)
            sa.set(bytes_out=7)
    recs = {r.name: r for r in reg.spans}
    assert [recs[n].depth for n in "abc"] == [0, 1, 2]
    assert recs["a"].t0 <= recs["b"].t0 <= recs["c"].t0
    assert recs["c"].t1 <= recs["b"].t1 <= recs["a"].t1
    assert recs["a"].attrs == {"step": 1, "bytes_out": 7}
    assert recs["c"].attrs == {"late": 42}
    assert all(r.duration >= 0.0 for r in reg.spans)


def test_span_stack_is_thread_local():
    with telemetry.capture() as reg:
        def worker():
            with telemetry.span("w.outer"):
                with telemetry.span("w.inner"):
                    pass
        with telemetry.span("main.outer"):
            t = threading.Thread(target=worker, name="obs-worker")
            t.start()
            t.join(timeout=10)
        assert not t.is_alive()
    recs = {r.name: r for r in reg.spans}
    assert recs["w.outer"].depth == 0
    assert recs["w.inner"].depth == 1
    assert recs["main.outer"].depth == 0
    assert recs["w.outer"].tid != recs["main.outer"].tid
    assert recs["w.inner"].tname == "obs-worker"


def test_span_error_recorded_and_propagates():
    with telemetry.capture() as reg:
        with pytest.raises(ValueError, match="boom"):
            with telemetry.span("failing"):
                raise ValueError("boom")
        with telemetry.span("after"):
            pass
    recs = {r.name: r for r in reg.spans}
    assert recs["failing"].error == "ValueError: boom"
    assert recs["after"].depth == 0
    assert report.rollup(reg)["spans"]["failing"]["errors"] == 1


def test_capture_scoping():
    assert not telemetry.enabled()
    with telemetry.capture() as reg:
        assert telemetry.enabled() and telemetry.active() is reg
    assert not telemetry.enabled()
    assert telemetry.stop() is None


def test_public_names_match_the_reference():
    from repro import obs as jobs
    from repro_torch import obs
    assert obs.__all__ == jobs.__all__
    assert telemetry.__all__ == jtelemetry.__all__
    assert report.__all__ == jreport.__all__
    assert trace.__all__ == jtrace.__all__


# ------------------------------------------------------- disabled path

def test_disabled_returns_shared_noop():
    assert not telemetry.enabled()
    assert telemetry.span("x") is telemetry.NOOP_SPAN
    assert telemetry.span("y", k=1) is telemetry.NOOP_SPAN
    assert trace.device_annotation("z") is telemetry.NOOP_SPAN
    assert telemetry.NOOP_SPAN.set(a=1) is telemetry.NOOP_SPAN
    assert telemetry.NOOP_SPAN.duration == 0.0
    telemetry.counter("n"), telemetry.gauge("g", 1.0), telemetry.histo("h", 1.0)


def test_disabled_overhead_is_negligible():
    """As the reference's test: the instrumentation left in the hot paths
    costs ~nothing while disabled, against one small step of the port."""
    assert not telemetry.enabled()
    N = 20_000

    def loop():
        t0 = time.perf_counter()
        for _ in range(N):
            with telemetry.span("hot"):
                pass
            telemetry.counter("hot.n")
            telemetry.gauge("hot.g", 1.0)
        return (time.perf_counter() - t0) / (3 * N)

    per_call = min(loop() for _ in range(3))
    series = _series()
    compress_series(series, P, device="cpu")
    t0 = time.perf_counter()
    steps = compress_series(series, P, device="cpu")
    step_s = (time.perf_counter() - t0) / len(series)
    assert steps[-1].meta.get("telemetry") is None
    assert 100 * per_call < 0.05 * step_s, (
        f"disabled telemetry too hot: {per_call * 1e9:.0f}ns/call vs "
        f"{step_s * 1e3:.2f}ms/step")


def test_annotated_span_reaches_the_torch_profiler():
    """The device bridge: every span opens a record_function of its name,
    which a torch.profiler capture records (on the CPU here)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with telemetry.capture() as reg:
            with telemetry.span("obs.bridge"):
                torch.ones(8).add_(1)
            with trace.device_annotation("obs.bare"):
                torch.ones(8).add_(1)
    names = {e.name for e in prof.events()}
    assert {"obs.bridge", "obs.bare"} <= names
    assert [r.name for r in reg.spans] == ["obs.bridge"]


# ------------------------------------------- outputs must never change

@pytest.mark.parametrize("codec", ["zlib", "rans"])
def test_nck_bytes_identical_on_off_and_to_jax(codec, tmp_path, monkeypatch):
    """Port steps with telemetry off, on, and on with overlap give one set
    of blobs and one NCK file, equal to the JAX package's with its own
    telemetry on.  rans runs the device entropy and read routes
    (DEVICE_MIN_BYTES = 0 in both packages)."""
    monkeypatch.setattr(trans, "DEVICE_MIN_BYTES", 0)
    monkeypatch.setattr(jrans, "DEVICE_MIN_BYTES", 0)
    series = _series()
    p = NumarckParams(**KW, codec=codec)
    base = compress_series(series, p, device="cpu")
    with telemetry.capture(), jtelemetry.capture():
        on = compress_series(series, p, device="cpu")
        on_overlap = compress_series(series, p, overlap=True, device="cpu")
        want = jcompress.compress_series(series, JParams(**KW, codec=codec))
        read_on = decompress_series(on, device="cpu")
    assert _blob_sig(on) == _blob_sig(base) == _blob_sig(on_overlap)
    assert _blob_sig(on) == _blob_sig(want)
    assert on[-1].meta["telemetry"]["device_entropy"] == (codec == "rans")
    got_bytes = _nck_bytes(NCKWriter, on, tmp_path / "port.nck")
    assert got_bytes == _nck_bytes(NCKWriter, base, tmp_path / "off.nck")
    assert got_bytes == _nck_bytes(JWriter, want, tmp_path / "jax.nck")
    for a, b in zip(read_on, decompress_series(base, device="cpu")):
        assert np.array_equal(a, b)


# ------------------------------------------------- per-step rollup

def test_telemetry_key_tuples_equal_the_reference():
    assert STEP_TELEMETRY_KEYS == jreport.STEP_TELEMETRY_KEYS
    assert READ_TELEMETRY_KEYS == jreport.READ_TELEMETRY_KEYS


def test_step_telemetry_canonical_keys_across_overlap_modes():
    """Every step's record has the reference's keys in both overlap modes,
    and its clock-free fields equal the JAX package's step for step."""
    series = _series()
    with telemetry.capture(), jtelemetry.capture():
        serial = compress_series(series, P, overlap=False, device="cpu")
        overlap = compress_series(series, P, overlap=True, device="cpu")
        want = jcompress.compress_series(series, JParams(**KW))
    for steps in (serial, overlap):
        for st, w in zip(steps, want):
            tele = st.meta["telemetry"]
            assert tuple(tele) == STEP_TELEMETRY_KEYS
            assert tele["finalize_s"] >= 0.0
            for k in FIXED_KEYS:
                assert tele[k] == w.meta["telemetry"][k], k
    assert serial[0].is_anchor and not serial[1].is_anchor


@pytest.mark.parametrize("overlap", [False, True])
def test_sharded_driver_same_telemetry_shape_and_blobs(overlap):
    """Single-device vs sharded (1 and 3 CPU shards): the canonical key
    set, byte-identical blobs on or off, and the single-device series
    rollup's clock-free fields; the one-shard rollup has the JAX sharded
    driver's spans, counts and counters."""
    import jax
    from jax.sharding import Mesh
    from repro.distributed.pipeline import ShardedCompressor as JSharded

    series = _series(n_steps=3)
    base = compress_series(series, P, device="cpu")
    single_off = ShardedCompressor(["cpu"], P, overlap=overlap)
    assert _blob_sig(single_off.compress_series(series)) == _blob_sig(base)
    jsc = JSharded(Mesh(np.array(jax.devices()[:1]), ("data",)), "data",
                   JParams(**KW), overlap=overlap, use_pallas=False)
    with telemetry.capture() as reg:
        single_off.compress_series(series)
    with jtelemetry.capture() as jreg:
        jsc.compress_series(series)
    jsc.close()
    roll, jroll = report.rollup(reg), jreport.rollup(jreg)
    assert set(roll["spans"]) - _port_spans(roll["spans"]) \
        == set(jroll["spans"])
    assert _port_spans(roll["spans"]) == {"sync.range", "sync.choose_b",
                                          "choose_b.model", "coll.range",
                                          "coll.hist", "coll.edge"}
    assert roll["counters"] == jroll["counters"]
    for name, agg in jroll["spans"].items():
        assert roll["spans"][name]["count"] == agg["count"], name
    with telemetry.capture():
        single = compress_series(series, P, overlap=overlap, device="cpu")
        for shards in (1, 3):
            sc = ShardedCompressor(["cpu"] * shards, P, overlap=overlap)
            on = sc.compress_series(series)
            sc.close()
            if shards == 1:
                assert _blob_sig(on) == _blob_sig(base)
            for st in on:
                assert tuple(st.meta["telemetry"]) == STEP_TELEMETRY_KEYS
            roll_s = report.series_rollup(single)
            roll_d = report.series_rollup(on)
            assert roll_d.keys() == roll_s.keys()
            assert roll_d["totals"].keys() == roll_s["totals"].keys()
            assert roll_d["steps"] == roll_s["steps"] == len(series)
            if shards == 1:
                for k in ("bytes_in", "bytes_out", "codecs"):
                    assert roll_s[k] == roll_d[k]
    single_off.close()


def test_read_telemetry_keys_on_every_read_path(monkeypatch):
    """The per-read record has the reference's keys on the host and the
    device read routes, anchors and the sharded reader included; its
    clock-free fields equal the JAX package's."""
    monkeypatch.setattr(trans, "DEVICE_MIN_BYTES", 0)
    monkeypatch.setattr(jrans, "DEVICE_MIN_BYTES", 0)
    series = _series(n_steps=3)
    for codec in ("zlib", "rans"):
        p = NumarckParams(**KW, codec=codec)
        steps = compress_series(series, p, device="cpu")
        jsteps = jcompress.compress_series(series, JParams(**KW, codec=codec))
        with telemetry.capture(), jtelemetry.capture():
            decompress_series(steps, device="cpu")
            jcompress.decompress_series(jsteps)
        for st, w in zip(steps, jsteps):
            rec, want = st.meta["telemetry_read"], w.meta["telemetry_read"]
            assert tuple(rec) == READ_TELEMETRY_KEYS
            for k in ("bytes_in", "bytes_out", "codec", "device_decode"):
                assert rec[k] == want[k], (codec, k)
        for st in steps:
            del st.meta["telemetry_read"]
        with telemetry.capture() as reg:
            ShardedDecompressor(["cpu"] * 2).decompress_series(steps)
        assert all(tuple(st.meta["telemetry_read"]) == READ_TELEMETRY_KEYS
                   for st in steps)
        assert {"decode.entropy", "decode.dequant", "decode.patch",
                "decode.fetch"} <= set(reg.span_names())


_MP_WORKER = textwrap.dedent("""
    import json, os
    import numpy as np
    from repro_torch.launch import distributed as ld
    ld.initialize()
    from repro_torch.core.types import NumarckParams
    from repro_torch.distributed.pipeline import MultiProcessCompressor
    from repro_torch.obs import telemetry
    rng = np.random.default_rng(0)
    series = [rng.normal(size=6000).astype(np.float32)]
    for _ in range(2):
        series.append(series[-1] + rng.normal(scale=1e-4, size=6000)
                      .astype(np.float32))
    mp = MultiProcessCompressor(["cpu"], NumarckParams(
        error_bound=1e-3, max_bins=1024, block_bytes=512), overlap=True)
    with telemetry.capture() as reg:
        frags = mp.compress_series_fragments(series)
    mp.close()
    ld.shutdown()
    print("FRAGS " + json.dumps({
        "tele": [f.meta["telemetry"] for f in frags],
        "spans": reg.span_names()}))
""")


def test_multiprocess_fragments_carry_the_step_record():
    """Two gloo ranks: every fragment's record has the canonical keys, and
    the ranks' bytes sum to the single-process two-shard step's."""
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    env.pop("REPRO_FAULTS", None)
    res = ld.spawn_emulated(2, ["-c", _MP_WORKER], base_env=env,
                            timeout=240)
    ld.check_spawned(res)
    ranks = [json.loads(r.stdout.split("FRAGS ", 1)[1]) for r in res]
    rng = np.random.default_rng(0)
    series = [rng.normal(size=6000).astype(np.float32)]
    for _ in range(2):
        series.append(series[-1] + rng.normal(scale=1e-4, size=6000)
                      .astype(np.float32))
    sc = ShardedCompressor(["cpu"] * 2, P)
    with telemetry.capture():
        want = sc.compress_series(series)
    sc.close()
    for i, st in enumerate(want):
        recs = [r["tele"][i] for r in ranks]
        assert all(tuple(t) == STEP_TELEMETRY_KEYS for t in recs)
        for k in ("bytes_in", "bytes_out"):
            assert sum(t[k] for t in recs) == st.meta["telemetry"][k], (i, k)
        assert {t["codec"] for t in recs} == {st.meta["telemetry"]["codec"]}
    for r in ranks:
        assert {"encode.analyze", "encode.index", "encode.exceptions",
                "encode.pack_fetch", "finalize", "finalize.exceptions",
                "finalize.entropy", "finalize.anchor",
                "shard-finalize.task"} <= set(r["spans"])


def test_series_rollup():
    series = _series()
    with telemetry.capture():
        steps = compress_series(series, P, device="cpu")
    roll = report.series_rollup(steps)
    assert roll["steps"] == len(series)
    assert roll["steps_without_telemetry"] == 0
    raw = sum(a.nbytes for a in series)
    assert series[0].nbytes <= roll["bytes_in"] <= raw
    assert 0 < roll["bytes_out"] < roll["bytes_in"]
    assert roll["entropy_ratio_mean"] > 1.0
    assert sum(roll["codecs"].values()) == len(series)
    assert all(v >= 0.0 for v in roll["totals"].values())
    roll2 = report.series_rollup(compress_series(series, P, device="cpu"))
    assert roll2["steps"] == 0
    assert roll2["steps_without_telemetry"] == len(series)


def test_rollup_structure_matches_the_reference():
    """The rollup of one series: every span the reference's driver emits
    on that path (the port adds encode.pack_fetch: its bit-pack runs on
    the device; and its own step, chain and sync spans), the same
    counters and the same aggregate fields."""
    series = _series()
    with telemetry.capture() as reg:
        compress_series(series, P, device="cpu")
    with jtelemetry.capture() as jreg:
        jcompress.compress_series(series, JParams(**KW))
    roll, jroll = report.rollup(reg), jreport.rollup(jreg)
    assert roll.keys() == jroll.keys()
    assert set(jroll["spans"]) <= set(roll["spans"])
    assert set(roll["spans"]) - set(jroll["spans"]) == {
        "encode.pack_fetch", "compress.step", "chain.advance",
        "choose_b.model", "upload.stage", "sync.range", "sync.choose_b",
        "sync.centers", "sync.exc_nonzero", "sync.exc_counts",
        "sync.exc_positions", "sync.packed", "sync.chain_centers"}
    assert roll["counters"] == jroll["counters"]
    for name, agg in roll["spans"].items():
        assert agg.keys() == {"count", "total_s", "max_s", "errors",
                              "mean_s"}
        if name in jroll["spans"]:
            assert agg["count"] == jroll["spans"][name]["count"], name
    fin = roll["spans"]["finalize"]
    assert fin["count"] == len(series) - 1
    assert fin["total_s"] >= fin["max_s"] >= fin["mean_s"] >= 0.0


# ------------------------------------ the stream step's sync spans

# The sync.* spans of one delta step on the device-rANS route with the
# chain on the device, in order: the range pass, auto-B's histogram, the
# top-k centers, the exception compaction's nonzero and two copies, the
# sampled bytes, the frequency tables' upload, the coded streams' masked
# select and three copies, the chain advance's centers: one span for each
# of the 13 calls.  The step's staged upload (upload.stage) waits for
# nothing.  sync.signed_zero and sync.raw_block depend on the data
# (test_data_dependent_sync_spans).
DELTA_SYNCS = ["sync.range", "sync.choose_b", "sync.centers",
               "sync.exc_nonzero", "sync.exc_counts", "sync.exc_positions",
               "sync.samples", "sync.freq_up", "sync.stream_select",
               "sync.stream_states", "sync.stream_words",
               "sync.stream_counts", "sync.chain_centers"]
# The encode.* spans the reference has, and encode.pack_fetch: what
# encode_ms.compress sums.  No other span may start with "encode." and
# only finalize_step's may be named "finalize".
ENCODE_SPANS = {"encode.analyze", "encode.index", "encode.exceptions",
                "encode.device_entropy", "encode.pack_fetch",
                "encode.idx_fetch"}


@pytest.fixture(scope="module")
def rans_step(tmp_path_factory):
    """One anchor, then one 2^20-element delta step large enough for
    DEVICE_MIN_BYTES on device="cpu", under telemetry and a CPU
    torch.profiler: (the step, its span records, the profiler's
    user_annotation names)."""
    from repro_torch.core.compress import TemporalCompressor
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(7)
    n = 1 << 20
    prev = (rng.normal(size=n) + 2.0).astype(np.float32)
    curr = prev * (1 + rng.normal(scale=2e-3, size=n)).astype(np.float32)
    p = NumarckParams(error_bound=1e-3, max_bins=65536,
                      block_bytes=1 << 20, codec="rans")
    comp = TemporalCompressor(p, device="cpu")
    comp.add(prev)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with telemetry.capture() as reg:
            st = comp.add(curr)
    comp.close()
    path = tmp_path_factory.mktemp("prof") / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    notes = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert st.meta["telemetry"]["device_entropy"]
    assert st.n * st.b_bits // 8 >= trans.DEVICE_MIN_BYTES
    return st, list(reg.spans), notes


def test_delta_step_records_each_sync_in_order(rans_step):
    """Every blocking call of a delta step is its own sync.* span, in the
    order the program makes them, each inside the compress.step span and
    none inside another sync.* span; the upload is one upload.stage span,
    before them."""
    _, spans, _ = rans_step
    step = [r for r in spans if r.name == "compress.step"]
    assert len(step) == 1 and step[0].depth == 0
    syncs = sorted((r for r in spans if r.name.startswith("sync.")),
                   key=lambda r: r.t0)
    assert [r.name for r in syncs] == DELTA_SYNCS
    stage = [r for r in spans if r.name == "upload.stage"]
    assert len(stage) == 1 and stage[0].depth == 1
    assert step[0].t0 <= stage[0].t0 <= stage[0].t1 <= syncs[0].t0
    for r in syncs:
        assert r.depth >= 1
        assert step[0].t0 <= r.t0 <= r.t1 <= step[0].t1
        assert not any(o is not r and o.name.startswith("sync.")
                       and o.t0 <= r.t0 and r.t1 <= o.t1 for o in syncs)
    names = {r.name for r in spans}
    assert PORT_SPANS <= names


def test_every_span_reaches_the_profiler_on_its_own(rans_step):
    """Under a torch.profiler capture each span of the step is a
    user_annotation of the same name: no span needs a switch."""
    _, spans, notes = rans_step
    assert {r.name for r in spans} <= notes


def test_no_new_span_reads_as_encode_or_finalize(rans_step):
    """encode_ms sums every span that starts with "encode." and
    finalize_ms reads the span named "finalize": in the source of the
    port and in a recorded step, only the spans those metrics were made
    for take either form."""
    import ast
    import pathlib
    import repro_torch
    root = pathlib.Path(repro_torch.__file__).parent
    seen = {}
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and node.args
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "span"
                    and isinstance(node.args[0], ast.Constant)):
                name = node.args[0].value
                seen.setdefault(name, set()).add(path.name)
    assert {n for n in seen if n.startswith("encode.")} == ENCODE_SPANS
    assert seen["finalize"] == {"pipeline.py"}
    _, spans, _ = rans_step
    names = [r.name for r in spans]
    assert {n for n in names if n.startswith("encode.")} <= ENCODE_SPANS
    assert names.count("finalize") == 1


@pytest.mark.parametrize("site", ["sync.signed_zero", "sync.raw_block"])
def test_data_dependent_sync_spans(site):
    """The two syncs that only some data make: the signed-zero pass of a
    range whose end is zero, and the copy of a block that codes larger
    than raw (inside entropy.assemble)."""
    from repro_torch.core import ratios
    with telemetry.capture() as reg:
        if site == "sync.signed_zero":
            r = torch.tensor([0.0, -0.0, 0.5], dtype=torch.float32)
            lo, hi = ratios.valid_ends(r, torch.ones(3, dtype=torch.bool))
            assert (lo, hi) == (0.0, 0.5) and np.signbit(lo)
        else:
            idx = torch.from_numpy(np.random.default_rng(3).integers(
                0, 256, 4096, dtype=np.int64).astype(np.int32))
            blobs = trans.compress_blocks_device(idx, 8, 1, 4096)
            assert trans.blob_version(blobs[0]) == 0
    recs = {r.name: r for r in reg.spans}
    assert site in recs
    if site == "sync.signed_zero":
        assert [r.name for r in reg.spans] == ["sync.range", site]
    else:
        outer = recs["entropy.assemble"]
        assert outer.t0 <= recs[site].t0 <= recs[site].t1 <= outer.t1


# -------------------------------------------------------- chrome trace

def test_chrome_trace_json_valid_with_the_reference_lanes(tmp_path):
    rng = np.random.default_rng(1)
    raws = [rng.integers(0, 8, 1 << 19, dtype=np.uint8).tobytes()
            for _ in range(8)]
    with telemetry.capture() as reg:
        compress_series(_series(), P, overlap=True, device="cpu")
        entropy.compress_blocks(raws, codec="zlib", parallel=True)
    with jtelemetry.capture() as jreg:
        jcompress.compress_series(_series(), JParams(**KW), overlap=True)
        jentropy.compress_blocks(raws, codec="zlib", parallel=True)
    path = trace.write_chrome_trace(str(tmp_path / "trace.json"), reg)
    with open(path) as f:
        doc = json.load(f)
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert xs, "no span events"
    for e in xs:
        assert {"name", "cat", "ph", "ts", "dur", "pid", "tid",
                "args"} <= set(e)
        assert e["ts"] >= 0.0 and e["dur"] >= 0.0
        json.dumps(e["args"])
    assert _lane_kinds(doc) == _lane_kinds(jtrace.chrome_trace(jreg))
    assert {"MainThread", "finalize", "entropy"} <= _lane_kinds(doc)
    counters = {e["name"] for e in doc["traceEvents"] if e["ph"] == "C"}
    assert "finalize.depth" in counters
    assert doc["otherData"]["counters"]


# ------------------------------------------------ overlap queue metrics

def test_finalize_queue_metrics():
    with telemetry.capture() as reg:
        q = FinalizeQueue(True, name="qq", max_in_flight=1)
        for _ in range(3):
            q.submit(time.sleep, 0.02, label="napping")
        q.close()
    roll = report.rollup(reg)
    assert roll["hists"]["qq.queue_wait_s"]["count"] == 3
    assert roll["gauges"]["qq.depth"]["max"] == 1.0
    assert roll["counters"]["qq.stall_s"] > 0.0
    assert roll["spans"]["qq.task"]["count"] == 3
    assert roll["spans"]["qq.flush"]["count"] >= 1


@pytest.mark.parametrize("overlap", [False, True])
def test_finalize_queue_exception_context(overlap):
    def explode(i):
        raise ValueError(f"bad step data {i}")

    q = FinalizeQueue(overlap, name="shard-finalize")
    with telemetry.capture() as reg:
        f = q.submit(explode, 7, label="finalize step 7")
        with pytest.raises(ValueError, match="^bad step data 7") as ei:
            if overlap:
                q.flush()
            else:
                f.result()
        q.close()
    assert "[shard-finalize worker: finalize step 7]" in str(ei.value)
    assert ei.value.args[0].startswith("bad step data 7")
    assert report.rollup(reg)["spans"]["shard-finalize.task"]["errors"] == 1


def test_exception_context_attached_once():
    e = ValueError("boom")
    _attach_context(e, "finalize", "finalize step 2")
    _attach_context(e, "finalize", "finalize step 2")
    assert str(e).count("[finalize worker: finalize step 2]") == 1
