"""Four gloo ranks of ``MultiProcessCompressor`` on CPU devices, through the
device rANS route (``rans.DEVICE_MIN_BYTES`` lowered in every rank so that
small steps take it), against ``ShardedCompressor`` over four CPU shards in
one process, the benchmark's plain reference (``portbench/reference.py``)
and its rank ownership (``portbench/reference_mp.py``); the spans that the
collectives open; and the one card each spawned rank sees.

One fleet (``spawn_emulated``, ~5 s) serves every test of the module: each
rank pickles its fragments, the host coder's calls and its telemetry.
"""
import os
import pickle
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.distributed import collectives as coll  # noqa: E402
from repro_torch.distributed.pipeline import ShardedCompressor  # noqa: E402
from repro_torch.kernels import rans  # noqa: E402
from repro_torch.launch import distributed as ld  # noqa: E402
from repro_torch.obs import telemetry  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
from portbench import reference, reference_mp  # noqa: E402

RANKS, N, STEPS = 4, 30_717, 4
# block_bytes -> layout: 1 KB blocks straddle the shard boundaries (the
# edge exchange completes them); 1 MB blocks exceed a shard and shrink to
# it, one block a rank ending on the shard's edge (the last shard padded),
# as in the four-rank CMIP cell.
LAYOUTS = {"straddling": 1024, "shrunk": 1 << 20}
# Steps that each rank's host coder codes, 1 KB blocks: a host codec, and
# the device codec with its device stage off.  Not in LAYOUTS, whose tests
# hold the device route.
HOST_CODED = {"zlib": dict(codec="zlib"),
              "rans_on_host": dict(codec="rans", device_entropy=False)}
MAX_BINS = 4096
# Each rank's (lo, hi) range ends, per case: ties of -0 and +0 go to the
# lower rank's zero; an infinite end is a rank with no valid ratio.
ENDS = [
    ([0.0, -0.0, 0.0, 1.0], [0.5, -0.0, 0.5, 0.25]),
    ([-0.0, 0.0, -0.0, 2.0], [-0.0, 0.0, -1.0, -0.0]),
    ([float("inf"), -3.5, float("inf"), -3.5],
     [float("-inf"), 7.0, 7.0, float("-inf")]),
]

_WORKER = textwrap.dedent("""
    import pickle, sys
    import numpy as np
    from repro_torch.launch import distributed as ld
    cfg = ld.initialize()
    from repro_torch.core import entropy
    from repro_torch.core.types import NumarckParams
    from repro_torch.distributed.pipeline import MultiProcessCompressor
    from repro_torch.kernels import rans
    from repro_torch.obs import telemetry
    rans.DEVICE_MIN_BYTES = 0
    host = []
    real = entropy.compress_blocks

    def counted(*a, **k):
        host.append(len(a[0]))
        return real(*a, **k)

    entropy.compress_blocks = counted
    series = pickle.load(open(sys.argv[1], "rb"))
    out = {}
    for name, block_bytes in %(layouts)r.items():
        mp = MultiProcessCompressor(["cpu"], NumarckParams(
            codec="rans", block_bytes=block_bytes, max_bins=%(max_bins)d))
        host.clear()
        anchor = mp.add_fragment(series[0])
        anchor_calls = len(host)
        with telemetry.capture() as reg:
            frags = [mp.add_fragment(x) for x in series[1:]]
        mp.close()
        out[name] = dict(
            anchor_calls=anchor_calls, delta_calls=len(host) - anchor_calls,
            frags=[dict(b=f.info["B"], start=f.block_start,
                        blobs=f.index_blocks, exc=f.incomp_values,
                        centers=f.centers, nbytes=f.nbytes,
                        tele=f.meta.get("telemetry"))
                   for f in frags],
            spans=[(s.name, s.depth, dict(s.attrs)) for s in reg.spans])
    for name, kw in %(host_coded)r.items():
        mp = MultiProcessCompressor(["cpu"], NumarckParams(
            block_bytes=1024, max_bins=%(max_bins)d, **kw))
        host.clear()
        with telemetry.capture():
            frags = [mp.add_fragment(x) for x in series]
        mp.close()
        out[name] = dict(calls=len(host), frags=[
            dict(start=f.block_start, blobs=f.index_blocks,
                 codecs=f.block_codecs, exc=f.incomp_values,
                 counts=f.incomp_block_counts, centers=f.centers,
                 nbytes=f.nbytes, info=f.info, tele=f.meta["telemetry"])
            for f in frags])
    # The card path's fold and sum, carried by a gloo subgroup on CPU
    # tensors, beside the host path on the same values.
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import collectives as coll
    r, inf = cfg.process_id, float("inf")     # repr(ENDS) writes inf
    g = coll.ShardGroup(["cpu"], True)
    out["paths"] = {}
    for path in ("host", "card"):
        if path == "card":
            g.backend, g._cards = coll.NCCL, dist.new_group(backend="gloo")
        with telemetry.capture() as reg:
            ends = [coll.allreduce_minmax([lo[r]], [hi[r]], g)
                    for lo, hi in %(ends)r]
            total = coll.allreduce_sum(
                [torch.arange(%(max_bins)d, dtype=torch.int32) * (r + 1)], g)
        out["paths"][path] = dict(
            ends=[(float(lo), float(hi)) for lo, hi in ends],
            total=total, spans=[(s.name, s.depth, dict(s.attrs))
                                for s in reg.spans])
    ld.shutdown()
    with open(sys.argv[2] + ".rank%%d" %% cfg.process_id, "wb") as f:
        pickle.dump(out, f)
""") % {"layouts": LAYOUTS, "max_bins": MAX_BINS, "ends": ENDS,
       "host_coded": HOST_CODED}


def _series():
    """A seeded temporal series with jumps (exceptions) every step."""
    rng = np.random.default_rng(11)
    out = [(rng.normal(0, 1, N) + 3.0).astype(np.float32)]
    for t in range(STEPS - 1):
        nxt = (out[-1] * (1 + 0.004 * rng.standard_normal(N))
               ).astype(np.float32)
        nxt[t::97] *= 1.5
        out.append(nxt)
    return out


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """(series, each layout's per-rank results)."""
    tmp = tmp_path_factory.mktemp("mp_rans")
    series = _series()
    with open(tmp / "series.pkl", "wb") as f:
        pickle.dump(series, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("REPRO_FAULTS", None)
    res = ld.spawn_emulated(RANKS, ["-c", _WORKER, str(tmp / "series.pkl"),
                                    str(tmp / "out")],
                            base_env=env, timeout=240)
    ld.check_spawned(res)
    ranks = []
    for r in range(RANKS):
        with open(tmp / f"out.rank{r}", "rb") as f:
            ranks.append(pickle.load(f))
    return series, {name: [rk[name] for rk in ranks] for name in
                    (*LAYOUTS, *HOST_CODED, "paths")}


def _params(block_bytes):
    return repro_torch.NumarckParams(codec="rans", block_bytes=block_bytes,
                                     max_bins=MAX_BINS)


@pytest.fixture(scope="module")
def sharded(fleet):
    """ShardedCompressor over four CPU shards, device route forced."""
    series, _ = fleet
    saved, rans.DEVICE_MIN_BYTES = rans.DEVICE_MIN_BYTES, 0
    try:
        out = {}
        for name, block_bytes in LAYOUTS.items():
            sc = ShardedCompressor(["cpu"] * RANKS, _params(block_bytes))
            out[name] = sc.compress_series(series)[1:]
            sc.close()
    finally:
        rans.DEVICE_MIN_BYTES = saved
    return out


@pytest.mark.parametrize("layout", LAYOUTS)
def test_joined_fragments_equal_the_one_process_driver(fleet, sharded,
                                                       layout):
    """Each delta step's blobs and exceptions, joined in rank order, are
    ShardedCompressor's over four shards, byte for byte, and every rank
    took the device route."""
    _, ranks = fleet
    for i, want in enumerate(sharded[layout]):
        frags = [rk["frags"][i] for rk in ranks[layout]]
        assert {f["b"] for f in frags} == {want.b_bits}
        assert [b for f in frags for b in f["blobs"]] == want.index_blocks
        np.testing.assert_array_equal(
            np.concatenate([f["exc"] for f in frags]), want.incomp_values)
        np.testing.assert_array_equal(frags[0]["centers"], want.centers)
        assert all(f["tele"]["device_entropy"] for f in frags)
        assert all(f["tele"]["codec"] == "rans" for f in frags)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_joined_blobs_decode_to_the_plain_reference(fleet, layout):
    """The joined blobs of every delta step decode, by the plain reference's
    own rANS reader, to the plain reference's index table."""
    series, ranks = fleet
    pool = [torch.from_numpy(x) for x in series]
    walk = reference.follow(pool, list(range(STEPS)), error_bound=1e-3,
                            max_bins=MAX_BINS, b_max=16)
    for t, enc, curr, _ in walk:
        frags = [rk["frags"][t - 1] for rk in ranks[layout]]
        blobs = [b for f in frags for b in f["blobs"]]
        # v1 rANS blobs; v0 (stored) where a 1 KB block codes no smaller
        assert {b[4] for b in blobs} == ({1} if layout == "shrunk"
                                         else {0})
        assert frags[0]["b"] == enc["b"]
        assert reference.index_mismatch(blobs, N, enc["b"], enc["idx"]) == 0
        np.testing.assert_array_equal(
            np.concatenate([f["exc"] for f in frags]),
            curr[enc["exc"]].numpy())


@pytest.mark.parametrize("layout", LAYOUTS)
def test_each_rank_stores_the_blocks_that_start_in_its_shard(fleet, layout):
    _, ranks = fleet
    for i in range(STEPS - 1):
        b = ranks[layout][0]["frags"][i]["b"]
        want = reference_mp.owned(N, RANKS, b, LAYOUTS[layout])
        got = [(rk["frags"][i]["start"], len(rk["frags"][i]["blobs"]))
               for rk in ranks[layout]]
        assert got == want
        be = reference_mp.layout(N, RANKS, b, LAYOUTS[layout])[1]
        assert (be < reference_mp.block_elems(b, LAYOUTS[layout])) == (
            layout == "shrunk")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_no_delta_step_calls_the_host_coder(fleet, layout):
    """The host coder codes each rank's anchor blocks and nothing else."""
    _, ranks = fleet
    for rk in ranks[layout]:
        assert rk["anchor_calls"] == 1
        assert rk["delta_calls"] == 0


@pytest.mark.parametrize("case", HOST_CODED)
def test_host_coded_fragments_equal_the_one_process_driver(fleet, case):
    """Where each rank's host coder codes its blocks (a host codec, or the
    device codec with its device stage off), the joined fragments of the
    anchor and of every delta step are ShardedCompressor's over four
    shards byte for byte: blobs, per-block codecs, exceptions and their
    counts, centers, attributes and bytes; each rank calls the host coder
    once a step."""
    series, ranks = fleet
    sc = ShardedCompressor(["cpu"] * RANKS, repro_torch.NumarckParams(
        block_bytes=1024, max_bins=MAX_BINS, **HOST_CODED[case]))
    with telemetry.capture():
        want = sc.compress_series(series)
    sc.close()
    for i, st in enumerate(want):
        frags = [rk["frags"][i] for rk in ranks[case]]
        assert [b for f in frags for b in f["blobs"]] == st.index_blocks
        assert {f["info"]["codec"] for f in frags} == {st.codec}
        assert all(f["info"]["n_blocks"] == st.n_blocks for f in frags)
        assert all(f["info"]["total_data_num"] == N for f in frags)
        assert not any(f["tele"]["device_entropy"] for f in frags)
        for k in ("bytes_in", "bytes_out"):
            assert sum(f["tele"][k] for f in frags) == \
                st.meta["telemetry"][k], (i, k)
        if st.is_anchor:
            assert sum(f["nbytes"] for f in frags) == \
                st.nbytes + 8 * (RANKS - 1)
            continue
        per = [c for f in frags
               for c in (f["codecs"] or [f["info"]["codec"]]
                         * len(f["blobs"]))]
        assert per == [st.codec_for_block(b) for b in range(st.n_blocks)]
        np.testing.assert_array_equal(
            np.concatenate([f["exc"] for f in frags]), st.incomp_values)
        np.testing.assert_array_equal(
            np.concatenate([f["counts"] for f in frags]),
            np.diff(np.append(st.incomp_block_offsets,
                              st.n_incompressible)))
        np.testing.assert_array_equal(frags[0]["centers"], st.centers)
        assert all(f["centers"] is None for f in frags[1:])
        assert sum(f["nbytes"] for f in frags) == \
            st.nbytes - 16 + 8 * RANKS
    assert [rk["calls"] for rk in ranks[case]] == [len(series)] * RANKS


def _straddle(layout: str, b: int, rank: int) -> int:
    """Elements of rank ``rank``'s shard that the block straddling its left
    edge takes, by ``reference_mp``'s ownership (0: no block straddles)."""
    if rank == 0:
        return 0
    ln, be, _ = reference_mp.layout(N, RANKS, b, LAYOUTS[layout])
    return max(0, reference_mp.owned(N, RANKS, b, LAYOUTS[layout])[rank][0]
               * be - rank * ln)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("rank", range(RANKS))
def test_every_collective_is_one_span_with_its_bytes(fleet, rank, layout):
    """One coll.range, coll.hist and coll.edge span a delta step under
    encode.analyze and encode.index, inside the step's compress.step,
    with what the rank sent: the two range ends, the int64 histogram, and
    to the rank before it the part of its shard that the block straddling
    the boundary takes (none from rank 0, none where blocks end on the
    shard edges); each host staging a sync.* span inside.  A fleet of CPU ranks takes gloo throughout."""
    _, ranks = fleet
    spans = ranks[layout][rank]["spans"]
    deltas = STEPS - 1
    by = {}
    for name, depth, attrs in spans:
        by.setdefault(name, []).append((depth, attrs))
    head = _straddle(layout, ranks[layout][0]["frags"][0]["b"], rank)
    if layout == "shrunk":
        assert head == 0
    want = {"coll.range": 8, "coll.hist": MAX_BINS * 8,
            "coll.edge": head * 4}
    for name, sent in want.items():
        assert len(by[name]) == deltas, name
        for depth, attrs in by[name]:
            assert attrs == {"bytes": sent, "ranks": RANKS,
                             "backend": "gloo"}, name
            assert depth == 2, name
    assert "coll.scan" not in by
    assert len(by["sync.coll_hist"]) == deltas
    assert all(d == 3 for d, _ in by["sync.coll_hist"])
    assert len(by.get("sync.coll_edge", [])) == (deltas if head else 0)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_fragment_bytes_follow_the_joined_step(fleet, sharded, layout):
    """A fragment's ``nbytes`` counts what the shard file stores of it: over
    the ranks, the one-process step's bytes with an offset table and a
    counts table a rank in place of its two offset tables."""
    _, ranks = fleet
    for i, want in enumerate(sharded[layout]):
        got = sum(rk["frags"][i]["nbytes"] for rk in ranks[layout])
        assert got == want.nbytes - 16 + 8 * RANKS


def test_collectives_of_one_process_send_nothing():
    """In one process each collective is still one span, with no bytes
    sent and no host staging."""
    g = coll.ShardGroup(["cpu"] * 2, False)
    with telemetry.capture() as reg:
        coll.allreduce_minmax([0.5, 1.0], [2.0, 3.0], g)
        coll.allreduce_sum([torch.ones(4, dtype=torch.int32)] * 2, g)
        coll.exclusive_scan_sum([3, 4], g)
        coll.right_edge_exchange([torch.zeros(2, dtype=torch.int32)] * 2, g,
                                 torch.ones(2, dtype=torch.int32))
    assert g.backend == "gloo"
    assert [(s.name, s.attrs) for s in reg.spans] == [
        (name, {"bytes": 0, "ranks": 1, "backend": "gloo"})
        for name in ("coll.range", "coll.hist", "coll.scan", "coll.edge")]


@pytest.mark.parametrize("cards,want", [
    ([["GPU-a"], ["GPU-b"], ["GPU-c"], ["GPU-d"]], "nccl"),
    ([["GPU-a", "GPU-b"], ["GPU-c", "GPU-d"]], "nccl"),
    ([["GPU-a"], ["GPU-a"]], "gloo"),
    ([["GPU-a"], ["GPU-b"], ["GPU-a"], ["GPU-c"]], "gloo"),
    ([["GPU-a", "GPU-a"], ["GPU-b", "GPU-c"]], "gloo"),
    ([["GPU-a"], [None]], "gloo"),
    ([["GPU-a", None], ["GPU-b", "GPU-c"]], "gloo"),
    ([[None], [None], [None], [None]], "gloo"),
    ([["GPU-a"]], "gloo"),
    ([["GPU-a", "GPU-b"]], "gloo"),
], ids=["four_cards", "two_cards_a_rank", "two_ranks_one_card",
        "eight_ranks_round_robin", "one_card_twice_in_a_rank", "a_cpu_rank",
        "mixed_rank", "cpu_fleet", "one_process", "one_process_two_cards"])
def test_the_backend_follows_the_gathered_cards(cards, want):
    """NCCL only where more than one process holds only cards that no
    other shard names; gloo for CPU shards, a shared card or one
    process."""
    assert coll.collective_backend(cards) == want


def test_the_card_path_folds_and_sums_as_the_host_path(fleet):
    """The card path's gather, fold and int64 sum, carried by a gloo
    subgroup on CPU tensors, gives every rank the host path's ends (signed
    zeros of the lower rank, infinite ends where a rank has no ratio) and
    its histogram sum, and one process's fold of the same shards; its
    range span waits in sync.coll_range and its histogram stages
    nothing."""
    _, ranks = fleet
    one = coll.ShardGroup(["cpu"] * RANKS, False)
    want = [tuple(float(v) for v in coll.allreduce_minmax(lo, hi, one))
            for lo, hi in ENDS]
    total = sum(np.arange(MAX_BINS, dtype=np.int64) * (r + 1)
                for r in range(RANKS))
    for rk in ranks["paths"]:
        for path, backend in (("host", "gloo"), ("card", "nccl")):
            got = rk[path]
            assert got["ends"] == want
            assert [np.signbit(e).tolist() for e in got["ends"]] == [
                np.signbit(e).tolist() for e in want]
            assert got["total"].dtype == torch.int32
            np.testing.assert_array_equal(got["total"].numpy(), total)
            assert {a["backend"] for n, _, a in got["spans"]
                    if n.startswith("coll.")} == {backend}
        # (a span is recorded as it closes: the inner one first)
        assert [(n, d) for n, d, _ in rk["card"]["spans"]] == [
            ("sync.coll_range", 1), ("coll.range", 0)] * len(ENDS) + [
            ("coll.hist", 0)]
        assert "sync.coll_range" not in [n for n, _, _ in
                                         rk["host"]["spans"]]


@pytest.mark.parametrize("visible,rank,want", [
    ("0,1,2,3", 2, "2"), ("4,5", 3, "5"), ("GPU-a, GPU-b", 0, "GPU-a"),
    ("", 1, None)])
def test_each_rank_sees_one_card_of_the_launcher(visible, rank, want):
    env = {ld.ENV_VISIBLE_CARDS: visible}
    assert ld.rank_card(rank, env) == want
    spawned = ld._spawn_env(rank, 4, "127.0.0.1:9", env, False)
    assert spawned.get(ld.ENV_VISIBLE_CARDS) == (visible if want is None
                                                 else want)


def test_a_host_without_cards_changes_nothing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert ld.rank_card(1, {}) is None
    assert ld._spawn_env(1, 2, "h:1", {}, False) == ld.rank_env(
        1, 2, "h:1", base={}, preset=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert [ld.rank_card(r, {}) for r in range(6)] == [
        "0", "1", "2", "3", "0", "1"]
