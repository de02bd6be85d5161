"""Each CUDA kernel of the port against its plain PyTorch version, on the
card, exactly.

These tests need a CUDA device and nvcc; they skip elsewhere.  The file
imports no JAX (the machine with the card has none), so it runs there as

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The input makers here are shared with tests/test_torch_kernels.py.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import ratios  # noqa: E402
from repro_torch.data.temporal import generate_series  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.kernels import bitpack, change_ratio, dequant, hist, ops  # noqa: E402
from repro_torch.kernels import rans  # noqa: E402

LO, WIDTH, MAX_BINS = -0.128, 0.002, 2048
# Bytes (v1) or elements (v2) per block that make the coder use L lanes.
RANS_SIZES = {32: 4096, 128: 16384, 512: 131072, 1024: 1 << 20}
# Blob kind -> B: v1 codes packed B-bit bytes, v2 the indices over
# 2^B symbols (64: the fused table; 1,024: the slot->symbol table too),
# v0 is the raw store fallback of near-random bytes.
RANS_B = {"v0": 8, "v1": 4, "v2": 6, "v2wide": 10}
# Word groups (32 indices) a CTA of the bit-pack and unpack kernels takes
# as one tile (kTileGroups in src/repro_torch/csrc/bitgroup.cuh).
TILE_GROUPS = 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these "
                    "comparisons on the H100")
    return torch.device("cuda")


def _ratio_inputs(n, dtype, seed):
    """Temporal pairs with prev == 0, +-inf and NaN in curr, and (from
    n >= 100 on) ratios placed exactly on and next to bin edges."""
    rng = np.random.default_rng(seed)
    prev = rng.normal(1.0, 0.7, n).astype(dtype)
    curr = (prev * (1 + 0.02 * rng.standard_normal(n))).astype(dtype)
    if n >= 100:
        prev[:3] = 0.0
        curr[3:6] = [np.inf, -np.inf, np.nan]
        # prev = 1 makes r = curr - 1 exact; curr - 1 = LO + j*WIDTH (in
        # f32) and its neighbours sit on either side of bin edge j.
        j = rng.integers(0, MAX_BINS + 2, 30)
        edge = (np.float32(1.0) + np.float32(LO)
                + j.astype(np.float32) * np.float32(WIDTH))
        near = np.concatenate([edge, np.nextafter(edge, np.float32(0)),
                               np.nextafter(edge, np.float32(3))])
        prev[6:6 + near.size] = 1.0
        curr[6:6 + near.size] = near.astype(dtype)
    return prev, curr


def _ids(n, max_bins, seed):
    """Bin ids in [-1, max_bins), most of them in a few hot bins."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, max_bins, n)
    hot = rng.random(n) < 0.7
    ids[hot] = (rng.integers(0, 4, hot.sum()) + max_bins // 2) % max_bins
    return ids.astype(np.int32)


def _dequant_inputs(b_bits, n, dtype, seed):
    rng = np.random.default_rng(seed)
    k = (1 << b_bits) - 1
    centers = rng.uniform(-0.1, 0.1, k).astype(dtype)
    idx = rng.integers(0, k + 1, n).astype(np.int32)    # k + 1 == marker
    prev = rng.normal(1, 0.5, n).astype(dtype)
    curr = rng.normal(1, 0.5, n).astype(dtype)
    return idx, prev, curr, centers


def rans_indices(nb, be, b_bits, seed):
    """(nb, be) B-bit indices with a geometric rank distribution and the
    tail clipped to the marker, like a step's index table."""
    rng = np.random.default_rng(seed)
    marker = (1 << b_bits) - 1
    return np.minimum(rng.geometric(0.35, (nb, be)) - 1,
                      marker).astype(np.int32)


def rans_encode_inputs(kind, L, nb=3, seed=0):
    """(symbols, fused tables) of one encode launch whose blocks use L
    lanes: v1 packed bytes with a table per block, v2 indices with one
    shared table (as the drivers make them)."""
    b = RANS_B[kind]
    n = RANS_SIZES[L]
    if kind == "v1":
        be = n * 8 // b
        idx = rans_indices(nb, be, b, seed)
        byts = np.stack([packing.pack_indices_np(r, b) for r in idx])
        _, fcs = rans.tables_from_samples(
            byts[:, ::rans.sample_stride(n)])
        return byts, fcs.view(np.int32)
    idx = rans_indices(nb, n, b, seed)
    k_eff = (1 << b) - 1
    counts = np.bincount(idx.reshape(-1), minlength=k_eff + 1)
    freq = rans.symbol_freq(counts[:k_eff], k_eff, idx.size)
    return idx, rans.pack_fc(freq).view(np.int32)[None, :]


def rans_blobs(kind, L, nb=3, seed=0):
    """(blobs, B, block_elems) of nb index blocks coded with L lanes by
    the host oracle (``rans.compress`` / ``compress_symbols``)."""
    b = RANS_B[kind]
    if kind in ("v0", "v1"):
        n = RANS_SIZES[L]
        be = n * 8 // b
        if kind == "v0":
            rng = np.random.default_rng(seed)
            idx = rng.integers(0, 1 << b, (nb, be)).astype(np.int32)
        else:
            idx = rans_indices(nb, be, b, seed)
        blobs = [rans.compress(packing.pack_indices_np(r, b).tobytes())
                 for r in idx]
        return blobs, b, be
    be = RANS_SIZES[L]
    idx = rans_indices(nb, be, b, seed)
    k_eff = (1 << b) - 1
    counts = np.bincount(idx.reshape(-1), minlength=k_eff + 1)
    freq = rans.symbol_freq(counts[:k_eff], k_eff, idx.size)
    return [rans.compress_symbols(r, b, freq) for r in idx], b, be


def rans_version(kind):
    return {"v0": 0, "v1": 1}.get(kind, 2)


def corrupt_rans_blob(blob, how):
    """A v1 blob with a truncated stream, a flipped final state, or a
    frequency table that no longer sums to 4,096."""
    n, L, freq, states, stream = rans._parse_v1(blob)
    freq, states, stream = freq.copy(), states.copy(), stream.copy()
    if how == "truncated":
        stream = stream[:-3]
    elif how == "state":
        states[L // 2] ^= np.uint32(1 << 7)
    else:
        freq[5] += 1
    return rans.assemble_blob(n, freq, states, stream)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cuda_change_ratio_matches_plain(cuda, dtype):
    prev, curr = _ratio_inputs(1 << 20, dtype, seed=7)
    p, c = torch.from_numpy(prev).to(cuda), torch.from_numpy(curr).to(cuda)
    got = change_ratio.change_ratio_bins_cuda(p, c, LO, WIDTH,
                                               max_bins=MAX_BINS)
    want = change_ratio.change_ratio_bins_plain(p, c, LO, WIDTH,
                                                 max_bins=MAX_BINS)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@functools.lru_cache(maxsize=None)
def _cmip_ids(max_bins):
    """Candidate-bin ids of a CMIP-like step (the main path's domain for
    this max_bins, plain versions on the CPU)."""
    prev, curr = (torch.from_numpy(a.reshape(-1)) for a in
                  generate_series("cmip", 2, seed=0, scale=2))
    r, valid = ratios.change_ratios(prev, curr)
    lo, hi = ratios.ratio_range(r, valid)
    d_lo, width, _ = ratios.histogram_domain(lo, hi, 1e-3, max_bins)
    _, ids = change_ratio.change_ratio_bins_plain(prev, curr, d_lo, width,
                                                  max_bins=max_bins)
    return ids.numpy()


def _hist_ids(kind, n, max_bins):
    rng = np.random.default_rng(n + max_bins)
    if kind == "one_bin":
        return np.full(n, max_bins // 2, np.int32)
    if kind == "all_invalid":
        return np.full(n, -1, np.int32)
    if kind == "uniform":
        return rng.integers(-1, max_bins, n).astype(np.int32)
    if kind == "hot":
        return _ids(n, max_bins, seed=1)
    return np.resize(_cmip_ids(max_bins), n)


@pytest.mark.cuda
@pytest.mark.parametrize("bound", ["exact", "too_small", "none"])
@pytest.mark.parametrize("max_bins", [2, 1000, 65536, 100_000, 300_000,
                                      1_000_003])
@pytest.mark.parametrize("kind", ["one_bin", "all_invalid", "uniform",
                                  "hot", "cmip"])
def test_cuda_histogram_matches_plain(cuda, kind, max_bins, bound):
    """Exact for any hint: the id bound of the ids (max + 1), a bound of 1
    that leaves every id above the table, and none (the whole domain);
    at lengths around the 16-byte loads, aligned and from ids[1:]."""
    full = torch.from_numpy(_hist_ids(kind, (1 << 20) + 1, max_bins)).to(cuda)
    for n in (1, 3, 4097, 1 << 20):
        for start in (0, 1):
            ids = full[start:start + n]
            id_bound = {"exact": int(ids.max()) + 1, "too_small": 1,
                        "none": None}[bound]
            got = hist.histogram_cuda(ids, max_bins=max_bins,
                                      id_bound=id_bound)
            want = hist.histogram_plain(ids, max_bins=max_bins)
            assert torch.equal(got, want), (n, start, id_bound)


@pytest.mark.cuda
def test_cuda_histogram_plan_takes_each_route(cuda):
    """The main path's table (a few thousand bins): one block, several per
    SM; 65,536 bins: a cluster; beyond what eight blocks hold: slices."""
    ids = torch.zeros(1 << 20, dtype=torch.int32, device=cuda)
    small = hist.launch_plan(ids, max_bins=65536, id_bound=3957)
    assert small["cluster"] == 1 and small["blocks_per_sm"] > 1
    assert small["table_bins"] == 3957 and small["slices"] == 1
    wide = hist.launch_plan(ids, max_bins=65536)
    assert wide["cluster"] > 1 and wide["slices"] == 1
    assert wide["grid_x"] % wide["cluster"] == 0
    huge = hist.launch_plan(ids, max_bins=1_000_003)
    assert huge["cluster"] == 8 and huge["slices"] > 1


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [1, TILE_GROUPS - 1, TILE_GROUPS + 1,
                                    4099, 100_003])
@pytest.mark.parametrize("b_bits", range(1, 25))
def test_cuda_pack_matches_plain(cuda, b_bits, groups):
    """One word group, a tile short by one, a tile and one more (a ragged
    second tile whose B words end off a 16-byte boundary for odd B), and
    many tiles with a ragged last one."""
    rng = np.random.default_rng(1000 * b_bits + groups)
    idx = torch.from_numpy(rng.integers(0, 1 << b_bits, 32 * groups)
                           .astype(np.int32)).to(cuda)
    assert torch.equal(bitpack.pack_bits_cuda(idx, b_bits=b_bits),
                       bitpack.pack_bits_plain(idx, b_bits=b_bits))


@pytest.mark.cuda
@pytest.mark.parametrize("b_bits", [4, 8, 13, 16])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cuda_dequant_matches_plain(cuda, b_bits, dtype):
    idx, prev, curr, centers = _dequant_inputs(b_bits, 1 << 20, dtype, 9)
    t = [torch.from_numpy(a).to(cuda) for a in (idx, prev, curr, centers)]
    assert torch.equal(
        dequant.dequantize_cuda(t[0], t[1], t[3], b_bits=b_bits),
        dequant.dequantize_plain(t[0], t[1], t[3], b_bits=b_bits))
    assert torch.equal(
        dequant.chain_advance_cuda(t[0], t[1], t[2], t[3], b_bits=b_bits),
        dequant.chain_advance_plain(t[0], t[1], t[2], t[3], b_bits=b_bits))


@pytest.mark.cuda
@pytest.mark.parametrize("name,steps,scale", [("stir", 4, 4), ("sedov", 3, 2)])
def test_cuda_series_matches_cpu_and_launches_every_kernel(cuda, name, steps,
                                                          scale):
    arrays = list(generate_series(name, steps, seed=0, scale=scale))
    for k in ops.KERNELS:
        k.launches = 0
    got = repro_torch.compress_series(arrays, chain="device", device=cuda)
    # The four compress kernels once per delta step; the default zlib
    # codec runs no rANS kernel.
    assert {k.name: k.launches for k in ops.KERNELS} == dict(
        change_ratio=steps - 1, hist=steps - 1, bitpack=steps - 1,
        dequant=steps - 1, rans_encode=0, rans_decode=0, rans_unpack=0)
    want = repro_torch.compress_series(arrays, chain="device", device="cpu")
    for g, w in zip(got, want):
        fg, fw = interop.step_to_fields(g), interop.step_to_fields(w)
        for key, vw in fw.items():
            if isinstance(vw, np.ndarray):
                np.testing.assert_array_equal(fg[key], vw, err_msg=key)
            else:
                assert fg[key] == vw, key


@pytest.mark.cuda
@pytest.mark.parametrize("L", sorted(RANS_SIZES))
@pytest.mark.parametrize("kind", ["v1", "v2", "v2wide"])
def test_cuda_rans_encode_matches_plain(cuda, kind, L):
    syms, fc = (torch.from_numpy(a).to(cuda)
                for a in rans_encode_inputs(kind, L))
    got = rans.encode_cuda(syms, fc, L=L)
    want = rans.encode_plain(syms, fc, L=L)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("L", sorted(RANS_SIZES))
@pytest.mark.parametrize("kind", ["v0", "v1", "v2", "v2wide"])
def test_cuda_rans_decode_matches_plain(cuda, kind, L):
    """Decode kernel (and unpack for v0/v1) against the plain versions on
    the card, final states and pointers included, and the indices
    against the host oracle."""
    blobs, b, be = rans_blobs(kind, L)
    assert {rans.blob_version(x) for x in blobs} == {rans_version(kind)}
    if kind != "v0":
        parsed = [dict(zip(("freq", "states", "stream"),
                           (rans._parse_v1(x)[2:] if kind == "v1"
                            else rans._parse_v2(x)[3:]))) for x in blobs]
        dec, sym, states, stream, n_emit, _ = rans._upload_group(parsed,
                                                                 cuda)
        if kind == "v1":
            m = -(-(be * b // 8) // L)
            got = rans.decode_bytes_cuda(dec, states, stream, n_emit, m=m,
                                         L=L)
            want = rans.decode_bytes_plain(dec, states, stream, n_emit,
                                           m=m, L=L)
        else:
            kw = dict(m=-(-be // L), L=L, n=be, n_sym=(1 << b), b_bits=b)
            got = rans.decode_syms_cuda(dec, sym, states, stream, n_emit,
                                        **kw)
            want = rans.decode_syms_plain(dec, sym, states, stream, n_emit,
                                          **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    idx = rans.decode_blocks_device(blobs, b, be, cuda)
    oracle = np.stack([packing.unpack_indices_np(
        np.frombuffer(rans.decompress(x), np.uint8), be, b) for x in blobs])
    np.testing.assert_array_equal(idx.cpu().numpy(), oracle)


@pytest.mark.cuda
def test_cuda_rans_decodes_ragged_anchor_bytes(cuda):
    rng = np.random.default_rng(3)
    raws = [(rng.zipf(1.5, n) % 200).astype(np.uint8).tobytes()
            for n in (1 << 20, 70_001, 1 << 20, 9_000, 31)]
    raws.append(rng.integers(0, 256, 5000).astype(np.uint8).tobytes())
    blobs = [rans.compress(r) for r in raws]
    got = rans.decode_bytes_blocks_device(blobs, cuda)
    assert got.cpu().numpy().tobytes() == b"".join(raws)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 4, 8, 12])
@pytest.mark.parametrize("b_bits", range(1, 25))
def test_cuda_rans_unpack_matches_plain(cuda, b_bits, offset):
    """1..16 rows (the grid's row axis) of 5 word groups (less than a
    tile), of 2 tiles and 37 groups and of 1,001 groups (ragged last
    tiles), the first row ``offset`` bytes past a 16-byte boundary and
    each row 4 or 4 * (B % 3) bytes longer than its packed words, so that
    rows start at every 4-byte offset mod 16: each row unpacks to its own
    indices, as the plain version does."""
    rng = np.random.default_rng(100 * b_bits + offset)
    for be, pad in ((32 * 5, 4), (32 * (2 * TILE_GROUPS + 37), 4),
                    (32 * 1001, 4 * (b_bits % 3))):
        row = be * b_bits // 8 + pad
        for nb in range(1, 17):
            idx = rng.integers(0, 1 << b_bits, (nb, be)).astype(np.int32)
            flat = rng.integers(0, 256, offset + nb * row).astype(np.uint8)
            rows = flat[offset:].reshape(nb, row)
            for r in range(nb):
                rows[r, :row - pad] = packing.pack_indices_np(idx[r], b_bits)
            byts = torch.from_numpy(flat).to(cuda)[offset:].view(nb, row)
            assert byts.data_ptr() % 16 == offset
            got = rans.unpack_cuda(byts, b_bits=b_bits, be=be)
            assert torch.equal(got.cpu(), torch.from_numpy(idx)), (be, nb)
            assert torch.equal(got, rans.unpack_plain(byts, b_bits=b_bits,
                                                      be=be)), (be, nb)


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["truncated", "state", "table"])
def test_cuda_rans_corrupt_blobs_raise(cuda, how):
    blobs, b, be = rans_blobs("v1", 128)
    blobs[1] = corrupt_rans_blob(blobs[1], how)
    msg = ("corrupt rANS table" if how == "table"
           else "stream not consumed cleanly")
    for dev in (cuda, "cpu"):
        with pytest.raises(ValueError, match=msg):
            rans.decode_blocks_device(blobs, b, be, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("symbol_rans", [False, True])
@pytest.mark.parametrize("name,steps,scale", [("stir", 4, 4), ("sedov", 3, 2)])
def test_cuda_rans_series_matches_cpu(cuda, monkeypatch, name, steps, scale,
                                      symbol_rans):
    """codec="rans" through the device entropy stage and the device read
    path: steps byte-identical to device="cpu", reconstructions bit-
    identical, each kernel launched once per delta step."""
    monkeypatch.setattr(rans, "DEVICE_MIN_BYTES", 0)
    arrays = list(generate_series(name, steps, seed=0, scale=scale))
    params = repro_torch.NumarckParams(codec="rans", symbol_rans=symbol_rans)
    for k in ops.KERNELS:
        k.launches = 0
    got = repro_torch.compress_series(arrays, params, chain="device",
                                      device=cuda)
    assert rans.ENCODE.launches == steps - 1
    assert bitpack.KERNEL.launches == (0 if symbol_rans else steps - 1)
    want = repro_torch.compress_series(arrays, params, chain="device",
                                       device="cpu")
    for g, w in zip(got, want):
        assert [bytes(x) for x in g.index_blocks] == \
            [bytes(x) for x in w.index_blocks]
        np.testing.assert_array_equal(g.incomp_values, w.incomp_values)
    for k in ops.KERNELS:
        k.launches = 0
    recon = repro_torch.decompress_series(got, device=cuda)
    assert dequant.KERNEL.launches == steps - 1
    assert rans.DECODE.launches >= steps - 1
    for a, r in zip(recon, repro_torch.decompress_series(want,
                                                         device="cpu")):
        assert a.dtype == r.dtype
        np.testing.assert_array_equal(a, r)


def dense_symbol_blobs(nb=3, be=1 << 20, seed=0):
    """v2 blobs of uniform 12-bit symbols: every frequency is 1, so each
    decode step takes 12 bits and about three of every four steps of every
    lane read a word (the densest stream 12-bit frequencies allow).  The
    blobs are assembled without the store fallback, which would win."""
    b = 12
    idx = np.random.default_rng(seed).integers(0, 1 << b, (nb, be))
    freq = rans.symbol_freq(np.ones((1 << b) - 1), (1 << b) - 1, idx.size)
    assert (freq == 1).all()
    blobs = []
    for r in idx:
        states, stream = rans.encode_np(r, freq)
        blobs.append(rans.assemble_symbol_blob(be, b, freq, states, stream))
    return blobs, b, be


def ring_case(kind):
    """(decode function pair, positional args on the CPU, keywords) of one
    decode launch whose streams exercise the ring of the decode kernel."""
    if kind == "dense":
        blobs, b, be = dense_symbol_blobs()
    elif kind == "empty":
        blobs = [rans.compress(bytes(4096))] * 2    # n_emit = 0
        b, be = 8, 4096
    else:    # "short" and "odd_S": streams below one 2,048-word stage
        blobs, b, be = rans_blobs("v1", 32)
    v1 = rans.blob_version(blobs[0]) == 1
    parsed = [dict(zip(("freq", "states", "stream"),
                       rans._parse_v1(x)[2:] if v1 else rans._parse_v2(x)[3:]))
              for x in blobs]
    dec, sym, states, stream, n_emit = rans._batch_group(parsed)
    if kind == "odd_S":
        # Rows of an odd length start at every 2-byte offset mod 16: the
        # kernel reads their unaligned head and tail with plain loads.
        S = int(n_emit.max()) + 3
        stream = np.zeros((len(parsed), S), np.uint16)
        for i, p in enumerate(parsed):
            stream[i, :p["stream"].size] = p["stream"]
    L = parsed[0]["states"].size
    t = torch.from_numpy
    args = [t(dec.view(np.int32)), t(states.view(np.int32)),
            t(stream.view(np.int16)), t(n_emit)]
    if v1:
        return ((rans.decode_bytes_cuda, rans.decode_bytes_plain), args,
                dict(m=-(-(be * b // 8) // L), L=L), n_emit)
    args.insert(1, None if sym is None else t(sym))
    return ((rans.decode_syms_cuda, rans.decode_syms_plain), args,
            dict(m=-(-be // L), L=L, n=be, n_sym=parsed[0]["freq"].size,
                 b_bits=b), n_emit)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "short", "odd_S", "empty"])
def test_cuda_rans_decode_ring_streams(cuda, kind):
    """Streams that cross hundreds of ring stages (dense), that fit in one
    stage, that are empty, and rows of an odd length S: the decode kernel
    against its plain version, final states and pointers included."""
    (fn_c, fn_p), args, kw, n_emit = ring_case(kind)
    if kind == "odd_S":
        assert args[2].shape[1] % 8
    if kind == "dense":
        assert n_emit.min() > 100 * 2048
    dev_args = [None if a is None else a.to(cuda) for a in args]
    got = fn_c(*dev_args, **kw)
    want = fn_p(*dev_args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    rans._checked(got[1], got[2], n_emit)


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["cut_to_a_tenth", "extra_words"])
def test_cuda_rans_decode_reads_past_n_emit(cuda, how):
    """A stream cut far short (the decode reads past n_emit, which gives 0)
    and one with words the decode never reaches (copies still in flight
    when it ends): the kernel equals the plain version and the device
    route raises the reference's message."""
    blobs, b, be = rans_blobs("v1", 1024, nb=2)
    n, L, freq, states, stream = rans._parse_v1(blobs[1])
    if how == "cut_to_a_tenth":
        stream = stream[:stream.size // 10]
    else:
        stream = np.concatenate([stream, np.arange(9000, dtype=np.uint16)])
    blobs[1] = rans.assemble_blob(n, freq, states, stream)
    parsed = [dict(zip(("freq", "states", "stream"), rans._parse_v1(x)[2:]))
              for x in blobs]
    dec, _, st, sm, ne, ne_np = rans._upload_group(parsed, cuda)
    kw = dict(m=-(-n // L), L=L)
    got = rans.decode_bytes_cuda(dec, st, sm, ne, **kw)
    for g, w in zip(got, rans.decode_bytes_plain(dec, st, sm, ne, **kw)):
        assert torch.equal(g, w)
    for dev in (cuda, "cpu"):
        with pytest.raises(ValueError,
                           match="stream not consumed cleanly"):
            rans.decode_blocks_device(blobs, b, be, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("L", sorted(RANS_SIZES))
@pytest.mark.parametrize("kind", ["v1", "v2wide"])
def test_cuda_rans_encode_every_block_count(cuda, kind, L):
    """The encode at the planner's lanes per CTA for L, for 1..16 blocks
    of a ragged length (n not a multiple of L): block k of every launch
    equals block k of the plain version."""
    syms, fc = rans_encode_inputs(kind, L, nb=16, seed=L)
    n = syms.shape[1] - 13
    syms = torch.from_numpy(np.ascontiguousarray(syms[:, :n])).to(cuda)
    fc = torch.from_numpy(fc).to(cuda)
    want = rans.encode_plain(syms, fc, L=L)
    m = -(-n // L)
    for nb in range(1, 17):
        lc = rans.encode_lanes_per_cta(nb, L)
        assert L // lc >= (2 if L > 32 else 1)
        got = rans.encode_cuda(syms[:nb].contiguous(),
                               fc[:nb] if fc.shape[0] > 1 else fc, L=L)
        for g, w in zip(got, want):
            assert torch.equal(g, w[:nb]), (nb, lc, m)


@pytest.mark.cuda
def test_cuda_rans_divide_matches_floor_division(cuda):
    """The encode's reciprocal division against // for every frequency
    1..4095: x = k*f - 1 and k*f at both ends of the reachable range
    (x < f * 2^20), x = f * 2^20 - 1, random x below f * 2^20, and (the
    mul-hi is exact for every u32) x = 2^32 - 1 and random u32 x."""
    rng = np.random.default_rng(0)
    f = np.arange(1, 4096, dtype=np.int64)
    top = f << 20
    ks = np.array([1, 2, 3, (1 << 20) - 2, (1 << 20) - 1], np.int64)
    kf = np.tile(f, ks.size)
    kx = np.repeat(ks, f.size) * kf
    xs = [(kx, kf), (kx - 1, kf), (top - 1, f), (0 * f, f)]
    xs += [((rng.random(f.size) * top).astype(np.int64), f)
           for _ in range(64)]
    xs += [(np.full_like(f, (1 << 32) - 1), f),
           (rng.integers(0, 1 << 32, f.size), f)]
    x = np.concatenate([a for a, _ in xs])
    ff = np.concatenate([b for _, b in xs])
    assert (x >= 0).all() and (x < 1 << 32).all()
    q, r = rans.divide_cuda(
        *(torch.from_numpy(a.astype(np.uint32).view(np.int32)).to(cuda)
          for a in (x, ff)))
    np.testing.assert_array_equal(q.cpu().numpy().view(np.uint32), x // ff)
    np.testing.assert_array_equal(r.cpu().numpy().view(np.uint32), x % ff)


# --------------------------------------------------------------------------
# The equal-width, log-scale and k-means strategies and the sharded driver.
# --------------------------------------------------------------------------

def _same_steps(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        fg, fw = interop.step_to_fields(g), interop.step_to_fields(w)
        for k, v in fw.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(fg[k], v, err_msg=k)
            else:
                assert fg[k] == v, k


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["equal", "log", "kmeans"])
@pytest.mark.parametrize("name,steps,scale", [("stir", 4, 4), ("sedov", 3, 2)])
def test_cuda_strategy_series_matches_cpu(cuda, name, steps, scale,
                                          strategy):
    """Each strategy through compress_series on the card: steps equal to
    device="cpu", kernels 1-4 once per delta step."""
    arrays = list(generate_series(name, steps, seed=0, scale=scale))
    params = repro_torch.NumarckParams(strategy=strategy)
    for k in ops.KERNELS:
        k.launches = 0
    got = repro_torch.compress_series(arrays, params, device=cuda)
    for k in (change_ratio.KERNEL, hist.KERNEL, bitpack.KERNEL,
              dequant.KERNEL):
        assert k.launches == steps - 1, k.name
    _same_steps(got, repro_torch.compress_series(arrays, params,
                                                 device="cpu"))


@pytest.mark.cuda
def test_cuda_assign_nearest_and_log_range_match_cpu(cuda):
    """The element-wise strategy stages on the card, NaN and invalid
    ratios included: exact."""
    from repro_torch.core import binning

    rng = np.random.default_rng(0)
    r = (rng.standard_normal(100_003) * 0.02).astype(np.float32)
    r[:3] = [np.nan, 0.0, 1e-13]
    valid = rng.random(r.size) > 0.05
    cs = np.sort(rng.normal(0, 0.02, 255)).astype(np.float32)
    args = [torch.from_numpy(x) for x in (r, valid, cs)]
    got = binning.assign_nearest(*[a.to(cuda) for a in args], 1e-3)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  binning.assign_nearest(*args, 1e-3).numpy())
    assert binning.log_range(args[0].to(cuda), args[1].to(cuda)) == \
        binning.log_range(args[0], args[1])


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["zlib", "rans"])
def test_cuda_sharded_matches_cpu(cuda, monkeypatch, codec):
    """ShardedCompressor over four shards on the one card against the same
    driver on CPU shards, each kernel once per shard and delta step; the
    ShardedDecompressor on the card reads back bit-identically."""
    from repro_torch.distributed.pipeline import (ShardedCompressor,
                                                  ShardedDecompressor)

    monkeypatch.setattr(rans, "DEVICE_MIN_BYTES", 0)
    arrays = list(generate_series("stir", 4, seed=0, scale=4))
    params = repro_torch.NumarckParams(codec=codec, block_bytes=1024)
    for k in ops.KERNELS:
        k.launches = 0
    sc = ShardedCompressor([cuda] * 4, params)
    got = sc.compress_series(arrays)
    sc.close()
    for k in (change_ratio.KERNEL, hist.KERNEL, bitpack.KERNEL,
              dequant.KERNEL):
        assert k.launches == 4 * 3, k.name
    assert rans.ENCODE.launches == (12 if codec == "rans" else 0)
    cpu = ShardedCompressor(["cpu"] * 4, params)
    _same_steps(got, cpu.compress_series(arrays))
    cpu.close()
    recon = ShardedDecompressor([cuda] * 4).decompress_series(got)
    for a, b in zip(recon, repro_torch.decompress_series(got,
                                                         device="cpu")):
        np.testing.assert_array_equal(a, b)


def _serve_models(cuda):
    """The reduced llama3.2-1b (float32) on the CPU and the same weights
    on the card."""
    import copy

    from repro_torch.models.model import build

    model = build("llama3.2-1b", smoke=True)
    cpu = model.init(0, device="cpu")
    return model, cpu, copy.deepcopy(cpu).to(cuda)


@pytest.mark.cuda
def test_cuda_model_matches_cpu(cuda):
    """Prefill and eight decode steps on the card against the CPU: logits
    within 1e-3 (float32 matmuls in full float32 on both; the sums run
    in other orders)."""
    from repro_torch.models import lm

    model, cpu, card = _serve_models(cuda)
    cfg = model.cfg
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 18)))
    got = lm.prefill(card, cfg, toks[:, :10].to(cuda), s_max=18)
    want = lm.prefill(cpu, cfg, toks[:, :10], s_max=18)
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(),
                               rtol=1e-3, atol=1e-3)
    gc, wc, pos = got[1], want[1], want[2]
    for i in range(10, 18):
        gl, gc = lm.decode_step(card, cfg, gc, toks[:, i:i + 1].to(cuda),
                                pos.to(cuda))
        wl, wc = lm.decode_step(cpu, cfg, wc, toks[:, i:i + 1], pos)
        np.testing.assert_allclose(gl.cpu().numpy(), wl.numpy(),
                                   rtol=1e-3, atol=1e-3)
        pos = pos + 1


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["zlib", "rans"])
def test_cuda_engine_matches_cpu(cuda, tmp_path, monkeypatch, codec):
    """The engine on the card gives the CPU engine's greedy tokens, and a
    session saved on the card resumes on the CPU (and the reverse) to
    the same tokens; with rans every leaf inflates through the decode
    kernel (DEVICE_MIN_BYTES = 0)."""
    from repro_torch.serve.engine import Engine

    monkeypatch.setattr(rans, "DEVICE_MIN_BYTES", 0)
    model, cpu, card = _serve_models(cuda)
    p = np.random.default_rng(1).integers(0, model.cfg.vocab_size,
                                          (2, 10)).astype(np.int32)
    e_card = Engine(model, card, 2, 32, keep_session=True, device=cuda)
    e_cpu = Engine(model, cpu, 2, 32, keep_session=True, device="cpu")
    np.testing.assert_array_equal(e_card.generate(p, max_new=6),
                                  e_cpu.generate(p, max_new=6))
    path = str(tmp_path / "card.nck")
    e_card.save_session(path, codec=codec)
    rest = e_card.resume(max_new=6)
    e_cpu.load_session(path)
    np.testing.assert_array_equal(e_cpu.resume(max_new=6), rest)
    e_cpu.save_session(path, codec=codec)
    r = repro_torch.NCKReader(path)
    steps = [r.read_step(v) for v in r.step_names()]
    want = sum(len({tuple(rans._parse_v1(b)[:2]) for b in st.index_blocks
                    if rans.blob_version(b) == 1}) for st in steps)
    assert (want > 0) == (codec == "rans")
    rans.DECODE.launches = 0
    e_card.load_session(path)
    assert rans.DECODE.launches == want
    assert e_card.last_cache["attn"]["k"].is_cuda
    np.testing.assert_array_equal(e_card.resume(max_new=4),
                                  e_cpu.resume(max_new=4))


def grad_tensor(kind: str, seed: int = 0) -> torch.Tensor:
    """Gradient-like tensors for the compression round trip."""
    rng = np.random.default_rng(seed)
    if kind == "gaussian":
        return torch.from_numpy(rng.normal(0, 1e-2, (257, 1031))
                                .astype(np.float32))
    if kind == "clustered":
        return torch.from_numpy(np.concatenate(
            [np.zeros(30000), rng.normal(1e-2, 1e-4, 10000),
             rng.normal(-1e-2, 1e-4, 10000)]).astype(np.float32))
    if kind == "bf16":
        return torch.from_numpy(rng.normal(0, 1e-3, (64, 4096))
                                .astype(np.float32)).to(torch.bfloat16)
    if kind == "constant":
        return torch.full((4099,), 0.125)
    return torch.zeros(1 << 16)


def int_bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("b_bits", [4, 6])
@pytest.mark.parametrize("kind", ["gaussian", "clustered", "bf16",
                                  "constant", "zero"])
def test_cuda_quantize_dequantize_matches_cpu(cuda, kind, b_bits):
    """Gradient compression on the card gives the CPU path's g_hat bit for
    bit, through one histogram kernel launch; alpha within 1e-6 (a
    float32 mean summed in another order)."""
    from repro_torch.train import gradcomp

    g = grad_tensor(kind, b_bits)
    want, winfo = gradcomp.quantize_dequantize(g, b_bits=b_bits)
    hist.KERNEL.launches = 0
    got, ginfo = gradcomp.quantize_dequantize(g.to(cuda), b_bits=b_bits)
    torch.cuda.synchronize()
    assert hist.KERNEL.launches == 1
    assert got.dtype == g.dtype and got.device.type == cuda.type
    assert torch.equal(int_bits(got.cpu()), int_bits(want))
    np.testing.assert_allclose(float(ginfo["alpha"]), float(winfo["alpha"]),
                               rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [0, 6])
def test_cuda_train_step_matches_cpu(cuda, bits):
    """The reduced llama3.2-1b (float32) trained on the card and on the
    CPU from the same state: the first step's loss within 1e-5 and its
    parameters within two learning rates (Adam's first step is
    g / (|g| + eps): a gradient near zero whose sign differs between the
    two sums moves its weight by up to 2 lr, any other by ulps), and
    three steps' losses within 1e-5; the histogram kernel once per leaf
    per step with compression, and no kernel without."""
    from repro_torch import interop
    from repro_torch.core.tree import leaves_with_keys
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models.model import build
    from repro_torch.train import optim
    from repro_torch.train.trainer import Trainer, TrainerConfig

    model = build("llama3.2-1b", smoke=True)
    tcfg = TrainerConfig(opt=optim.AdamWConfig(lr=1e-3, warmup_steps=1),
                         grad_compression_bits=bits)
    cpu_tr = Trainer(model, tcfg, device="cpu")
    card_tr = Trainer(model, tcfg, device=cuda)
    cpu = cpu_tr.init_state(0)
    card = interop.train_state_from_reference(
        interop.train_state_to_reference(cpu), model.cfg, device=cuda)
    pipe = TokenPipeline(model.cfg.vocab_size, 33, 4)
    batches = [pipe.batch(s) for s in range(3)]
    n_leaves = len(list(leaves_with_keys(card.params)))
    cpu, _, want = cpu_tr.fit(cpu, iter(batches[:1]), log=lambda *_: None)
    for k in ops.KERNELS:
        k.launches = 0
    card, _, got = card_tr.fit(card, iter(batches[:1]), log=lambda *_: None)
    torch.cuda.synchronize()
    assert hist.KERNEL.launches == (n_leaves if bits else 0)
    assert sum(k.launches for k in ops.KERNELS) == hist.KERNEL.launches
    np.testing.assert_allclose(got, want, rtol=1e-5)
    lr = float(optim.schedule(tcfg.opt, torch.tensor(1)))
    got_p = dict(leaves_with_keys(interop.train_state_to_reference(card)))
    for k, w in leaves_with_keys(interop.train_state_to_reference(cpu)):
        if k.startswith("params/"):
            assert np.abs(got_p[k] - w).max() <= 2 * lr * 1.001, k
    _, _, want = cpu_tr.fit(cpu, iter(batches[1:]), start_step=1,
                            log=lambda *_: None)
    _, _, got = card_tr.fit(card, iter(batches[1:]), start_step=1,
                            log=lambda *_: None)
    np.testing.assert_allclose(got, want, rtol=1e-5)


# -- the MLA and MoE families -------------------------------------------

def _family_models(cuda, arch):
    """A reduced arch (float32) on the CPU and the same weights on the
    card."""
    import copy

    from repro_torch.models.model import build

    model = build(arch, smoke=True)
    cpu = model.init(0, device="cpu")
    return model, cpu, copy.deepcopy(cpu).to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["minicpm3-4b", "mixtral-8x7b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_cuda_mla_moe_models_match_cpu(cuda, arch):
    """Prefill (logits and the cache: MLA's ckv and krope) and eight
    decode steps on the card against the CPU, logits within 1e-3; for
    MLA also the card's absorbed decode against its expanded
    mla_decode_naive from the same cache."""
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    model, cpu, card = _family_models(cuda, arch)
    cfg = model.cfg
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 18)))
    got = lm.prefill(card, cfg, toks[:, :10].to(cuda), s_max=18)
    want = lm.prefill(cpu, cfg, toks[:, :10], s_max=18)
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(),
                               rtol=1e-3, atol=1e-3)
    for k, w in want[1]["attn"].items():
        g = got[1]["attn"][k]
        assert g.is_cuda and g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_allclose(g.cpu().float().numpy(),
                                   w.float().numpy(), rtol=1e-3, atol=1e-3)
    gc, wc, pos = got[1], want[1], want[2]
    for i in range(10, 18):
        tok = toks[:, i:i + 1]
        if cfg.attn_kind == "mla" and i == 10:
            naive = {"attn": {k: v.clone() for k, v in gc["attn"].items()}}
            absorbed = L.mla_decode
            L.mla_decode = L.mla_decode_naive
            try:
                nl, _ = lm.decode_step(card, cfg, naive, tok.to(cuda),
                                       pos.to(cuda))
            finally:
                L.mla_decode = absorbed
        gl, gc = lm.decode_step(card, cfg, gc, tok.to(cuda), pos.to(cuda))
        wl, wc = lm.decode_step(cpu, cfg, wc, tok, pos)
        np.testing.assert_allclose(gl.cpu().numpy(), wl.numpy(),
                                   rtol=1e-3, atol=1e-3)
        if cfg.attn_kind == "mla" and i == 10:
            np.testing.assert_allclose(nl.cpu().numpy(), gl.cpu().numpy(),
                                       rtol=1e-3, atol=1e-3)
        pos = pos + 1


@pytest.mark.cuda
@pytest.mark.parametrize("split,cf", [(1, 2.0), (2, 2.0), (2, 0.5)])
def test_cuda_moe_routing_matches_cpu(cuda, split, cf):
    """moe_apply on the card: the routing (slot_e, pos, keep) equal to the
    CPU's, with drops at cf 0.5, and the output and aux within 1e-4."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import layers as L

    cfg = dataclasses.replace(get_smoke_config("mixtral-8x7b"),
                              moe_ep_split=split, capacity_factor=cf)
    gen = torch.Generator().manual_seed(split)
    moe = L.MoE(cfg)
    L.moe_init(moe, gen)
    card = L.MoE(cfg, cuda)
    card.load_state_dict(moe.state_dict())
    x = torch.randn((2, 16, cfg.d_model), generator=gen) * 0.5
    want = L.moe_route(moe, x, cfg)
    got = L.moe_route(card, x.to(cuda), cfg)
    for i in (2, 4, 5):
        assert torch.equal(got[i].cpu(), want[i]), i
    assert bool(want[5].all()) == (cf == 2.0)
    (y, aux), (wy, waux) = L.moe_apply(card, x.to(cuda), cfg=cfg), \
        L.moe_apply(moe, x, cfg=cfg)
    np.testing.assert_allclose(y.cpu().numpy(), wy.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 32, 4, 24), (1, 8, 64, 64),
                                   (2, 64, 40)],
                         ids=["wq_b", "we_down", "wkv_a"])
def test_cuda_quantize_dequantize_stacked_leaves(cuda, shape):
    """3-D and 4-D stacked leaves (MLA projections, slot-wise expert
    stacks) through quantize_dequantize on the card: the CPU path's
    g_hat bit for bit, one histogram launch."""
    from repro_torch.train import gradcomp

    g = torch.from_numpy(np.random.default_rng(len(shape)).normal(
        0, 1e-3, shape).astype(np.float32))
    want, _ = gradcomp.quantize_dequantize(g, b_bits=6)
    hist.KERNEL.launches = 0
    got, _ = gradcomp.quantize_dequantize(g.to(cuda), b_bits=6)
    torch.cuda.synchronize()
    assert hist.KERNEL.launches == 1 and got.shape == g.shape
    assert torch.equal(int_bits(got.cpu()), int_bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["minicpm3-4b", "mixtral-8x7b"])
def test_cuda_family_engine_sessions_match_cpu(cuda, tmp_path, monkeypatch,
                                               arch):
    """The engine on the card gives the CPU engine's greedy tokens for
    MLA and MoE; a rans session saved on the card resumes on the CPU,
    and its load on the card inflates every leaf through the decode
    kernel (DEVICE_MIN_BYTES = 0), MLA's ckv and krope among them."""
    from repro_torch.serve.engine import Engine

    monkeypatch.setattr(rans, "DEVICE_MIN_BYTES", 0)
    model, cpu, card = _family_models(cuda, arch)
    p = np.random.default_rng(1).integers(0, model.cfg.vocab_size,
                                          (2, 10)).astype(np.int32)
    e_card = Engine(model, card, 2, 32, keep_session=True, device=cuda)
    e_cpu = Engine(model, cpu, 2, 32, keep_session=True, device="cpu")
    np.testing.assert_array_equal(e_card.generate(p, max_new=6),
                                  e_cpu.generate(p, max_new=6))
    path = str(tmp_path / "card.nck")
    e_card.save_session(path, codec="rans")
    rest = e_card.resume(max_new=6)
    e_cpu.load_session(path)
    np.testing.assert_array_equal(e_cpu.resume(max_new=6), rest)
    r = repro_torch.NCKReader(path)
    steps = [r.read_step(v) for v in r.step_names()]
    want = sum(len({tuple(rans._parse_v1(b)[:2]) for b in st.index_blocks
                    if rans.blob_version(b) == 1}) for st in steps)
    rans.DECODE.launches = 0
    e_card.load_session(path)
    assert rans.DECODE.launches == want > 0
    keys = ("ckv", "krope") if model.cfg.attn_kind == "mla" else ("k", "v")
    assert all(e_card.last_cache["attn"][k].is_cuda for k in keys)


# -- the SSM and hybrid families ----------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b"])
def test_cuda_ssm_hybrid_models_match_cpu(cuda, arch):
    """forward, prefill (every cache leaf: the SSD's float32 conv and h,
    hymba's per-layer attention beside them, its 40-token prompt past
    the 32-token window) and eight decode steps on the card against the
    CPU within 1e-3; then one train step's loss and gradients (every
    leaf within 1e-3 of its largest magnitude)."""
    from repro_torch.core.tree import leaves_with_keys
    from repro_torch.models import lm
    from repro_torch.train.trainer import Trainer, loss_and_grads

    model, cpu, card = _family_models(cuda, arch)
    cfg = model.cfg
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 48)))
    got, _ = lm.forward(card, cfg, toks[:, :40].to(cuda))
    want, _ = lm.forward(cpu, cfg, toks[:, :40])
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-3,
                               atol=1e-3)
    got = lm.prefill(card, cfg, toks[:, :40].to(cuda), s_max=48)
    want = lm.prefill(cpu, cfg, toks[:, :40], s_max=48)
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(),
                               rtol=1e-3, atol=1e-3)
    gl = dict(leaves_with_keys(got[1]))
    for k, w in leaves_with_keys(want[1]):
        g = gl[k]
        assert g.is_cuda and g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_allclose(g.cpu().float().numpy(),
                                   w.float().numpy(), rtol=1e-3, atol=1e-3)
    assert any(k.endswith("ssm/h") for k in gl)
    gc, wc, pos = got[1], want[1], want[2]
    for i in range(40, 48):
        tok = toks[:, i:i + 1]
        g_log, gc = lm.decode_step(card, cfg, gc, tok.to(cuda), pos.to(cuda))
        w_log, wc = lm.decode_step(cpu, cfg, wc, tok, pos)
        np.testing.assert_allclose(g_log.cpu().numpy(), w_log.numpy(),
                                   rtol=1e-3, atol=1e-3)
        pos = pos + 1

    state = Trainer(model, device="cpu").init_state(0)
    card_state = interop.train_state_from_reference(
        interop.train_state_to_reference(state), cfg, device=cuda)
    batch = model.sample_batch(torch.Generator().manual_seed(0), 2, 33)
    wl, _, wg = loss_and_grads(model, state.params, batch)
    gl, _, gg = loss_and_grads(model, card_state.params,
                               {k: v.to(cuda) for k, v in batch.items()})
    np.testing.assert_allclose(float(gl), float(wl), rtol=1e-4)
    got = dict(leaves_with_keys(gg))
    for k, w in leaves_with_keys(wg):
        g = got[k]
        assert g.is_cuda and bool(torch.isfinite(g).all()), k
        w = w.float().numpy()
        np.testing.assert_allclose(g.cpu().float().numpy(), w, rtol=1e-3,
                                   atol=1e-3 * np.abs(w).max(), err_msg=k)


# -- the frontend families and the baselines -----------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["paligemma-3b", "musicgen-medium"])
def test_cuda_frontend_models_match_cpu(cuda, arch):
    """The frontends on the card against the CPU within 1e-3: paligemma's
    prefix-LM mask (8 patch embeds ahead of the text; a token-only prompt
    shorter than the prefix too) in forward and prefill, then decode
    steps through decode_step(token=) (the scaled token path) or, for
    musicgen, decode_step(embed=) of seeded frames; then one train
    step's loss on a sample batch."""
    from repro_torch.models import lm
    from repro_torch.train.trainer import Trainer, loss_and_grads

    model, cpu, card = _family_models(cuda, arch)
    cfg = model.cfg
    rng = np.random.default_rng(0)
    frames = cfg.frontend == "frames"
    emb = torch.from_numpy(rng.standard_normal(
        (2, 20 if frames else cfg.n_prefix, cfg.d_model)).astype(np.float32))
    toks = None if frames else torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 12)))

    def on(t, dev):
        return None if t is None else t.to(dev)

    def close(g, w):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-3,
                                   atol=1e-3)

    close(lm.forward(card, cfg, on(toks, cuda), on(emb, cuda))[0],
          lm.forward(cpu, cfg, toks, emb)[0])
    if not frames:
        short = toks[:, :5]             # shorter than n_prefix: all prefix
        close(lm.forward(card, cfg, short.to(cuda))[0],
              lm.forward(cpu, cfg, short)[0])
    got = lm.prefill(card, cfg, on(toks, cuda), on(emb, cuda), s_max=40)
    want = lm.prefill(cpu, cfg, toks, emb, s_max=40)
    close(got[0], want[0])
    gc, wc, pos = got[1], want[1], want[2]
    for i in range(6):
        if frames:
            e = torch.from_numpy(rng.standard_normal(
                (2, 1, cfg.d_model)).astype(np.float32))
            g_log, gc = lm.decode_step(card, cfg, gc, pos=pos.to(cuda),
                                       embed=e.to(cuda))
            w_log, wc = lm.decode_step(cpu, cfg, wc, pos=pos, embed=e)
        else:
            t = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1)))
            g_log, gc = lm.decode_step(card, cfg, gc, token=t.to(cuda),
                                       pos=pos.to(cuda))
            w_log, wc = lm.decode_step(cpu, cfg, wc, token=t, pos=pos)
        close(g_log, w_log)
        pos = pos + 1

    state = Trainer(model, device="cpu").init_state(0)
    card_state = interop.train_state_from_reference(
        interop.train_state_to_reference(state), cfg, device=cuda)
    batch = model.sample_batch(torch.Generator().manual_seed(0), 2, 24)
    wl, _, _ = loss_and_grads(model, state.params, batch)
    gl, _, _ = loss_and_grads(model, card_state.params,
                              {k: v.to(cuda) for k, v in batch.items()})
    np.testing.assert_allclose(float(gl), float(wl), rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3072, 5000])
def test_cuda_isabela_packs_permutations_with_kernel_3(cuda, n):
    """ISABELA's permutation packing on the card: the bit-pack kernel
    once over the whole 32-element groups (B = 10), the plain version
    over the tail, the bytes pack_indices_np's; then the whole compress
    (one kernel launch) and decompress against device="cpu" byte for
    byte, and ZFP's too (no kernel)."""
    from repro_torch.baselines import isabela, zfp_like

    idx = np.random.default_rng(n).integers(0, 1024, n).astype(np.int32)
    bitpack.KERNEL.launches = 0
    got = isabela._pack_perm(torch.from_numpy(idx).to(cuda), 10)
    assert bitpack.KERNEL.launches == 1
    assert got == packing.pack_indices_np(idx, 10).tobytes()

    x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    x[::13] = 0.0
    x[::97] = np.nan
    bitpack.KERNEL.launches = 0
    blob = isabela.compress(x, 1e-3, 1024, 32, device=cuda)
    assert bitpack.KERNEL.launches == 1
    want = isabela.compress(x, 1e-3, 1024, 32, device="cpu")
    assert blob.payload == want.payload
    np.testing.assert_array_equal(
        isabela.decompress(blob, device=cuda).view(np.uint8),
        isabela.decompress(want, device="cpu").view(np.uint8))
    tol = float(np.nanmean(np.abs(x))) * 1e-3
    zb = zfp_like.compress(x, tol, device=cuda)
    zw = zfp_like.compress(x, tol, device="cpu")
    assert zb.payload == zw.payload
    np.testing.assert_array_equal(
        zfp_like.decompress(zb, device=cuda).view(np.uint8),
        zfp_like.decompress(zw, device="cpu").view(np.uint8))


@pytest.mark.cuda
def test_cuda_zfp_exponents_match_the_cpu(cuda):
    """ZFP's integer exponents (ceil and floor of log2 as numpy rounds
    them) on the card equal the CPU's next to every power of two, where
    a device log2 could differ by an ulp."""
    import math

    from repro_torch.baselines import zfp_like

    xs = []
    for k in range(-1074, 1024):
        v = math.ldexp(1.0, k)
        lo, hi = v, v
        for _ in range(4):
            lo, hi = math.nextafter(lo, 0.0), math.nextafter(hi, math.inf)
            xs += [lo, hi]
        xs.append(v)
    xs = torch.tensor([x for x in xs if 0 < x < math.inf],
                      dtype=torch.float64)
    assert torch.equal(zfp_like._ceil_log2(xs.to(cuda)).cpu(),
                       zfp_like._ceil_log2(xs))
    ge1 = xs[xs >= 1]
    assert torch.equal(zfp_like._floor_log2(ge1.to(cuda)).cpu(),
                       zfp_like._floor_log2(ge1))


@pytest.mark.cuda
def test_cuda_restore_elastic_onto_a_one_rank_mesh(cuda, tmp_path):
    """A checkpoint of the reduced llama3.2-1b (an anchor and a lossy
    delta) restored by restore_elastic onto the (1, 1) ("data", "model")
    CUDA mesh of this process: each leaf a DTensor on the card with the
    parameter rules' placements, its full tensor bit-equal to
    restore_latest's."""
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.elastic import restore_elastic
    from repro_torch.core.tree import leaves_with_keys, map_with_keys
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import distributed as ld
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import param_tree
    from repro_torch.models.model import build

    model = build("llama3.2-1b", smoke=True)
    tree = param_tree(model.init(0, device=cuda))
    mgr = CheckpointManager(str(tmp_path), device=cuda)
    mgr.save(0, {"params": tree})
    mgr.save(1, {"params": map_with_keys(lambda _, t: t * 1.01, tree)})
    mgr.wait()
    template = {"params": model.shape_params()}
    want = CheckpointManager(str(tmp_path), device=cuda).restore_latest(
        template=template)[1]
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    try:
        step, got = restore_elastic(CheckpointManager(str(tmp_path),
                                                      device=cuda),
                                    template, model.cfg, mesh)
        ns = dict(leaves_with_keys(shd.named_shardings(want, model.cfg,
                                                       mesh)))
        assert step == 1
        sharded = 0
        for key, leaf in leaves_with_keys(got):
            assert isinstance(leaf, DTensor)
            assert leaf.to_local().device.type == "cuda"
            assert tuple(leaf.placements) == ns[key].placements
            sharded += any(p.is_shard() for p in leaf.placements)
            assert torch.equal(leaf.full_tensor(),
                               dict(leaves_with_keys(want))[key])
        assert sharded > 0
    finally:
        ld.shutdown()


@pytest.mark.cuda
def test_cuda_every_sync_of_a_delta_step_is_a_sync_span(cuda):
    """Under ``torch.cuda.set_sync_debug_mode("warn")`` every call of a
    CMIP-shaped delta step (device rANS, chain on the card) that makes the
    host wait on the card warns while the innermost open telemetry span is
    a ``sync.*`` span, and every sync span holds exactly one such wait,
    so the count of sync spans is the count of waits.  The stage ``_sync``
    calls that only telemetry makes are not program syncs and are told
    apart by their frame."""
    import collections
    import sys
    import warnings

    from repro_torch.core import compress
    from repro_torch.core.types import NumarckParams
    from repro_torch.obs import telemetry

    series = list(generate_series("cmip", n_iterations=5, seed=11))
    params = NumarckParams(error_bound=1e-3, max_bins=65536, b_max=16,
                           block_bytes=1 << 20, codec="rans")
    comp = compress.TemporalCompressor(params, device=cuda)
    comp.add(series[0])
    comp.add(series[1])                     # builds and warms the kernels
    torch.cuda.synchronize()
    stage_code = compress._sync.__code__
    waits = []                  # ((innermost span, its t0), stage sync)

    def hook(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        frame, stage = sys._getframe(), False
        while frame is not None and not stage:
            stage = frame.f_code is stage_code
            frame = frame.f_back
        stack = telemetry.active()._stack()
        inner = (stack[-1].name, stack[-1].t0) if stack else (None, None)
        waits.append((inner, stage))

    with telemetry.capture() as reg, warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            steps = [comp.add(a) for a in series[2:]]
        finally:
            torch.cuda.set_sync_debug_mode(0)
    comp.close()
    assert all(st.meta["telemetry"]["device_entropy"] for st in steps)
    program = [inner for inner, stage in waits if not stage]
    assert program, "the sync debug mode reported nothing"
    outside = sorted({str(n) for n, _ in program
                      if n is None or not n.startswith("sync.")})
    assert not outside, f"waits outside a sync.* span: {outside}"
    recorded = sorted((r.name, r.t0) for r in reg.spans
                      if r.name.startswith("sync."))
    assert sorted(program) == recorded, (
        sorted(collections.Counter(n for n, _ in program).items()),
        sorted(collections.Counter(n for n, _ in recorded).items()))
    # The staged upload waits nowhere: 13 waits a step, none an upload.
    assert len(program) == 13 * len(steps)
    assert "sync.upload" not in {n for n, _ in recorded}
    assert sum(r.name == "upload.stage" for r in reg.spans) == len(steps)


CMIP_PARAMS = dict(error_bound=1e-3, max_bins=65536, b_max=16,
                   block_bytes=1 << 20, codec="rans")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["cmip", "stir"])
def test_cuda_staged_upload_matches_torch_tensor(cuda, shape):
    """The staged upload of a CMIP- and a Stir-shaped step gives the
    tensor of ``torch.tensor(arr, device=cuda)`` bit for bit, with its
    copy still queued behind a busy stream when the next upload stages and
    the caller has overwritten both arrays: a staging block is not reused
    under its copy."""
    from repro_torch.core import compress

    shape = {"cmip": (42, 360, 240), "stir": (64, 157, 157)}[shape]
    rng = np.random.default_rng(2)
    a, b = (rng.standard_normal(shape).astype(np.float32) for _ in "ab")
    want = [torch.tensor(x, device=cuda) for x in (a, b)]
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)          # ~50 ms of a busy stream
    got = []
    for x in (a, b):
        got.append(compress._upload(x, cuda))
        x[...] = np.nan
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
def test_cuda_overlap_steps_equal_serial_steps(cuda):
    """Ten CMIP-shaped steps with the finalize overlapped give the serial
    compressor's steps byte for byte: a step stages while the one before
    is in flight."""
    from repro_torch.core import compress
    from repro_torch.core.types import NumarckParams

    series = list(generate_series("cmip", n_iterations=10, seed=4))
    params = NumarckParams(**CMIP_PARAMS)
    serial = compress.compress_series(series, params, device=cuda)
    overlapped = compress.compress_series(series, params, overlap=True,
                                          device=cuda)
    assert len(serial) == 10
    _same_steps(overlapped, serial)


_MP4_WORKER = """
import pickle, sys
import torch
from repro_torch.launch import distributed as ld
cfg = ld.initialize()
from repro_torch.core.types import NumarckParams
from repro_torch.data.temporal import generate_series
from repro_torch.distributed.pipeline import MultiProcessCompressor
from repro_torch.kernels import rans
rans.DEVICE_MIN_BYTES = 0
series = list(generate_series("cmip", 4, seed=2, scale=2))
mp = MultiProcessCompressor(["cuda"], NumarckParams(codec="rans"))
frags = mp.compress_series_fragments(series)
mp.close()
out = dict(cards=torch.cuda.device_count(),
           uuid=str(torch.cuda.get_device_properties(0).uuid),
           launches=rans.ENCODE.launches,
           frags=[(f.block_start, f.index_blocks, f.incomp_values, f.centers)
                  for f in frags[1:]])
ld.shutdown()
with open(sys.argv[1] + ".rank%d" % cfg.process_id, "wb") as f:
    pickle.dump(out, f)
"""


@pytest.mark.cuda
def test_cuda_four_ranks_on_four_cards_match_one_card(cuda, tmp_path,
                                                      monkeypatch):
    """Four gloo ranks, one card each (the launcher's CUDA_VISIBLE_DEVICES),
    through the device rANS route: their fragments joined in rank order
    equal ShardedCompressor over four shards of one card, byte for byte,
    and each rank launched the rANS encode once a delta step on a card of
    its own."""
    import os
    import pickle

    from repro_torch.data.temporal import generate_series
    from repro_torch.distributed.pipeline import ShardedCompressor
    from repro_torch.launch import distributed as ld

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    from repro_torch.kernels import _build
    _build.build()
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src)
    env.pop("REPRO_FAULTS", None)
    out = str(tmp_path / "out")
    ld.check_spawned(ld.spawn_emulated(4, ["-c", _MP4_WORKER, out],
                                       base_env=env, timeout=600))
    ranks = []
    for r in range(4):
        with open(f"{out}.rank{r}", "rb") as f:
            ranks.append(pickle.load(f))
    assert [rk["cards"] for rk in ranks] == [1] * 4
    assert len({rk["uuid"] for rk in ranks}) == 4
    monkeypatch.setattr(rans, "DEVICE_MIN_BYTES", 0)
    series = list(generate_series("cmip", 4, seed=2, scale=2))
    sc = ShardedCompressor([cuda] * 4, repro_torch.NumarckParams(
        codec="rans"))
    want = sc.compress_series(series)[1:]
    sc.close()
    for i, st in enumerate(want):
        frags = [rk["frags"][i] for rk in ranks]
        assert [b for f in frags for b in f[1]] == st.index_blocks
        np.testing.assert_array_equal(np.concatenate([f[2] for f in frags]),
                                      st.incomp_values)
        np.testing.assert_array_equal(frags[0][3], st.centers)
    assert [rk["launches"] for rk in ranks] == [len(want)] * 4
