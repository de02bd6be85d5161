"""The port's rANS coder against the JAX package's, on the CPU.

The host part (tables, the NumPy coder, blob formats v0/v1/v2) must give
the reference's bytes; the plain PyTorch versions of the encode and
decode kernels must give the states, values, masks, symbols and pointers
of the reference's ``lax.scan`` bodies; corrupt blobs must raise the
reference's exception with its message on every route.  The input makers
are shared with tests/test_torch_cuda.py, which holds the kernels against
these plain versions on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import entropy as jentropy  # noqa: E402
from repro.kernels import rans as jrans  # noqa: E402
from repro_torch.core import entropy as tentropy  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.kernels import rans  # noqa: E402
from test_torch_cuda import (RANS_B, corrupt_rans_blob, rans_blobs,  # noqa: E402
                             rans_encode_inputs, rans_indices)

SIZES = (0, 1, 31, 32, 33, 8 << 10, 64 << 10)   # around L = 32 and its steps


def _payload(kind, n):
    rng = np.random.default_rng(n + len(kind))
    if kind == "skewed":
        return (rng.zipf(1.6, n) % 251).astype(np.uint8)
    if kind == "uniform":
        return rng.integers(0, 256, n).astype(np.uint8)
    return np.full(n, 7, np.uint8)


def test_every_reference_codec_is_registered_in_the_port():
    assert sorted(jentropy._REGISTRY) == sorted(tentropy._REGISTRY)
    for name, jc in jentropy._REGISTRY.items():
        tc = tentropy.get_codec(name)
        # The port has no process pool for codecs that hold the GIL.
        assert tc.device == jc.device and not jc.holds_gil, name


@pytest.mark.parametrize("n", [0, 1, 8191, 8192, 65535, 65536, 262143,
                               262144, 524287, 524288, 1 << 22])
def test_lanes_and_stride_match_reference(n):
    assert rans.lanes_for(n) == jrans.lanes_for(n)
    assert rans.sample_stride(n) == jrans.sample_stride(n)


@pytest.mark.parametrize("alphabet,kind", [(256, "zero"), (256, "skewed"),
                                           (3, "skewed"), (64, "uniform"),
                                           (1024, "skewed"), (4096, "uniform"),
                                           (4095, "zero")])
def test_tables_match_reference(alphabet, kind):
    rng = np.random.default_rng(alphabet)
    counts = {"zero": np.zeros(alphabet, np.int64),
              "uniform": rng.integers(0, 50, alphabet),
              "skewed": rng.zipf(1.3, alphabet) % 100_000}[kind]
    freq = rans.freq_from_counts(counts)
    np.testing.assert_array_equal(freq, jrans.freq_from_counts(counts))
    assert freq.dtype == np.uint16 and int(freq.sum()) == rans.M
    np.testing.assert_array_equal(rans.pack_fc(freq), jrans.pack_fc(freq))
    (d, s), (jd, js) = rans._decode_tables(freq), jrans._decode_tables(freq)
    np.testing.assert_array_equal(d, jd)
    assert (s is None) == (js is None) == (alphabet <= 256)
    if s is not None:
        np.testing.assert_array_equal(s, js)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", ["skewed", "uniform", "constant"])
def test_compress_matches_reference_and_decodes_both_ways(kind, n):
    raw = _payload(kind, n).tobytes()
    blob = rans.compress(raw)
    assert blob == jrans.compress(raw)
    if n >= 8 << 10:
        assert rans.blob_version(blob) == (0 if kind == "uniform" else 1)
    assert rans.decompress(blob) == raw
    assert jrans.decompress(blob) == raw


@pytest.mark.parametrize("b_bits", [3, 6, 10])
def test_compress_symbols_matches_reference(b_bits):
    idx = rans_indices(1, 40_000, b_bits, seed=b_bits)[0]
    k_eff = (1 << b_bits) - 1
    counts = np.bincount(idx, minlength=k_eff + 1)[:k_eff]
    freq = rans.symbol_freq(counts, k_eff, idx.size)
    np.testing.assert_array_equal(freq,
                                  jrans.symbol_freq(counts, k_eff, idx.size))
    blob = rans.compress_symbols(idx, b_bits, freq)
    assert blob == jrans.compress_symbols(idx, b_bits, freq)
    assert rans.blob_version(blob) == 2
    packed = packing.pack_indices_np(idx, b_bits).tobytes()
    assert rans.decompress(blob) == jrans.decompress(blob) == packed


@pytest.mark.parametrize("L", [32, 128, 512])
@pytest.mark.parametrize("kind", ["v1", "v2", "v2wide"])
def test_plain_encode_matches_encode_bytes_body(kind, L):
    syms, fc = rans_encode_inputs(kind, L, nb=2)
    states, vals, masks = rans.encode_plain(torch.from_numpy(syms),
                                            torch.from_numpy(fc), L=L)
    jfc = np.broadcast_to(fc.view(np.uint32), (syms.shape[0], fc.shape[1]))
    jst, jvals, jmasks = jrans.encode_bytes_body(
        jnp.asarray(syms), jnp.asarray(jfc), L, alphabet=fc.shape[1])
    np.testing.assert_array_equal(states.numpy().view(np.uint32),
                                  np.asarray(jst))
    np.testing.assert_array_equal(vals.numpy().view(np.uint16),
                                  np.asarray(jvals))
    np.testing.assert_array_equal(masks.numpy(), np.asarray(jmasks))


@pytest.mark.parametrize("L", [32, 128, 512])
@pytest.mark.parametrize("kind", ["v1", "v2", "v2wide"])
def test_plain_decode_matches_decode_scan_body(kind, L):
    blobs, b, be = rans_blobs(kind, L, nb=2)
    parse = rans._parse_v1 if kind == "v1" else rans._parse_v2
    skip = 2 if kind == "v1" else 3
    parsed = [dict(zip(("freq", "states", "stream"), parse(x)[skip:]))
              for x in blobs]
    dec, sym, states, stream, n_emit = rans._batch_group(parsed)
    n = be * b // 8 if kind == "v1" else be
    m = -(-n // L)
    jsyms, jxf, jptr = jrans.decode_scan_body(
        jnp.asarray(dec), None if sym is None else jnp.asarray(sym),
        jnp.asarray(states), jnp.asarray(stream), m, L)
    args = (torch.from_numpy(dec.view(np.int32)),
            torch.from_numpy(states.view(np.int32)),
            torch.from_numpy(stream.view(np.int16)), torch.from_numpy(n_emit))
    if kind == "v1":
        out, xf, ptr = rans.decode_bytes_plain(*args, m=m, L=L)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jsyms))
    else:
        out, xf, ptr = rans.decode_syms_plain(
            args[0], None if sym is None else torch.from_numpy(sym),
            *args[1:], m=m, L=L, n=be, n_sym=1 << b, b_bits=b)
        want = np.asarray(jsyms)[:, :be]
        want = np.where(want >= (1 << b) - 1, (1 << b) - 1, want)
        np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(xf.numpy().view(np.uint32),
                                  np.asarray(jxf))
    np.testing.assert_array_equal(ptr.numpy(), np.asarray(jptr))
    np.testing.assert_array_equal(ptr.numpy(), n_emit)


@pytest.mark.parametrize("b_bits", range(1, 25))
def test_unpack_plain_matches_jax_unpack_words(b_bits):
    """The plain unpack, which the unpack kernel is held to on the card,
    against the reference's ``unpack_words`` at every B: 3 rows of 37
    word groups (not a multiple of 4) from rows padded past be * B / 8
    bytes."""
    rng = np.random.default_rng(b_bits)
    nb, be = 3, 32 * 37
    nbytes = be * b_bits // 8
    byts = rng.integers(0, 256, (nb, nbytes + 4 * (1 + b_bits % 3)),
                        dtype=np.uint8)
    words = byts[:, :nbytes].copy().view("<u4")
    want = np.asarray(jrans.unpack_words(jnp.asarray(words), b_bits, be))
    got = rans.unpack_plain(torch.from_numpy(byts), b_bits=b_bits, be=be)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["v0", "v1", "v2", "v2wide"])
def test_device_decode_route_matches_reference(kind):
    """``decode_blocks_device`` on CPU tensors (the plain versions)
    against the reference's device decode, blocks of every version."""
    blobs, b, be = rans_blobs(kind, 128)
    got = rans.decode_blocks_device(blobs, b, be, "cpu")
    want = np.asarray(jrans.decode_blocks_device(blobs, b, be))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_device_encode_stage_matches_host_oracle_and_reference():
    """The device entropy stage on CPU tensors equals ``compress`` /
    ``compress_symbols`` and the reference's device stage, v0 fallback
    included (the last block holds uniform indices)."""
    b, be = RANS_B["v1"], 1 << 15
    idx = rans_indices(3, be, b, seed=5)
    idx[2] = np.random.default_rng(2).integers(0, 1 << b, be)
    flat = idx.reshape(-1)
    got = rans.compress_blocks_device(torch.from_numpy(flat), b, 3, be)
    want = [rans.compress(packing.pack_indices_np(r, b).tobytes())
            for r in idx]
    assert got == want
    assert got == jrans.compress_blocks_device(jnp.asarray(flat), b, 3, be)
    assert [rans.blob_version(x) for x in got] == [1, 1, 0]
    k_eff = (1 << b) - 1
    counts = np.bincount(flat, minlength=k_eff + 1)[:k_eff]
    got = rans.compress_blocks_device_symbols(torch.from_numpy(flat), b,
                                              k_eff, 3, be, counts)
    freq = rans.symbol_freq(counts, k_eff, flat.size)
    assert got == [rans.compress_symbols(r, b, freq) for r in idx]
    assert got == jrans.compress_blocks_device_symbols(
        jnp.asarray(flat), b, k_eff, 3, be, counts)


@pytest.mark.parametrize("route", ["host", "device"])
@pytest.mark.parametrize("how", ["truncated", "state", "table"])
def test_corrupt_blob_raises_like_reference(how, route):
    blobs, b, be = rans_blobs("v1", 128)
    blobs[1] = corrupt_rans_blob(blobs[1], how)
    if route == "host":
        calls = (lambda: rans.decompress(blobs[1]),
                 lambda: jrans.decompress(blobs[1]))
    else:
        calls = (lambda: rans.decode_blocks_device(blobs, b, be, "cpu"),
                 lambda: jrans.decode_blocks_device(blobs, b, be))
    errs = []
    for call in calls:
        with pytest.raises(Exception) as e:
            call()
        errs.append(e.value)
    assert type(errs[0]) is type(errs[1]) is ValueError
    assert str(errs[0]) == str(errs[1])
    assert str(errs[0]).startswith("corrupt rANS")


@pytest.mark.parametrize("L", [32, 128, 512, 1024])
def test_encode_lanes_per_cta_plan(L):
    """The encode's lanes per CTA, for every lane count of the format and
    1..132 blocks: whole warps that divide L, at most 256 (the kernel's
    launch bound), and more than one CTA per block wherever a block has
    more than one warp."""
    for nb in range(1, 133):
        lc = rans.encode_lanes_per_cta(nb, L)
        assert lc % 32 == 0 and L % lc == 0 and 32 <= lc <= 256, (nb, lc)
        assert L // lc >= (2 if L > 32 else 1), (nb, lc)


@pytest.mark.parametrize("L", [32, 128])
@pytest.mark.parametrize("kind", ["v1", "v2", "v2wide"])
def test_padded_stream_group_decodes_like_unpadded(kind, L):
    """``_batch_group`` pads the stream rows to a multiple of 8 words for
    the decode kernel's bulk copies; the plain decode and
    ``_check_decoded`` see the same as with rows of the longest stream's
    length, and the symbols are the host oracle's."""
    blobs, b, be = rans_blobs(kind, L, nb=3, seed=L)
    parse = rans._parse_v1 if kind == "v1" else rans._parse_v2
    skip = 2 if kind == "v1" else 3
    parsed = [dict(zip(("freq", "states", "stream"), parse(x)[skip:]))
              for x in blobs]
    dec, sym, states, stream, n_emit = rans._batch_group(parsed)
    assert stream.shape[1] % 8 == 0
    assert not stream[:, int(n_emit.max()):].any()
    tight = stream[:, :int(n_emit.max())].copy()
    n = be * b // 8 if kind == "v1" else be
    m = -(-n // L)
    outs = []
    for rows in (stream, tight):
        args = [torch.from_numpy(dec.view(np.int32)),
                torch.from_numpy(states.view(np.int32)),
                torch.from_numpy(rows.view(np.int16)),
                torch.from_numpy(n_emit)]
        if kind == "v1":
            out = rans.decode_bytes_plain(*args, m=m, L=L)
        else:
            out = rans.decode_syms_plain(
                args[0], None if sym is None else torch.from_numpy(sym),
                *args[1:], m=m, L=L, n=be, n_sym=parsed[0]["freq"].size,
                b_bits=b)
        rans._check_decoded(out[1].numpy().view(np.uint32), out[2].numpy(),
                            n_emit)
        outs.append(out)
    for g, w in zip(*outs):
        assert torch.equal(g, w)
    if kind == "v1":
        want = [rans.decompress(x) for x in blobs]
        assert [bytes(r[:be * b // 8].numpy()) for r in outs[0][0]] == want
