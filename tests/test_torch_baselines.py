"""The port's baselines (``repro_torch.baselines``) and DP oracle against
the JAX package's NumPy ones, on the CPU.

ISABELA, ZFP and zlib: the payload bytes, every meta array and the
decompressed arrays equal the reference's, in float32 and float64, with
a short last window, NaN, +-0, values next to powers of two, duplicates,
a single element, and (ZFP) infinities and subnormals.  ZFP's integer
exponents (``_ceil_log2``, ``_floor_log2``, ``_exp2``) equal numpy's
at 2**k * (1 +- d * 2**-52) over the whole double range.  ISABELA's
permutation packing (kernel 3 over the largest multiple of 32, its
plain version over the rest) equals ``packing.pack_indices_np``.  Then
the port copies of tests/test_baselines.py (round trips, error bounds,
NUMARCK beating the baselines) and the oracle's four functions.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.baselines import isabela as jisabela  # noqa: E402
from repro.baselines import zfp_like as jzfp  # noqa: E402
from repro.baselines import zlib_lossless as jzlib  # noqa: E402
from repro.core import dp_oracle as jdp  # noqa: E402
from repro_torch.baselines import isabela, zfp_like, zlib_lossless  # noqa: E402
from repro_torch.core import dp_oracle, packing  # noqa: E402
from repro_torch.data.temporal import generate_series  # noqa: E402

CPU = "cpu"


def _next(v, steps):
    for _ in range(abs(steps)):
        v = math.nextafter(v, math.inf if steps > 0 else 0.0)
    return v


def _case(name):
    rng = np.random.default_rng(0)
    if name == "f32":
        return (rng.standard_normal(5000) * 3).astype(np.float32)
    if name == "f64_2d":
        return rng.standard_normal((7, 333))
    if name == "nan_zeros":
        x = rng.standard_normal(3000).astype(np.float32)
        x[::7] = 0.0
        x[1::11] = -0.0
        x[5::97] = np.nan
        return x
    if name == "pow2":
        x = np.array([_next(math.ldexp(1.0, k), d) for k in range(-30, 30)
                      for d in (-2, -1, 0, 1, 2)] * 3)
        rng.shuffle(x)
        return x
    if name == "dups":
        return np.repeat(rng.standard_normal(50), 40).astype(np.float32)
    if name == "single":
        return np.array([1.5])
    if name == "inf_subnormal":
        x = rng.standard_normal(1001)
        x[5], x[17], x[40] = np.inf, -np.inf, np.nan
        x[100:104] = 1e-310
        return x
    raise KeyError(name)


ISABELA_CASES = ["f32", "f64_2d", "nan_zeros", "pow2", "dups", "single"]


def _same_bytes(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(np.ascontiguousarray(a).view(np.uint8),
                                  np.ascontiguousarray(b).view(np.uint8),
                                  err_msg=what)


@pytest.mark.parametrize("window", [1024, 100])
@pytest.mark.parametrize("name", ISABELA_CASES)
def test_isabela_matches_the_reference(name, window):
    """Payload bytes, every per-window meta array and the decompressed
    array equal the reference's (window 1,024 leaves a short last window
    in every case; 100 gives several full windows and a short one)."""
    x = _case(name)
    want = jisabela.compress(x, 1e-3, window, 32)
    got = isabela.compress(x, 1e-3, window, 32, device=CPU)
    assert got.payload == want.payload
    assert (got.window, got.n, got.n_knots, got.nbytes) == (
        want.window, want.n, want.n_knots, want.nbytes)
    for k in ("knots", "perms", "corr", "exc_idx", "exc_val"):
        assert len(got.meta[k]) == len(want.meta[k]), k
        for i, (g, w) in enumerate(zip(got.meta[k], want.meta[k])):
            _same_bytes(g, w, f"{k}[{i}]")
    for k in ("n_exceptions", "exception_ratio", "error_bound", "dtype",
              "shape"):
        assert got.meta[k] == want.meta[k], k
    _same_bytes(isabela.decompress(got, device=CPU),
                jisabela.decompress(want), "decompressed")
    # the port decompresses the reference's blob, and the reverse
    _same_bytes(isabela.decompress(want, device=CPU),
                jisabela.decompress(got), "across")


@pytest.mark.parametrize("name", ISABELA_CASES + ["inf_subnormal"])
def test_zfp_matches_the_reference(name):
    """Payload bytes, the e / drop / width / tq arrays and the
    decompressed array equal the reference's, at the bench's tolerance
    (mean |x| * 1e-3) and at one that drops every plane of tiny blocks."""
    x = _case(name)
    finite = np.abs(x[np.isfinite(x)])
    for tol in (float(np.mean(finite)) * 1e-3, 10.0):
        with np.errstate(all="ignore"):
            want = jzfp.compress(x, tol)
            ref_dec = jzfp.decompress(want)
        got = zfp_like.compress(x, tol, device=CPU)
        assert got.payload == want.payload and got.n == want.n
        for k in ("e", "drop", "width", "tq"):
            _same_bytes(got.meta[k], want.meta[k], k)
        assert (got.meta["dtype"], got.meta["shape"]) == (
            want.meta["dtype"], want.meta["shape"])
        _same_bytes(zfp_like.decompress(got, device=CPU), ref_dec,
                    "decompressed")


@pytest.mark.parametrize("name", ["f32", "f64_2d", "nan_zeros"])
def test_zlib_matches_the_reference(name):
    x = _case(name)
    got, want = zlib_lossless.compress(x), jzlib.compress(x)
    assert (got.payload, got.dtype, got.shape, got.nbytes) == (
        want.payload, want.dtype, want.shape, want.nbytes)
    _same_bytes(zlib_lossless.decompress(got), jzlib.decompress(want), "x")


def test_zfp_exponents_match_numpy_next_to_powers_of_two():
    """ceil(log2) and floor(log2) as numpy rounds them (log2 to the
    nearest double first) at 2**k * (1 +- d * 2**-52), d <= 6, for every
    k from the subnormals to the largest double, and at random values;
    _exp2 equals np.exp2 at every integer from -1200 to 1200."""
    rng = np.random.default_rng(1)
    xs = np.array([_next(math.ldexp(1.0, k), d) for k in range(-1074, 1024)
                   for d in range(-6, 7)])
    xs = np.concatenate([xs, np.exp(rng.uniform(-700, 700, 20000)),
                         rng.integers(1, 2 ** 40, 20000).astype(np.float64)])
    xs = xs[(xs > 0) & np.isfinite(xs)]
    with np.errstate(all="ignore"):
        want = np.ceil(np.log2(xs)).astype(np.int32)
    got = zfp_like._ceil_log2(torch.from_numpy(xs)).numpy()
    np.testing.assert_array_equal(got, want)
    ge1 = xs[xs >= 1]
    np.testing.assert_array_equal(
        zfp_like._floor_log2(torch.from_numpy(ge1)).numpy(),
        np.floor(np.log2(ge1)).astype(np.int64))
    special = np.array([np.inf, np.nan])
    with np.errstate(all="ignore"):
        np.testing.assert_array_equal(
            zfp_like._ceil_log2(torch.from_numpy(special)).numpy(),
            special.astype(np.int32))
        np.testing.assert_array_equal(
            zfp_like._floor_log2(torch.from_numpy(special)).numpy(),
            special.astype(np.int64))
    k = np.arange(-1200, 1200)
    with np.errstate(over="ignore"):
        want = np.exp2(k.astype(np.float64))
    np.testing.assert_array_equal(
        zfp_like._exp2(torch.from_numpy(k)).numpy().view(np.int64),
        want.view(np.int64))


@pytest.mark.parametrize("bits", [1, 7, 10, 24])
@pytest.mark.parametrize("n", [0, 5, 32, 1000, 3072])
def test_permutation_packing_matches_pack_indices_np(n, bits):
    """_pack_perm (the kernel's dispatch over whole 32-element groups,
    the plain version over the tail) is pack_indices_np of the whole."""
    idx = np.random.default_rng(n + bits).integers(
        0, 1 << bits, n).astype(np.int32)
    got = isabela._pack_perm(torch.from_numpy(idx), bits)
    assert got == packing.pack_indices_np(idx, bits).tobytes()


def test_baselines_run_on_cuda_unless_asked(monkeypatch):
    """Without a GPU each entry point raises unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _case("f32")
    for fn in (lambda: isabela.compress(x),
               lambda: zfp_like.compress(x, 1e-3),
               lambda: isabela.decompress(jisabela.compress(x)),
               lambda: zfp_like.decompress(jzfp.compress(x, 1e-3))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


# -- port copies of tests/test_baselines.py ---------------------------------

@pytest.fixture(scope="module")
def field_pair():
    series = list(generate_series("asr", n_iterations=2, seed=3, scale=4))
    return series[0], series[1]


def test_zlib_roundtrip(field_pair):
    _, curr = field_pair
    blob = zlib_lossless.compress(curr)
    np.testing.assert_array_equal(zlib_lossless.decompress(blob), curr)


def test_isabela_error_bound(field_pair):
    _, curr = field_pair
    E = 1e-3
    blob = isabela.compress(curr, error_bound=E, window=256, n_knots=32,
                            device=CPU)
    rec = isabela.decompress(blob, device=CPU)
    rel = np.abs(rec - curr) / np.maximum(np.abs(curr), 1e-30)
    assert np.max(rel) <= E * (1 + 1e-6), float(np.max(rel))
    assert blob.nbytes < curr.nbytes            # actually compresses


def test_zfp_error_bound(field_pair):
    _, curr = field_pair
    tol = float(np.mean(np.abs(curr))) * 1e-3   # paper's tol convention
    blob = zfp_like.compress(curr, tol, device=CPU)
    rec = zfp_like.decompress(blob, device=CPU)
    assert np.max(np.abs(rec - curr)) <= tol * 8, (
        float(np.max(np.abs(rec - curr))), tol)
    assert blob.nbytes < curr.nbytes


def test_numarck_beats_baselines_on_temporal_data(field_pair):
    """The paper's headline claim (Figs. 9-12) on synthetic temporal data,
    every compressor the port's."""
    from repro_torch.core import NumarckParams, compress_step
    prev, curr = field_pair
    E = 1e-3
    st = compress_step(prev, curr, NumarckParams(error_bound=E), device=CPU)
    cr_numarck = st.compression_ratio()
    cr_isabela = curr.nbytes / isabela.compress(curr, E, 256, 32,
                                                device=CPU).nbytes
    tol = float(np.mean(np.abs(curr))) * E
    cr_zfp = curr.nbytes / zfp_like.compress(curr, tol, device=CPU).nbytes
    cr_zlib = curr.nbytes / zlib_lossless.compress(curr).nbytes
    assert cr_numarck > cr_isabela, (cr_numarck, cr_isabela)
    assert cr_numarck > cr_zlib, (cr_numarck, cr_zlib)
    assert cr_numarck > cr_zfp, (cr_numarck, cr_zfp)


# -- the DP oracle -----------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_dp_oracle_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    vals = np.round(rng.normal(0, 1, 60), 1)
    for width, k in ((0.2, 1), (0.3, 3), (0.5, 5), (1.0, 0)):
        assert dp_oracle.dp_max_coverage(vals, width, k) == \
            jdp.dp_max_coverage(vals, width, k)
        got, want = (dp_oracle.dp_select_bins(vals, width, k),
                     jdp.dp_select_bins(vals, width, k))
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
    small = vals[:9]
    assert dp_oracle.brute_force_max_coverage(small, 0.3, 2) == \
        jdp.brute_force_max_coverage(small, 0.3, 2)
    centers = rng.normal(0, 1, 5)
    assert dp_oracle.coverage_of_centers(vals, centers, 0.1) == \
        jdp.coverage_of_centers(vals, centers, 0.1)
