"""The port's encode stage against the JAX package's, exactly.

``repro_torch.core.compress.encode_device`` on the CPU (the kernels' plain
versions) against ``repro.core.compress.encode_device``: index table,
centers, auto-B and its size estimates, histogram domain and the
compacted exceptions.
"""
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import compress as jcompress  # noqa: E402
from repro.core.types import NumarckParams as JParams  # noqa: E402
from repro_torch.core import compress as tcompress  # noqa: E402
from repro_torch.core.types import NumarckParams as TParams  # noqa: E402


def _temporal(n, dtype, seed):
    rng = np.random.default_rng(seed)
    prev = rng.normal(2.0, 0.7, n).astype(dtype)
    prev[rng.random(n) < 0.01] = 0.0
    change = 1 + 0.004 * rng.standard_normal(n)
    jumps = rng.random(n) < 0.01
    change[jumps] = 1 + rng.standard_normal(jumps.sum())
    return prev, (prev * change).astype(dtype)


def _tied(n, dtype, seed):
    """600 candidate bins with four ratios each: every count ties, so the
    stable sort's order decides which bins survive the k cut."""
    rng = np.random.default_rng(seed)
    prev = np.ones(n, dtype)
    r = (np.arange(600) * 0.002 + 0.0005).repeat(4)
    curr = np.concatenate([1 + r, 1 + rng.normal(0, 0.3, n - r.size)])
    return prev, rng.permutation(curr).astype(dtype)


def _wide(n, dtype, seed):
    """Ratios spanning more than max_bins * 2E: the zero-centred domain."""
    prev, curr = _temporal(n, dtype, seed)
    curr[:10] = prev[:10] * 6.0
    return prev, curr


CASES = {
    "f32": (_temporal, np.float32, {}),
    "f64": (_temporal, np.float64, {}),
    "tied_auto_b": (_tied, np.float32, {}),
    "tied_b8": (_tied, np.float32, {"b_bits": 8}),
    "wide_domain": (_wide, np.float32, {"max_bins": 1024}),
    "wide_domain_f64": (_wide, np.float64, {"max_bins": 1000}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_encode_device_matches_jax(case):
    make, dtype, kw = CASES[case]
    prev, curr = make(20_000, dtype, seed=len(case))
    want = jcompress.encode_device(prev, curr, JParams(**kw),
                                   need_host_idx=True)
    got = tcompress.encode_device(prev, curr, TParams(**kw),
                                  need_host_idx=True, device="cpu")
    if case.startswith("wide"):
        coverage = np.float32(got.width) * np.float32(kw["max_bins"])
        assert got.domain_lo == np.float32(-0.5) * coverage
    np.testing.assert_array_equal(got.enc.idx, want.enc.idx)
    assert got.enc.b_bits == want.enc.b_bits
    assert got.enc.block_elems == want.enc.block_elems
    np.testing.assert_array_equal(got.centers, want.centers)
    assert got.domain_lo == want.domain_lo and got.width == want.width
    assert got.meta == want.meta            # b_auto, est_sizes, ratio range
    np.testing.assert_array_equal(got.enc.exc_positions,
                                  want.enc.exc_positions)
    np.testing.assert_array_equal(got.enc.exc_block_counts,
                                  want.enc.exc_block_counts)


# --------------------------------------------------------------------------
# The equal-width, log-scale and k-means strategies.
# --------------------------------------------------------------------------

STRATEGIES = ("equal", "log", "kmeans")


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_strategy_encode_matches_jax(case, strategy):
    """The strategy's centers, index table, meta and exceptions, exactly."""
    make, dtype, kw = CASES[case]
    prev, curr = make(20_000, dtype, seed=len(case) + 3)
    kw = dict(kw, strategy=strategy)
    want = jcompress.encode_device(prev, curr, JParams(**kw),
                                   need_host_idx=True)
    got = tcompress.encode_device(prev, curr, TParams(**kw),
                                  need_host_idx=True, device="cpu")
    assert got.enc.b_bits == want.enc.b_bits == 8
    np.testing.assert_array_equal(got.centers, want.centers)
    np.testing.assert_array_equal(got.enc.idx, want.enc.idx)
    assert got.meta == want.meta
    np.testing.assert_array_equal(got.enc.exc_positions,
                                  want.enc.exc_positions)
    np.testing.assert_array_equal(got.enc.exc_block_counts,
                                  want.enc.exc_block_counts)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("b_bits", [1, 2, 3, 5, 11])
def test_strategy_b_bits_and_flat_steps_match_jax(strategy, b_bits):
    """Explicit B (k = 1, 3, 7, 31, 2047 centers; k-means capped at
    kmeans_max_k), and a step with no change at all (every ratio 0)."""
    prev, curr = _temporal(6_000, np.float32, seed=b_bits)
    for c in (curr, prev.copy()):
        kw = dict(strategy=strategy, b_bits=b_bits, kmeans_max_k=100)
        want = jcompress.encode_device(prev, c, JParams(**kw),
                                       need_host_idx=True)
        got = tcompress.encode_device(prev, c, TParams(**kw),
                                      need_host_idx=True, device="cpu")
        np.testing.assert_array_equal(got.centers, want.centers)
        np.testing.assert_array_equal(got.enc.idx, want.enc.idx)


def _ratios(n, seed):
    """Ratios with NaN, invalid entries and values on both sides of 0."""
    rng = np.random.default_rng(seed)
    r = (rng.standard_normal(n) * 0.01 * rng.choice([1, 30], n)
         ).astype(np.float32)
    valid = rng.random(n) > 0.05
    r[:4] = [np.nan, 0.0, 1e-13, -2e-12]
    valid[:4] = [True, True, True, True]
    return r, valid


@pytest.mark.parametrize("seed", range(4))
def test_binning_functions_match_jax(seed):
    """equal_width_centers, kmeans_centers and assign_nearest against
    repro.core.binning on seeded inputs, NaN and invalid ratios included:
    exact."""
    import jax.numpy as jnp
    from repro.core import binning as jb
    from repro_torch.core import binning as tb

    rng = np.random.default_rng(seed)
    lo, hi = np.sort(rng.normal(0, 0.05, 2)).astype(np.float32)
    for k in (1, 7, 255, 4095):
        np.testing.assert_array_equal(
            tb.equal_width_centers(lo, hi, k),
            np.asarray(jb.equal_width_centers(lo, hi, k)))
    counts = rng.multinomial(200_000, rng.dirichlet(np.full(4096, 0.2))
                             ).astype(np.int32)
    d_lo, width = np.float32(-4.096e-3 * (seed + 1)), np.float32(2e-3)
    for k in (3, 255):
        np.testing.assert_array_equal(
            tb.kmeans_centers(counts, d_lo, width, k),
            np.asarray(jb.kmeans_centers(jnp.asarray(counts), d_lo, width,
                                         k)))
    r, valid = _ratios(5_000, seed)
    cs = np.sort(rng.normal(0, 0.02, 255)).astype(np.float32)
    got = tb.assign_nearest(torch.from_numpy(r), torch.from_numpy(valid),
                            torch.from_numpy(cs), 1e-3)
    want = jb.assign_nearest(jnp.asarray(r), jnp.asarray(valid),
                             jnp.asarray(cs), np.float32(1e-3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0] == cs.size                     # NaN -> incompressible
    assert (got.numpy()[~valid] == cs.size).all()
    amin, amax = tb.log_range(torch.from_numpy(r), torch.from_numpy(valid))
    for k in (1, 3, 255):
        np.testing.assert_array_equal(
            tb.log_scale_centers(amin, amax, k),
            np.asarray(jb.log_scale_centers(jnp.asarray(r),
                                            jnp.asarray(valid), k)))


def _round_f32(q: Fraction) -> np.float32:
    """The float32 nearest to the rational q, ties to even."""
    r = np.float32(float(q))
    cands = [np.nextafter(r, np.float32(-np.inf)), r,
             np.nextafter(r, np.float32(np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - q),
                                     int(np.asarray(v).view(np.int32)) & 1))


@pytest.mark.parametrize("fn", ["fma32", "exp", "log"])
def test_xla_f32_elementwise_matches_jnp(fn):
    """The host emulations of XLA CPU's float32 exp and log, and the exact
    fma, on 4,000 seeded values each.  Tolerance: exact (bit for bit)."""
    import jax.numpy as jnp
    from repro_torch.core import xla_f32

    rng = np.random.default_rng(len(fn))
    f32 = np.float32
    if fn == "fma32":
        a, b, c = (rng.standard_normal((3, 4000)) * 10.0 ** rng.integers(
            -8, 8, (3, 4000))).astype(f32)
        # Sums whose float64 value is a float32 tie but whose exact value
        # is not: a double rounding would round them the wrong way.
        one_up = f32(1 + 2.0 ** -23)
        a[:2] = [f32(2.0 ** -24 * (1 + 2.0 ** -20)),
                 f32(-(2.0 ** -24) * (1 + 2.0 ** -20))]
        b[:2] = f32(1 - 2.0 ** -20)
        c[:2] = [one_up, -one_up]
        got = xla_f32.fma32(a, b, c)
        want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                    + Fraction(float(z)))
                         for x, y, z in zip(a, b, c)], f32)
        assert got[0] == one_up and got[1] == -one_up
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        return
    if fn == "exp":
        x = rng.uniform(-27.7, 88.7, 4000).astype(f32)
        got, want = xla_f32.exp(x), np.asarray(jnp.exp(x))
    else:
        x = np.exp(rng.uniform(np.log(1e-12), np.log(3e38), 4000)
                   ).astype(f32)
        x[:5] = [0.0, 1.0, np.inf, 1e-40, 0.61204803]
        got, want = xla_f32.log(x), np.asarray(jnp.log(x))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("b_bits", range(2, 17))
def test_xla_f32_linspace_matches_jnp(b_bits):
    """jnp.linspace at every length the log-scale strategy asks for
    (2^(B-1) - 1), on 20 seeded (a, b) pairs.  Tolerance: exact."""
    import jax.numpy as jnp
    from repro_torch.core import xla_f32

    num = max((2 ** b_bits - 1) // 2, 1)
    rng = np.random.default_rng(b_bits)
    for _ in range(20):
        a, b = np.sort(rng.uniform(-28, 20, 2)).astype(np.float32)
        np.testing.assert_array_equal(
            xla_f32.linspace(a, b, num).view(np.int32),
            np.asarray(jnp.linspace(a, b, num)).view(np.int32))


# --------------------------------------------------------------------------
# Auto-B above 2^24 elements: the float32 prefix in XLA CPU's order.
# --------------------------------------------------------------------------

def test_cumsum_f32_matches_jnp_above_2_24():
    """The base-16 chunked scan against jnp.cumsum on 20 seeded descending
    histograms of 2^24..2^27 elements over 65,536 bins.  Exact."""
    import jax.numpy as jnp
    from repro_torch.core.select_b import cumsum_f32

    rng = np.random.default_rng(0)
    for _ in range(20):
        n = int(rng.integers(1 << 24, 1 << 27))
        c = np.sort(rng.multinomial(n, rng.dirichlet(np.full(65536, 0.3))))
        c = c[::-1].astype(np.float32)
        np.testing.assert_array_equal(
            cumsum_f32(c).view(np.int32),
            np.asarray(jnp.cumsum(jnp.asarray(c))).view(np.int32))


@pytest.mark.parametrize("seed", range(3))
def test_est_sizes_and_b_match_jax_above_2_24(seed):
    """Eq. (6) sizes and the chosen B on synthetic histograms of more than
    2^24 elements, where a float32 prefix is inexact."""
    import jax
    from repro.core import select_b as jselect
    from repro_torch.core import select_b as tselect

    rng = np.random.default_rng(seed)
    n = (1 << 24) + int(rng.integers(1, 1 << 26))
    c = np.sort(rng.multinomial(n, rng.dirichlet(np.full(65536, 0.05))))
    c = np.ascontiguousarray(c[::-1]).astype(np.int32)
    for ebytes in (4, 8):
        b_want, s_want = jax.jit(jselect.choose_b, static_argnums=(1, 2, 3))(
            c, n, ebytes, 16)
        b_got, s_got = tselect.choose_b(torch.from_numpy(c), n, ebytes, 16)
        np.testing.assert_array_equal(s_got.numpy(), np.asarray(s_want))
        assert b_got == int(b_want)


def test_step_above_2_24_matches_jax(tmp_path):
    """A real step of 2^24 + 4,099 elements: meta (est_sizes included), B
    and the NCK file bytes equal the reference's."""
    from repro.core import compress as jcomp
    from repro.core.container import NCKWriter as JWriter
    from repro_torch.core.container import NCKWriter as TWriter

    n = (1 << 24) + 4099
    rng = np.random.default_rng(0)
    prev = rng.normal(2.0, 0.5, n).astype(np.float32)
    curr = (prev * (1 + 0.05 * rng.standard_normal(n).astype(np.float32))
            ).astype(np.float32)
    want = jcomp.compress_step(prev, curr, JParams(zlib_level=1))
    got = tcompress.compress_step(prev, curr, TParams(zlib_level=1),
                                  device="cpu")
    assert got.b_bits == want.b_bits
    assert got.meta == want.meta
    paths = []
    for writer, step in ((JWriter, want), (TWriter, got)):
        w = writer()
        w.add_step("v", step)
        paths.append(tmp_path / f"{len(paths)}.nck")
        w.write(str(paths[-1]))
    assert paths[0].read_bytes() == paths[1].read_bytes()
