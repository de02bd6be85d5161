"""The port's encode stage against the JAX package's, exactly.

``repro_torch.core.compress.encode_device`` on the CPU (the kernels' plain
versions) against ``repro.core.compress.encode_device``: index table,
centers, auto-B and its size estimates, histogram domain and the
compacted exceptions.
"""
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
