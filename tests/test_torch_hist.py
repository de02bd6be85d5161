"""The histogram's table bound and plain version, on the CPU.

The id bound of ``core.ratios.histogram_domain`` sizes the histogram
kernel's shared-memory table from the step's ratio range.  It must equal
the largest candidate-bin id of the change-ratio kernel's plain version
plus one (the margin is 0: both round the data to float32 once and then do
the same float32 arithmetic), for f32 and f64 data, at and next to a bin edge, for a range that does not
fit, and with no valid ratio.  The plain histogram is held against the
Pallas kernel in interpret mode on extreme id distributions.  The CUDA
kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import hist  # noqa: E402
from repro_torch.core import compress, ratios  # noqa: E402
from repro_torch.core.types import NumarckParams  # noqa: E402
from repro_torch.data.temporal import generate_series  # noqa: E402
from repro_torch.kernels import change_ratio, ops  # noqa: E402

E = 1e-3
MAX_BINS = 65536


def _bound_and_ids(prev, curr, error_bound=E, max_bins=MAX_BINS):
    """As the main path's _analyze: (id_bound, plain candidate-bin ids)."""
    p, c = torch.from_numpy(prev), torch.from_numpy(curr)
    r, valid = ratios.change_ratios(p, c)
    lo, hi = ratios.ratio_range(r, valid)
    d_lo, width, bound = ratios.histogram_domain(lo, hi, error_bound,
                                                 max_bins)
    _, ids = change_ratio.change_ratio_bins_plain(p, c, d_lo, width,
                                                  max_bins=max_bins)
    return bound, ids.numpy()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("series", ["cmip", "sedov"])
def test_id_bound_is_the_largest_plain_id_plus_one(series, dtype):
    steps = [a.astype(dtype) for a in generate_series(series, 3, seed=0,
                                                      scale=4)]
    for prev, curr in zip(steps, steps[1:]):
        bound, ids = _bound_and_ids(prev.reshape(-1), curr.reshape(-1))
        assert bound == ids.max() + 1
        assert bound < MAX_BINS // 8       # the table the kernel can shrink


def _edge_pair(dtype, top, where):
    """prev = 1, so r = curr - 1 is exact; lo = 0, width = 2^-10 (E =
    2^-11), ratios j/1024 for j < top, and hi = top/1024 on the bin edge,
    one ulp below it or one above."""
    curr = np.float32(1) + np.arange(top, dtype=np.float32) / np.float32(1024)
    edge = np.float32(1) + np.float32(top) / np.float32(1024)
    hi = {"on": edge, "below": np.nextafter(edge, np.float32(0)),
          "above": np.nextafter(edge, np.float32(2))}[where]
    curr = np.concatenate([curr, [hi, hi - np.float32(0.5 / 1024)]])
    return np.ones(curr.size, dtype), curr.astype(dtype)


@pytest.mark.parametrize("where", ["on", "below", "above"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_id_bound_at_a_bin_edge(dtype, where):
    prev, curr = _edge_pair(dtype, 37, where)
    bound, ids = _bound_and_ids(prev, curr, error_bound=2.0 ** -11,
                                max_bins=64)
    assert bound == ids.max() + 1 == (36 if where == "below" else 37) + 1


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_id_bound_at_the_top_edge_of_a_range_that_just_fits(dtype):
    """hi - lo == width * max_bins: the range fits, hi's id is max_bins
    (out of range, -1), and the bound stops at max_bins."""
    prev, curr = _edge_pair(dtype, 64, "on")
    bound, ids = _bound_and_ids(prev, curr, error_bound=2.0 ** -11,
                                max_bins=64)
    assert ids[-2] == -1
    assert bound == ids.max() + 1 == 64


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_id_bound_when_the_range_does_not_fit(dtype):
    rng = np.random.default_rng(3)
    prev = rng.normal(2.0, 0.5, 5000).astype(dtype)
    curr = (prev * (1 + 1e-3 * rng.standard_normal(5000))).astype(dtype)
    curr[7] = prev[7] * 1e4           # one ratio far beyond 2E * max_bins
    bound, ids = _bound_and_ids(prev, curr)
    assert bound == MAX_BINS
    assert ids.max() < bound and ids[7] == -1


def test_id_bound_with_no_valid_ratio():
    prev = np.zeros(100, np.float32)
    bound, ids = _bound_and_ids(prev, np.ones(100, np.float32))
    assert (ids == -1).all()
    assert bound == 1                  # one empty bin: the least table


def test_analyze_passes_the_exact_id_bound(monkeypatch):
    steps = list(generate_series("cmip", 2, seed=1, scale=4))
    seen = []
    real = ops.histogram

    def spy(bin_ids, *, max_bins, id_bound=None):
        seen.append((int(bin_ids.max()), id_bound))
        return real(bin_ids, max_bins=max_bins, id_bound=id_bound)

    monkeypatch.setattr(ops, "histogram", spy)
    compress.encode_device(steps[0], steps[1], NumarckParams(error_bound=E),
                           device="cpu")
    assert len(seen) == 1 and seen[0][1] == seen[0][0] + 1


def _extreme_ids(kind, n, max_bins, seed):
    rng = np.random.default_rng(seed)
    if kind == "one_bin":
        return np.full(n, max_bins // 2 + 1, np.int32)
    if kind == "all_invalid":
        return np.full(n, -1, np.int32)
    return rng.integers(0, max_bins, n).astype(np.int32)


@pytest.mark.parametrize("id_bound", [None, 1, 512])
@pytest.mark.parametrize("kind", ["one_bin", "all_invalid", "uniform"])
def test_histogram_plain_matches_pallas_on_extreme_ids(kind, id_bound):
    ids = _extreme_ids(kind, 4097, 1024, seed=len(kind))
    got = ops.histogram(torch.from_numpy(ids), max_bins=1024,
                        id_bound=id_bound)
    want = hist.histogram(jnp.asarray(ids), max_bins=1024, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
