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
from repro_torch.kernels import bitpack, change_ratio, dequant, hist, ops  # noqa: E402

LO, WIDTH, MAX_BINS = -0.128, 0.002, 2048


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
@pytest.mark.parametrize("b_bits", range(1, 25))
def test_cuda_pack_matches_plain(cuda, b_bits):
    rng = np.random.default_rng(b_bits)
    idx = torch.from_numpy(rng.integers(0, 1 << b_bits, 32 * 4099)
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
    assert all(k.launches == steps - 1 for k in ops.KERNELS)
    want = repro_torch.compress_series(arrays, chain="device", device="cpu")
    for g, w in zip(got, want):
        fg, fw = interop.step_to_fields(g), interop.step_to_fields(w)
        for key, vw in fw.items():
            if isinstance(vw, np.ndarray):
                np.testing.assert_array_equal(fg[key], vw, err_msg=key)
            else:
                assert fg[key] == vw, key
