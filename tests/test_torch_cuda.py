"""Each CUDA kernel of the port against its plain PyTorch version, on the
card, exactly.

These tests need a CUDA device and nvcc; they skip elsewhere.  The file
imports no JAX (the machine with the card has none), so it runs there as

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The input makers here are shared with tests/test_torch_kernels.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch import interop  # noqa: E402
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


@pytest.mark.cuda
@pytest.mark.parametrize("max_bins", [2, 1000, 65536, 100_000])
def test_cuda_histogram_matches_plain(cuda, max_bins):
    ids = torch.from_numpy(_ids(1 << 20, max_bins, seed=1)).to(cuda)
    assert torch.equal(hist.histogram_cuda(ids, max_bins=max_bins),
                       hist.histogram_plain(ids, max_bins=max_bins))


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
