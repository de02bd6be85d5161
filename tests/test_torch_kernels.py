"""The port's kernels against the JAX package's Pallas kernels, exactly.

On the CPU each kernel's plain PyTorch version is held against the Pallas
kernel run in interpret mode (as tests/test_kernels.py runs it).  Each
CUDA kernel is held against its plain version on the card in
tests/test_torch_cuda.py, which imports no JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import packing as jpacking  # noqa: E402
from repro.kernels import bitpack, change_ratio, dequant, hist, ref  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.kernels import bitpack as tbitpack  # noqa: E402
from repro_torch.kernels import dequant as tdequant  # noqa: E402
from repro_torch.kernels import hist as thist  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

from test_torch_cuda import (LO, MAX_BINS, WIDTH, _dequant_inputs,  # noqa: E402
                             _ids, _ratio_inputs)





@pytest.mark.parametrize("n", [1, 100, 4097, 65_537])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_change_ratio_plain_matches_pallas(n, dtype):
    prev, curr = _ratio_inputs(n, dtype, seed=n)
    r_j, id_j = change_ratio.change_ratio_bins(
        jnp.asarray(prev, jnp.float32), jnp.asarray(curr, jnp.float32),
        LO, WIDTH, max_bins=MAX_BINS, interpret=True)
    r_t, id_t = ops.change_ratio_bins(torch.from_numpy(prev),
                                      torch.from_numpy(curr),
                                      np.float32(LO), np.float32(WIDTH),
                                      max_bins=MAX_BINS)
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    np.testing.assert_array_equal(id_t.numpy(), np.asarray(id_j))


@pytest.mark.parametrize("max_bins", [1024, 65536])
def test_histogram_plain_matches_pallas(max_bins):
    ids = _ids(65_537, max_bins, seed=max_bins)
    got = ops.histogram(torch.from_numpy(ids), max_bins=max_bins)
    want = hist.histogram(jnp.asarray(ids), max_bins=max_bins,
                          interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("max_bins", [2, 1000, 3000])
def test_histogram_plain_any_max_bins(max_bins):
    ids = _ids(10_001, max_bins, seed=max_bins)
    got = ops.histogram(torch.from_numpy(ids), max_bins=max_bins)
    want = ref.histogram_ref(ids, max_bins=max_bins)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("b_bits", range(1, 25))
def test_pack_plain_matches_pallas_and_bytes(b_bits):
    rng = np.random.default_rng(b_bits)
    idx = rng.integers(0, 1 << b_bits, 32 * 123).astype(np.int32)
    got = ops.pack_bits(torch.from_numpy(idx), b_bits=b_bits).numpy()
    want = bitpack.pack_bits(jnp.asarray(idx), b_bits=b_bits, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.astype("<u4").tobytes() == \
        jpacking.pack_indices_np(idx, b_bits).tobytes()
    assert got.astype("<u4").tobytes() == \
        packing.pack_indices_np(idx, b_bits).tobytes()


@pytest.mark.parametrize("b_bits", [2, 5, 8, 13])
@pytest.mark.parametrize("n", [17, 4097])
def test_dequant_and_chain_plain_match_pallas_f32(b_bits, n):
    idx, prev, curr, centers = _dequant_inputs(b_bits, n, np.float32, n)
    t = [torch.from_numpy(a) for a in (idx, prev, curr, centers)]
    want = dequant.dequantize(jnp.asarray(idx), jnp.asarray(prev),
                              jnp.asarray(centers), b_bits=b_bits,
                              interpret=True)
    got = ops.dequantize(t[0], t[1], t[3], b_bits=b_bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jops.chain_advance(jnp.asarray(idx), jnp.asarray(prev),
                              jnp.asarray(curr), jnp.asarray(centers),
                              b_bits=b_bits, use_pallas=True)
    got = ops.chain_advance(t[0], t[1], t[2], t[3], b_bits=b_bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("b_bits", [2, 5, 8, 13])
def test_dequant_and_chain_plain_match_jnp_f64(b_bits):
    idx, prev, curr, centers = _dequant_inputs(b_bits, 4097, np.float64, 3)
    t = [torch.from_numpy(a) for a in (idx, prev, curr, centers)]
    with jax.enable_x64(True):
        want_d = np.asarray(dequant.dequantize_jnp(
            jnp.asarray(idx), jnp.asarray(prev), jnp.asarray(centers),
            b_bits=b_bits))
        want_c = np.asarray(jops.chain_advance(
            jnp.asarray(idx), jnp.asarray(prev), jnp.asarray(curr),
            jnp.asarray(centers), b_bits=b_bits, use_pallas=False))
    assert want_d.dtype == want_c.dtype == np.float64
    got_d = ops.dequantize(t[0], t[1], t[3], b_bits=b_bits)
    got_c = ops.chain_advance(t[0], t[1], t[2], t[3], b_bits=b_bits)
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    np.testing.assert_array_equal(got_c.numpy(), want_c)


def test_patch_exceptions_matches_jax():
    idx, prev, _, centers = _dequant_inputs(5, 1000, np.float32, 5)
    marker = (1 << 5) - 1
    exc = np.arange((idx == marker).sum(), dtype=np.float32) + 100.0
    recon = dequant.dequantize(jnp.asarray(idx), jnp.asarray(prev),
                               jnp.asarray(centers), b_bits=5,
                               interpret=True)
    want = dequant.patch_exceptions(recon, jnp.asarray(idx),
                                    jnp.asarray(exc), b_bits=5)
    got = tdequant.patch_exceptions(torch.from_numpy(np.array(recon)),
                                    torch.from_numpy(idx),
                                    torch.from_numpy(exc), b_bits=5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrappers_refuse_cpu_tensors_and_other_devices():
    """A wrapper's kernel path takes CUDA tensors only, and the dispatch
    knows no device but the CPU and CUDA."""
    x = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tbitpack.pack_bits_cuda(x, b_bits=4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        thist.histogram_cuda(x, max_bins=16)
    with pytest.raises(ValueError, match="no kernel"):
        ops.pack_bits(x.to("meta"), b_bits=4)


def test_build_names_a_missing_source(monkeypatch, tmp_path):
    """Outside a source checkout the CUDA sources are absent: the build
    says so before it looks for nvcc or writes anything."""
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="source checkout"):
        _build.build()
    assert not (tmp_path / "build").exists()
