"""The staged upload of a stream step (``core.compress._upload``) against
``torch.tensor``, byte for byte, and a compressor whose caller reuses its
buffer as soon as ``add_async`` returns.  On the CPU the staging tensor is
not pinned; the card's tests are in tests/test_torch_cuda.py.

    PYTHONPATH=src python -m pytest -q tests/test_torch_upload.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import interop  # noqa: E402
from repro_torch.core import compress  # noqa: E402
from repro_torch.core.types import NumarckParams  # noqa: E402
from repro_torch.data.temporal import generate_series  # noqa: E402

# Elements of a CMIP step (42 x 360 x 240 f32), the largest the
# benchmark's cells upload.
CMIP = 42 * 360 * 240


def _normal(n, dtype, seed=5):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


def _read_only(a):
    a.flags.writeable = False
    return a


# Inputs that differ in size, dtype, layout and byte order.  torch.tensor
# refuses a byte-swapped array, and so must _upload.
ARRAYS = {
    "f32_small": lambda: _normal(1000, np.float32),
    "f32_a_cmip_step_and_one": lambda: _normal(CMIP + 1, np.float32),
    "f64_small": lambda: _normal(1000, np.float64),
    "f64_half_a_cmip_step_and_one": lambda: _normal(CMIP // 2 + 1,
                                                    np.float64),
    "f32_non_contiguous": lambda: _normal(24 * 30 * 40, np.float32)
    .reshape(24, 30, 40)[:, ::3, 1:],
    "f64_fortran_order": lambda: np.asfortranarray(
        _normal(CMIP // 2 + 7, np.float64)[:-7].reshape(60, -1)),
    "f32_byte_swapped": lambda: _normal(1000, ">f4"),
    "bf16_storage_uint16": lambda: torch.from_numpy(
        _normal(CMIP + 3, np.float32)).to(torch.bfloat16)
    .view(torch.int16).numpy().view(np.uint16),
    "f32_read_only": lambda: _read_only(_normal(CMIP + 1, np.float32)),
    "f32_zero_dim": lambda: np.asarray(np.float32(-0.0)),
    "f32_empty": lambda: np.zeros((0, 3), np.float32),
}


def _outcome(fn, arr):
    """(dtype, shape, bytes in C order) of the tensor ``fn`` makes of
    ``arr``, taken after the caller has overwritten ``arr``, or the error
    ``fn`` raises.  torch.tensor keeps a Fortran-ordered array's strides;
    the staged upload's tensor is always contiguous."""
    before = arr.tobytes()
    try:
        t = fn(arr, torch.device("cpu"))
    except (TypeError, ValueError) as e:
        return type(e), str(e)
    assert arr.tobytes() == before
    if not arr.flags.writeable:
        return t.dtype, tuple(t.shape), t.numpy().tobytes()
    arr[...] = 7
    got = t.dtype, tuple(t.shape), t.numpy().tobytes()
    arr[...] = np.frombuffer(before, arr.dtype).reshape(arr.shape)
    return got


@pytest.mark.parametrize("case", sorted(ARRAYS))
def test_staged_upload_gives_the_bytes_of_torch_tensor(case):
    """The same tensor as torch.tensor, or the same refusal, and a private
    copy: the caller's array is read and never kept."""
    arr = ARRAYS[case]()
    assert _outcome(compress._upload, arr) == _outcome(
        lambda a, d: torch.tensor(a, device=d), arr)


def _same_steps(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        fg, fw = interop.step_to_fields(g), interop.step_to_fields(w)
        assert fg.keys() == fw.keys()
        for k, v in fw.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(fg[k], v, err_msg=k)
            else:
                assert fg[k] == v, k


@pytest.mark.parametrize("overlap", [False, True])
def test_buffer_reused_after_add_async_leaves_the_steps_unchanged(overlap):
    """A caller that overwrites its array as soon as ``add_async`` returns
    gets the steps of an untouched series, bit for bit."""
    series = list(generate_series("stir", 4, seed=3, scale=4))
    params = NumarckParams(error_bound=1e-3, codec="rans")
    want = compress.compress_series(series, params, overlap=overlap,
                                    device="cpu")
    comp = compress.TemporalCompressor(params, overlap=overlap, device="cpu")
    buf = np.empty_like(series[0])
    futures = []
    try:
        for a in series:
            buf[...] = a
            futures.append(comp.add_async(buf))
            buf[...] = np.nan
        got = [f.result() for f in futures]
    finally:
        comp.close()
    _same_steps(got, want)
