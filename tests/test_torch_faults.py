"""The port's entropy process pool and the overlap queue's timeout,
mirroring tests/test_entropy.py (the GIL-holding codec) and
tests/test_faults.py (the ``entropy_worker_death`` site, structured decode
errors, the wedged-worker timeout).

A GIL-holding codec goes through the forked process pool and stays
byte-identical to the serial loop; a pool worker that dies retires the
pool and the blocks go through the thread pool with the same output; a
codec that fails re-raises its own error; a wedged finalize worker raises
a labelled ``TimeoutError`` and is replaced.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import entropy as jentropy  # noqa: E402
from repro_torch.core import entropy  # noqa: E402
from repro_torch.core.overlap import FinalizeQueue  # noqa: E402
from repro_torch.faults import inject  # noqa: E402
from repro_torch.faults.errors import InjectedFault, IntegrityError  # noqa: E402
from repro_torch.obs import report, telemetry  # noqa: E402


class _GilBoundCodec(entropy.Codec):
    """Pure-python codec (holds the GIL): exercises the process-pool
    dispatch path.  Module level so forked workers can unpickle tasks."""

    name = "_test_gil_xor"
    holds_gil = True

    def compress(self, raw: bytes, level: int) -> bytes:
        return bytes(b ^ 0xA5 for b in raw)

    def decompress(self, blob: bytes) -> bytes:
        return bytes(b ^ 0xA5 for b in blob)


class _FailingGilCodec(_GilBoundCodec):
    name = "_test_gil_fail"

    def compress(self, raw: bytes, level: int) -> bytes:
        raise ValueError("codec refused the block")


@pytest.fixture
def fresh_pool(monkeypatch):
    """A process pool of this test's own: the module's pool state is
    restored afterwards, whatever the test retired."""
    monkeypatch.setattr(entropy, "_proc_pool", None)
    monkeypatch.setattr(entropy, "_proc_pool_broken", False)
    yield
    px = entropy._proc_pool
    if px is not None:
        px.shutdown(wait=True, cancel_futures=True)
    inject.reset()


def _raws(n=8, size=1 << 18):
    return [np.random.default_rng(i).integers(0, 256, size)
            .astype(np.uint8).tobytes() for i in range(n)]


def _shipped(names):
    """Registry names without the codecs test suites register themselves
    (``_test_*``): tests/test_entropy.py adds one to the reference's
    registry, and under --dist loadfile it may run first in this
    process."""
    return [n for n in names if not n.startswith("_test_")]


def test_codec_registry_matches_the_reference():
    assert _shipped(entropy.codec_names()) == _shipped(
        jentropy.codec_names())
    for name in _shipped(entropy.codec_names()):
        assert (entropy.get_codec(name).holds_gil
                == jentropy.get_codec(name).holds_gil), name


def test_gil_holding_codec_process_pool_dispatch(fresh_pool):
    """GIL-holding codecs go through the forked process pool and stay
    byte-identical to the serial loop."""
    entropy.register_codec(_GilBoundCodec())
    raws = _raws()
    serial = entropy.compress_blocks(raws, codec="_test_gil_xor",
                                     parallel=False)
    parallel = entropy.compress_blocks(raws, codec="_test_gil_xor",
                                       parallel=True)
    assert entropy._proc_pool is not None          # the pool did the work
    assert not entropy._proc_pool_broken
    assert serial == parallel
    for raw, blob in zip(raws, serial):
        assert entropy.decompress_block(blob, "_test_gil_xor") == raw


def test_worker_death_degrades_to_threads_with_identical_output(fresh_pool):
    """entropy_worker_death fires in the forked worker: the pool is
    retired and the thread path gives the serial loop's bytes."""
    entropy.register_codec(_GilBoundCodec())
    raws = _raws()
    serial = entropy.compress_blocks(raws, codec="_test_gil_xor",
                                     parallel=False)
    inject.configure("entropy_worker_death*100")
    with telemetry.capture() as reg:
        degraded = entropy.compress_blocks(raws, codec="_test_gil_xor",
                                           parallel=True)
    assert degraded == serial
    assert entropy._proc_pool_broken and entropy._proc_pool is None
    spans = report.rollup(reg)["spans"]
    assert spans["entropy.batch"]["count"] >= 1     # the thread path ran
    # retired for good: the next call goes straight to the threads
    assert entropy.compress_blocks(raws, codec="_test_gil_xor") == serial


def test_codec_error_reraised_by_the_thread_path(fresh_pool):
    entropy.register_codec(_FailingGilCodec())
    with pytest.raises(ValueError, match="codec refused the block"):
        entropy.compress_blocks(_raws(), codec="_test_gil_fail",
                                parallel=True)


def test_explicit_thread_pool_bypasses_the_process_pool(fresh_pool):
    entropy.register_codec(_GilBoundCodec())
    raws = _raws(n=4)
    with telemetry.capture():
        got = entropy.compress_blocks(raws, codec="_test_gil_xor",
                                      pool=entropy._shared_pool())
    assert entropy._proc_pool is None
    assert got == [bytes(b ^ 0xA5 for b in r) for r in raws]


def test_entropy_worker_death_site_and_structured_decode_errors(fresh_pool):
    inject.configure("entropy_worker_death")
    with pytest.raises(InjectedFault, match="entropy_worker_death"):
        entropy._compress_batch("zlib", [b"x" * 32], 6)
    blob = entropy._compress_batch("zlib", [b"x" * 32], 6)[0]  # exhausted
    assert blob == jentropy._compress_batch("zlib", [b"x" * 32], 6)[0]
    assert entropy.decompress_block(blob, "zlib") == b"x" * 32
    bad = bytearray(blob)
    bad[len(bad) // 2] ^= 0xFF
    with pytest.raises(IntegrityError, match="entropy decode failed"):
        entropy.decompress_block(bytes(bad), "zlib")


@pytest.mark.parametrize("codec", ["zlib", "raw", "bz2", "auto"])
def test_entropy_counters_match_the_reference(codec):
    """The stage's byte counters and auto picks, port against reference."""
    from repro.obs import telemetry as jtelemetry
    raws = _raws(n=6, size=1 << 17)
    raws[1] = bytes(len(raws[1]))             # one highly redundant block
    with telemetry.capture() as reg:
        got = (entropy.compress_blocks_per_codec(
            raws, entropy.choose_block_codecs(raws)) if codec == "auto"
            else entropy.compress_blocks(raws, codec=codec))
    with jtelemetry.capture() as jreg:
        want = (jentropy.compress_blocks_per_codec(
            raws, jentropy.choose_block_codecs(raws)) if codec == "auto"
            else jentropy.compress_blocks(raws, codec=codec))
    assert got == want
    assert reg.counters == jreg.counters


# ------------------------------------------------- wedged-worker timeout

def test_finalize_queue_times_out_and_retires_wedged_worker():
    q = FinalizeQueue(overlap=True, name="enc", timeout=0.3)
    gate = threading.Event()
    q.submit(gate.wait, label="finalize step 7")
    try:
        with pytest.raises(TimeoutError,
                           match=r"label=finalize step 7.*retired"):
            q.flush()
    finally:
        gate.set()                    # release the abandoned thread
    assert q.submit(lambda: 42, label="next").result(timeout=10) == 42
    q.close()


def test_finalize_queue_timeout_bounds_the_full_queue_stall():
    """The stall of a full queue is bounded too: a submit behind a wedged
    task raises instead of blocking."""
    q = FinalizeQueue(overlap=True, name="ckpt-save", max_in_flight=1,
                      timeout=0.3)
    gate = threading.Event()
    q.submit(gate.wait, label="save step 3")
    try:
        with pytest.raises(TimeoutError, match=r"ckpt-save worker wedged"):
            q.submit(lambda: None, label="save step 4")
    finally:
        gate.set()
    q.close()


def test_finalize_queue_default_timeout_unchanged():
    q = FinalizeQueue(overlap=True, name="enc")
    f = q.submit(lambda: "ok")
    q.flush()
    assert f.result() == "ok"
    assert FinalizeQueue.wait is FinalizeQueue.flush
    q.close()
