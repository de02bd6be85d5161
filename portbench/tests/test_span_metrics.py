"""The readers of the program's step and sync spans, on synthetic records of
a traced stream run: each reads its value from the spans, and returns None
where the program records no such span (a checkout without them) or the
record is not a stream cell's.

    PYTHONPATH=src python -m pytest -q portbench/tests/test_span_metrics.py
"""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import harness  # noqa: E402

# Two delta steps: (name, seconds, depth) as harness.Window keeps them.
SPANS = [
    ("sync.upload", 0.002, 1), ("encode.analyze", 0.003, 1),
    ("sync.range", 0.0005, 2), ("sync.choose_b", 0.0001, 2),
    ("chain.advance", 0.0004, 1), ("finalize", 0.0002, 2),
    ("compress.step", 0.010, 0),
    ("sync.upload", 0.004, 1), ("sync.range", 0.0003, 2),
    ("compress.step", 0.012, 0),
]
# metric -> what it reads from SPANS over two steps
WANT = {
    "step_span_p95_ms.compress": 11.9,          # numpy's p95 of 10, 12 ms
    "upload_ms.compress": 3.0,
    "host_syncs_per_step.compress": 2.5,
    "sync_wait_ms.compress": 3.45,
}


def _read(name, rec):
    return harness._load(ROOT / "portbench" / "metrics"
                         / f"{name}.py").read(rec)


def _stream(spans, steps=2):
    return {"kind": "stream", "steps": steps, "spans": list(spans)}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_its_spans(name):
    assert _read(name, _stream(SPANS)) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_gives_none_without_its_spans(name):
    bare = [s for s in SPANS
            if not s[0].startswith("sync.") and s[0] != "compress.step"]
    assert _read(name, _stream(bare)) is None
    assert _read(name, _stream([])) is None
    assert _read(name, {"kind": "read", "steps": 2, "spans": SPANS}) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_is_listed_for_the_stream_cells(name):
    spec = harness.bench()
    entry = {m["name"]: m for m in spec["per_layer"]}[name]
    assert entry["source"] == "program_span"
    assert entry["moves"] == "compress_MBps"
    assert entry["workloads"] == ["cmip.rans.stream", "stir.rans.stream"]
