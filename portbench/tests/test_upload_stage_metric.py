"""The reader of the program's upload.stage spans, on synthetic records of
a traced stream run: it reads ms a delta step from the spans, and returns
None where the program records no such span (a checkout that uploads
through a sync.upload span) or the record is not a stream cell's.

    PYTHONPATH=src python -m pytest -q portbench/tests/test_upload_stage_metric.py
"""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import harness  # noqa: E402

NAME = "upload_stage_ms.compress"
# Two delta steps: (name, seconds, depth) as harness.Window keeps them.
STAGED = [
    ("upload.stage", 0.0006, 1), ("encode.analyze", 0.003, 1),
    ("sync.range", 0.0009, 2), ("compress.step", 0.009, 0),
    ("upload.stage", 0.0008, 1), ("sync.range", 0.0007, 2),
    ("compress.step", 0.010, 0),
]
PAGEABLE = [("sync.upload", 0.002, 1), ("sync.range", 0.0005, 2),
            ("compress.step", 0.010, 0)]


def _read(rec):
    return harness._load(ROOT / "portbench" / "metrics"
                         / f"{NAME}.py").read(rec)


def _stream(spans, steps=2):
    return {"kind": "stream", "steps": steps, "spans": list(spans)}


def test_reader_reads_ms_a_delta_step():
    assert _read(_stream(STAGED)) == pytest.approx(0.7)


@pytest.mark.parametrize("rec", [
    _stream(PAGEABLE, 1), _stream([]), _stream(STAGED, 0),
    {"kind": "read", "steps": 2, "spans": STAGED}])
def test_reader_gives_none_without_its_spans(rec):
    assert _read(rec) is None


def test_reader_is_listed_for_the_stream_cells():
    entry = {m["name"]: m for m in harness.bench()["per_layer"]}[NAME]
    assert entry["source"] == "program_span"
    assert entry["layer"] == "driver"
    assert entry["moves"] == "compress_MBps"
    assert entry["workloads"] == ["cmip.rans.stream", "stir.rans.stream"]
