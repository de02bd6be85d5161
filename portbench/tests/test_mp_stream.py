"""The multi-process stream cell (``drivers/mp_stream.py``) on the CPU at the
benchmark's tiny size: four gloo ranks on CPU devices through the
program's launcher, judged by the cell's own check.

    PYTHONPATH=src python -m pytest -q portbench/tests/test_mp_stream.py
"""
from __future__ import annotations

import ast
import copy
import json
import os
import sys
import time
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(HERE)]

import test_portbench as T  # noqa: E402
from portbench import harness  # noqa: E402

CELL = "cmip.mp4.stream"
SEED = 2 ** 31 + 23
NEW = ["collective_ms.compress", "collective_kB.compress",
       "rank_skew_p95_ms.compress"]


def _driver():
    return harness._load(ROOT / "portbench" / "drivers" / "mp_stream.py")


def _ctx():
    return harness.Ctx(CELL, T.tiny_cell(CELL), SEED, 0.5, False, torch,
                       "cpu", lambda: 0.0)


@pytest.fixture(scope="module")
def runs():
    """trace -> (result, record) of one tiny run."""
    # The traced run outlasts the profiled part of its window, which the
    # rank skew leaves out.
    return {trace: T.tiny_run(CELL, trace, seconds=(0.6, 4.6)[trace],
                              seed=SEED + trace)
            for trace in (0, 1)}


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_as_cpu_ranks_and_is_correct(runs, trace, capsys):
    res, rec = runs[trace]
    harness.emit(res, rec)
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["correct"] is True, last["checks"]
    assert all(c["value"] == 0 for c in last["checks"].values())
    assert last["device"]["count"] == 4
    assert rec["steps"] >= 1 and len(rec["ranks_out"]) == 4
    names = {m["name"] for m in harness.metrics_for(harness.bench(), CELL,
                                                    bool(trace))}
    assert set(last["metrics"]) <= names
    if trace:
        assert set(NEW) <= set(last["metrics"])
        # every rank's range ends and int64 histogram, at least
        assert last["metrics"]["collective_kB.compress"]["value"] >= (
            4 * (8 + 65_536 * 8) / 1e3)
    else:
        assert {"compress_MBps", "compression_ratio",
                "setup_s"} <= set(last["metrics"])


def test_every_rank_records_its_spans_and_the_stream_readers_read(runs):
    """In a traced run every rank records its spans (no rank runs slower
    for being the only one that does), the profiler runs on rank 0 alone,
    and the one-card stream cells' readers find the keys they read in the
    record."""
    _, rec = runs[1]
    assert all(o["coll"] for o in rec["ranks_out"])
    assert [o["trace"] is not None for o in rec["ranks_out"]] == [
        True, False, False, False]
    assert rec["profiled_until"] < max(rec["done_at"][0])
    assert len(rec["coll_bytes"]) == 4
    assert len(rec["step_s"]) == rec["steps"]
    assert 0 < rec["trace_steps"] <= rec["steps"]
    assert rec["roofline_bytes"] > 0
    for path in sorted((ROOT / "portbench" / "metrics").glob(
            "*.compress.py")):
        harness._load(path).read(rec)       # a value or None, never a miss
    for name in ("step_p95_ms.compress", "host_syncs_per_step.compress",
                 "encode_ms.compress", "finalize_ms.compress"):
        reader = harness._load(ROOT / "portbench" / "metrics" / f"{name}.py")
        assert reader.read(rec) > 0, name


def test_the_control_is_not_correct():
    """The reference in bfloat16 in every rank's place fails the check by
    some limits and not by every one; in float32 it passes every one."""
    drv = _driver()
    ctx = _ctx()
    bad = drv.check(ctx, drv.control_record(ctx, torch.bfloat16, 8))
    over = {k for k, c in bad.items() if c["value"] > c["limit"]}
    assert over and over != set(bad), bad
    sound = drv.check(ctx, drv.control_record(ctx, torch.float32, 8))
    assert all(c["value"] == 0 for c in sound.values()), sound


def _flip_blob(rec):
    t = rec["ranks_out"][2]["tally"]
    step = sorted(t["kept"])[0]
    blob = bytearray(t["kept"][step][0])
    blob[-1] ^= 0x10
    t["kept"][step] = [bytes(blob)] + t["kept"][step][1:]


def _drop_exception(rec):
    exc = rec["ranks_out"][1]["tally"]["exc"]
    i = max(range(len(exc)), key=lambda k: len(exc[k]))
    exc[i] = exc[i][1:]


def _move_block(rec):
    owned = rec["ranks_out"][3]["owned"]
    start, count = owned[-1]
    owned[-1] = (start - 1, count + 1)


@pytest.mark.parametrize("corrupt", [_flip_blob, _drop_exception,
                                     _move_block],
                         ids=lambda f: f.__name__)
def test_a_corrupted_rank_fragment_is_not_correct(runs, corrupt):
    _, rec = runs[0]
    rec = copy.deepcopy(rec)
    corrupt(rec)
    checks = _driver().check(_ctx(), rec)
    assert any(c["value"] > c["limit"] for c in checks.values()), checks


def test_a_rank_that_never_finishes_is_killed_at_the_deadline(monkeypatch):
    """Rank 1 sleeps an hour in its first step; every rank is killed at the
    fleet's deadline and the run raises: no result, no hang."""
    monkeypatch.setenv("REPRO_FAULTS", "straggler@1=3600")
    drv = _driver()
    drv.SLACK_S = 10.0
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="the fleet failed"):
        drv.run(_ctx())
    assert time.perf_counter() - t0 < 60


def test_a_forbidden_module_in_any_rank_is_caught(tmp_path, monkeypatch):
    """Rank 2 alone loads a module named jax (a stub, through the
    interpreter's start-up hook): the run is not correct."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("")
    (tmp_path / "sitecustomize.py").write_text(
        "import os\n"
        "if os.environ.get('REPRO_PROCESS_ID') == '2':\n"
        "    import jax\n")
    path = os.environ.get("PYTHONPATH")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(tmp_path)] + ([path] if path else [])))
    res, _ = T.tiny_run(CELL, 0, seconds=0.3, seed=SEED)
    assert res["correct"] is False
    assert res["checks"]["forbidden_modules"]["value"] == 1


def test_the_rank_ownership_reference_imports_nothing_of_the_program():
    tree = ast.parse((ROOT / "portbench" / "reference_mp.py").read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_the_rank_ownership_reference_follows_the_paper():
    from portbench import reference_mp as rm
    # The four-rank CMIP cell: 1 MB blocks exceed a 907,200-element shard
    # and shrink to it, one block a rank.
    n = 42 * 360 * 240
    assert rm.layout(n, 4, 4, 1 << 20) == (907_200, 907_200, 4)
    assert rm.owned(n, 4, 4, 1 << 20) == [(0, 1), (1, 1), (2, 1), (3, 1)]
    # Blocks that cross shard boundaries belong to the rank they start in.
    assert rm.owned(1000, 3, 8, 32) == [(0, 11), (11, 10), (21, 11)]
    assert sum(c for _, c in rm.owned(30_011, 4, 4, 1024)) == -(-30_011
                                                                // 2048)
