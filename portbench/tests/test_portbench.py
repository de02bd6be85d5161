"""The benchmark's own tests, on the CPU at a tiny size with the program's
plain PyTorch path (the rANS device route forced down to tiny steps), and
one card-only run.

    PYTHONPATH=src python -m pytest -q portbench/tests
"""
from __future__ import annotations

import ast
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import control, gen, harness  # noqa: E402

TINY = [8, 32, 32]
CELLS = [w["name"] for w in harness.bench()["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture
def tiny_route(monkeypatch):
    """The program's rANS device route at tiny sizes, as on the card."""
    from repro_torch.kernels import rans
    monkeypatch.setattr(rans, "DEVICE_MIN_BYTES", 0)


def bench_with_reads(root=ROOT):
    """BENCHMARK.json with the read cells of ``pending.json`` merged in:
    built and tested here, not yet in the benchmark (PERF.md)."""
    spec = harness.bench(root)
    with open(root / "portbench" / "pending.json") as f:
        pending = json.load(f)
    spec["workloads"] += pending["workloads"]
    for group in ("end_to_end", "per_layer"):
        have = {m["name"]: m for m in spec[group]}
        for m in pending[group]:
            if m["name"] in have:
                if "workloads" in have[m["name"]]:
                    have[m["name"]]["workloads"] += m["workloads"]
            else:
                spec[group].append(m)
    return spec


def tiny_cell(name, root=ROOT):
    cs = harness.cell(name, bench_with_reads(root), root)
    cs["config"]["shape"] = list(TINY)
    if "series_steps" in cs["traffic"]:
        cs["traffic"]["series_steps"] = 6
    return cs


def tiny_run(name, trace=0, seconds=0.4, seed=2 ** 31 + 11, root=ROOT):
    t0 = time.perf_counter()
    return harness.run_cell(name, seed, seconds, bool(trace), "cpu",
                            lambda: time.perf_counter() - t0,
                            bench_with_reads(root), tiny_cell(name, root))


def test_every_file_is_found_by_name():
    spec = harness.bench()
    for w in spec["workloads"]:
        cs = harness.cell(w["name"], spec)
        assert (ROOT / "portbench" / "drivers"
                / f"{cs['traffic']['driver']}.py").is_file()
    for c in spec["configs"]:
        with open(ROOT / c["file"]) as f:
            assert json.load(f)["name"] == c["name"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        mod = harness._load(ROOT / "portbench" / "metrics"
                            / f"{m['name']}.py")
        assert callable(mod.read)


def test_a_new_cell_and_metric_are_files_only(tmp_path, tiny_route):
    """A copy of the checkout gains a traffic mix, a cell and a per-layer
    metric by new files and new BENCHMARK.json entries alone."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    tr = json.loads((tmp_path / "portbench/traffic/rans-stream.json")
                    .read_text())
    tr["warmup_steps"] = 1
    (tmp_path / "portbench/traffic/rans-stream-cold.json").write_text(
        json.dumps(tr))
    (tmp_path / "portbench/metrics/steps_in_window.py").write_text(
        "def read(rec):\n    return rec['steps']\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "cmip.rans.cold", "config": "cmip-uvel",
                              "traffic": "rans-stream-cold", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "cmip.rans.stream" in m.get("workloads", []):
            m["workloads"].append("cmip.rans.cold")
    spec["per_layer"].append({"name": "steps_in_window", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "driver", "moves": "compress_MBps",
                              "workloads": ["cmip.rans.cold"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    for p, raw in before.items():
        assert p.read_bytes() == raw
    res, _ = tiny_run("cmip.rans.cold", trace=1, root=tmp_path)
    assert res["correct"]
    assert res["metrics"]["steps_in_window"]["value"] >= 1


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", ["cmip.rans.stream", "stir.rans.read"])
def test_last_line_holds_the_keys(name, trace, tiny_route, capsys):
    res, rec = tiny_run(name, trace)
    harness.emit(res, rec)
    out = capsys.readouterr()
    last = json.loads(out.out.strip().splitlines()[-1])
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(last) == want
    assert last["correct"] is True
    assert out.err.strip().splitlines()[-1].startswith("check ")
    spec = bench_with_reads()
    names = {m["name"] for m in harness.metrics_for(spec, name, bool(trace))}
    assert set(last["metrics"]) <= names
    if not trace:
        assert "setup_s" in last["metrics"]


def test_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, str(ROOT / "portbench/run.py"),
                        "--workload", CELLS[0], "--seed", "1", "--seconds",
                        "1", "--trace", "0"], capture_output=True, text=True,
                       cwd=ROOT, timeout=300)
    assert p.returncode != 0
    assert "{" not in p.stdout


BLOCK = """
import sys, time
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {forbidden!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path[:0] = [{root!r}, {src!r}]
sys.path.insert(0, {tests!r})
import test_portbench as T
from repro_torch.kernels import rans
rans.DEVICE_MIN_BYTES = 0
for name in ("cmip.rans.stream", "stir.rans.read"):
    res, _ = T.tiny_run(name, trace=1)
    assert res["correct"], res
from portbench import harness
assert harness.forbidden_modules() == [], harness.forbidden_modules()
print("ok")
"""


def test_nothing_the_run_loads_imports_jax_or_the_reference_package():
    code = BLOCK.format(forbidden=harness.FORBIDDEN, root=str(ROOT),
                        src=str(ROOT / "src"),
                        tests=str(Path(__file__).parent))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().endswith("ok")


YARDSTICK = ("reference.py", "gen.py", "yardstick.py", "devtrace.py",
             "control.py")


@pytest.mark.parametrize("name", YARDSTICK)
def test_the_yardstick_imports_nothing_of_the_program(name):
    tree = ast.parse((ROOT / "portbench" / name).read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


@pytest.mark.parametrize("config", ["cmip-uvel", "flash-stir"])
def test_generator_keeps_the_recorded_statistics(config):
    with open(ROOT / "portbench" / "configs" / f"{config}.json") as f:
        spec = json.load(f)
    st = spec["assumed"]
    small = dict(spec, shape=[32, 64, 64])
    a, b = gen.make_pool(small, 2, 7, "cpu")
    assert a.dtype == getattr(torch, spec["dtype"])
    x = a.double()
    assert abs(float(x.mean()) - st["offset"]) < 0.1
    assert abs(float(x.std()) - 1.0) < 0.05
    change = (b.double() / x - 1).reshape(-1)
    n = change.numel()
    static = float((change.abs() < 1e-5).double().mean())
    assert abs(static - st["static_frac"]) < 0.01
    cut = 8 * st["vol"]
    moved = change.abs() > cut
    p_jump_moves = 1 - math.erf(cut / math.sqrt(2))
    want = st["jump_frac"] * p_jump_moves
    assert abs(float(moved.double().mean()) - want) < 0.3 * want
    smooth = change[(change.abs() >= 1e-5) & ~moved]
    assert smooth.numel() > n // 2
    assert abs(float(smooth.std()) / st["vol"] - 1) < 0.05


@pytest.mark.parametrize("name", ["cmip.rans.stream", "cmip.rans.read"])
def test_the_control_is_not_correct(name):
    cs = tiny_cell(name)
    ctx = harness.Ctx(name, cs, 2 ** 31 + 3, 0, False, torch, "cpu",
                      lambda: 0.0)
    driver = harness._load(ROOT / "portbench" / "drivers"
                           / f"{cs['traffic']['driver']}.py")
    checks = driver.check(ctx, control.record(ctx, driver, torch.bfloat16,
                                              8))
    assert any(c["value"] > c["limit"] for c in checks.values()), checks
    sound = driver.check(ctx, control.record(ctx, driver, torch.float32, 8))
    assert all(c["value"] == 0 for c in sound.values()), sound


def _unchanged_chain(mp):
    from repro_torch.core import chain
    mp.setattr(chain.DeviceReferenceChain, "advance",
               lambda self, dev, curr: None)


def _altered_index(mp):
    from repro_torch.core import compress
    real = compress._encode_topk

    def wrong(*a, **k):
        idx = real(*a, **k).clone()
        idx[0] = 0 if int(idx[0]) else 1
        return idx
    mp.setattr(compress, "_encode_topk", wrong)


def _half_exceptions(mp):
    from repro_torch.core import pipeline
    real = pipeline.finalize_step

    def wrong(*a, **k):
        st = real(*a, **k)
        st.incomp_values = st.incomp_values[: st.incomp_values.size // 2]
        return st
    mp.setattr(pipeline, "finalize_step", wrong)


def _unchanged_state(mp):
    from repro_torch.core import compress
    mp.setattr(compress, "decompress_step_device",
               lambda step, prev, device=None: compress._to_device(
                   prev, compress.chainmod.resolve_device(device)).reshape(
                       step.shape))


def _half_delivered(mp):
    from repro_torch.core import compress
    real = compress._fetch
    mp.setattr(compress, "_fetch",
               lambda step, out: real(step, out).reshape(-1)[
                   : step.n // 2].copy())


def _altered_value(mp):
    from repro_torch.core import compress
    real = compress._fetch

    def wrong(step, out):
        host = real(step, out)
        host.reshape(-1)[0] *= 2
        return host
    mp.setattr(compress, "_fetch", wrong)


FAULTS = {
    "cmip.rans.stream": [_unchanged_chain, _altered_index, _half_exceptions],
    "cmip.rans.read": [_unchanged_state, _half_delivered, _altered_value],
}


@pytest.mark.parametrize("name,fault", [(n, f) for n, fs in FAULTS.items()
                                        for f in fs],
                         ids=lambda x: getattr(x, "__name__", x))
def test_a_broken_program_is_not_correct(name, fault, tiny_route,
                                         monkeypatch):
    fault(monkeypatch)
    res, _ = tiny_run(name, seconds=0.3)
    assert res["correct"] is False, res["checks"]


@pytest.mark.cuda
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, str(ROOT / "portbench/run.py"),
                        "--workload", "stir.rans.stream", "--seed",
                        str(2 ** 31 + 5), "--seconds", "2", "--trace", "1"],
                       capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["busy_s"] > 0


def test_reference_index_table_reads_stored_blocks():
    idx = np.arange(1000, dtype=np.int32) % 15
    from portbench import reference
    got = reference.index_table([control.v0_blob(idx, 4)], idx.size, 4)
    assert (got == idx).all()
