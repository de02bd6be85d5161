"""Tests for repro-torch-lint, the port's AST invariant checker: each of
the reference's ``tests/test_analysis.py`` cases in its torch form.

Fixture modules under ``tests/fixtures/lint_torch/`` seed known-good and
known-bad shapes for each pass; the CLI tests run the committed baseline
(``repro-torch-lint.baseline.json``: the port must lint clean) and the
acceptance demo -- a fresh violation seeded into a copy of the port makes
``repro-torch-lint`` exit nonzero.
"""
import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from repro_torch.analysis import (
    LintPass,
    Violation,
    all_passes,
    get_pass,
    load_project,
    register_pass,
)
from repro_torch.analysis import baseline as baseline_mod
from repro_torch.analysis.cli import main as cli_main
from repro_torch.analysis.cli import run_lint

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(TESTS_DIR)
FIXTURES = os.path.join(TESTS_DIR, "fixtures", "lint_torch")

ALL_RULES = {
    "concurrency-discipline",
    "dtype-hazard",
    "format-closure",
    "host-sync-in-device-path",
    "jit-cache-hygiene",
    "retry-discipline",
}


def run_rule(rule, fixture):
    project = load_project([os.path.join(FIXTURES, fixture)], root=FIXTURES)
    return get_pass(rule)().run(project)


def lines_of(violations):
    return sorted(v.line for v in violations)


def marked(fixture, mark="# violation"):
    """Lines of `fixture` carrying `mark`."""
    with open(os.path.join(FIXTURES, fixture)) as fh:
        return [i for i, line in enumerate(fh, 1) if mark in line]


# --------------------------------------------------------------- registry

def test_registry_has_all_shipped_passes():
    rules = [cls.rule for cls in all_passes()]
    assert rules == sorted(ALL_RULES)


def test_get_pass_unknown_rule_raises():
    with pytest.raises(ValueError, match="unknown lint rule"):
        get_pass("no-such-rule")


def test_register_pass_rejects_duplicate_rule():
    class Imposter(LintPass):
        rule = "host-sync-in-device-path"

    with pytest.raises(ValueError, match="duplicate lint rule"):
        register_pass(Imposter)


def test_register_pass_idempotent_for_same_class():
    cls = get_pass("dtype-hazard")
    assert register_pass(cls) is cls


def test_port_registry_is_its_own():
    """The port's passes are not the reference's classes: importing one
    package registers nothing in the other."""
    from repro.analysis import get_pass as ref_get_pass
    for rule in ALL_RULES:
        assert get_pass(rule) is not ref_get_pass(rule)
        assert get_pass(rule).__module__.startswith("repro_torch.")


# ------------------------------------------------------------- host sync

def test_host_sync_flags_syncs_in_device_resident_functions():
    vs = run_rule("host-sync-in-device-path", "bad_host_sync.py")
    # np.asarray, .item(), torch.cuda.synchronize, float(x[...]), .cpu(),
    # .tolist(), int(torch.argmin(...)) in encode_device; .numpy() in the
    # per-shard stage analyze_device.
    assert lines_of(vs) == marked("bad_host_sync.py") \
        == [9, 10, 11, 12, 17, 18, 19, 25]
    scopes = {v.scope for v in vs}
    assert scopes == {"encode_device", "analyze_device"}


def test_host_sync_ignores_plain_scalars_host_helpers_and_gated_syncs():
    vs = run_rule("host-sync-in-device-path", "bad_host_sync.py")
    # float(1.5), int(a.b_bits), the telemetry-gated synchronize and
    # host_helper's asarray / .item() must not be flagged.
    exempt = (marked("bad_host_sync.py", "NOT a violation")
              + marked("bad_host_sync.py", "exempt"))
    assert len(exempt) == 4
    assert not set(exempt) & set(lines_of(vs))


def test_device_resident_registry_names_exist_in_the_port():
    """Every registered name is a function of the port (the reference's
    names that exist here and the port's per-shard stage)."""
    from repro_torch.analysis.passes.host_sync import DEVICE_RESIDENT_NAMES
    project = load_project([os.path.join(REPO_ROOT, "src", "repro_torch")],
                           root=REPO_ROOT)
    defined = {fi.name for sf in project.files for fi in sf.functions}
    assert set(DEVICE_RESIDENT_NAMES) <= defined
    assert "analyze_device" in DEVICE_RESIDENT_NAMES


def test_device_resident_decorator_extends_the_registry(tmp_path):
    p = tmp_path / "custom.py"
    p.write_text(textwrap.dedent("""\
        from repro_torch.analysis import device_resident

        @device_resident
        def my_custom_stage(x):
            return x.cpu()

        def undecorated(x):
            return x.cpu()
        """))
    project = load_project([str(p)], root=str(tmp_path))
    vs = get_pass("host-sync-in-device-path")().run(project)
    assert [v.scope for v in vs] == ["my_custom_stage"]


# ----------------------------------------------------------- suppressions

def test_suppressions_same_line_prev_line_and_def_line():
    vs = run_rule("host-sync-in-device-path", "suppressed_host_sync.py")
    assert vs == []


def test_suppression_is_rule_specific(tmp_path):
    p = tmp_path / "wrongrule.py"
    p.write_text(textwrap.dedent("""\
        def encode_device(x):
            return x.item()  # repro-lint: disable=jit-cache-hygiene
        """))
    project = load_project([str(p)], root=str(tmp_path))
    vs = get_pass("host-sync-in-device-path")().run(project)
    assert lines_of(vs) == [2]


def test_suppression_comma_list_covers_multiple_rules(tmp_path):
    p = tmp_path / "multi.py"
    p.write_text(textwrap.dedent("""\
        import numpy as np

        def encode_device(x):
            # repro-lint: disable=host-sync-in-device-path, dtype-hazard
            return x.cpu(), np.dtype(x.dtype)
        """))
    project = load_project([str(p)], root=str(tmp_path))
    for rule in ("host-sync-in-device-path", "dtype-hazard"):
        assert get_pass(rule)().run(project) == []


# -------------------------------------------------------------- jit cache

def test_jit_cache_flags_per_call_traces_only():
    vs = run_rule("jit-cache-hygiene", "bad_jit.py")
    # lambda compile in _encode, loop-body trace, unkeyed script and
    # CUDA graph stores in __init__.
    assert lines_of(vs) == marked("bad_jit.py") == [22, 29, 49, 50]


def test_jit_cache_sanctions_module_scope_and_keyed_stores():
    vs = run_rule("jit-cache-hygiene", "bad_jit.py")
    flagged = set(lines_of(vs))
    # decorators (8, 13), module assignment (18), keyed two-step CDLL
    # (39, 40) and the keyed load_inline store (44).
    assert not {8, 13, 18, 39, 40, 44} & flagged
    assert not set(marked("bad_jit.py", "sanctioned")) & flagged


def test_jit_cache_lambda_message_names_the_retrace():
    vs = run_rule("jit-cache-hygiene", "bad_jit.py")
    lam = [v for v in vs if v.line == 22]
    assert len(lam) == 1 and "lambda" in lam[0].message


def test_jit_cache_passes_the_kernel_library_cache():
    """``kernels/_build.library`` keeps each CDLL in ``_libs[name]``."""
    project = load_project(
        [os.path.join(REPO_ROOT, "src", "repro_torch", "kernels",
                      "_build.py")], root=REPO_ROOT)
    assert get_pass("jit-cache-hygiene")().run(project) == []


# ------------------------------------------------------------ concurrency

def test_concurrency_flags_all_three_contracts():
    vs = run_rule("concurrency-discipline", "bad_concurrency.py")
    assert lines_of(vs) == marked("bad_concurrency.py") == [14, 15, 26, 39]


def test_concurrency_allows_gated_and_labelled_shapes():
    vs = run_rule("concurrency-discipline", "bad_concurrency.py")
    flagged = set(lines_of(vs))
    # list.append under lock (21), holds_gil-gated pool use (32),
    # labelled submit (40) all pass.
    assert not {21, 32, 40} & flagged


# ---------------------------------------------------------- dtype hazards

def test_dtype_flags_the_ports_hazards():
    vs = run_rule("dtype-hazard", "bad_dtype.py")
    # >>, +, <, // on uint32; np.dtype(step.dtype); set_default_dtype
    assert lines_of(vs) == marked("bad_dtype.py") == [8, 9, 10, 11, 21, 29]


def test_dtype_exempts_int64_words_and_step_dtype():
    vs = run_rule("dtype-hazard", "bad_dtype.py")
    flagged = set(lines_of(vs))
    assert not set(marked("bad_dtype.py", "# fine")) & flagged


@pytest.mark.parametrize("flags,messages", [
    (None, ["lacks `-prec-sqrt=true`", "has `--use_fast_math`"]),
    ('("-O3", "-prec-div=true", "-prec-sqrt=true", "-ftz=false", '
     '"-fmad=false")', []),
    ('("-prec-div=true", "-prec-sqrt=true", "-ftz=false")',
     ["lacks `-fmad=false`"]),
])
def test_dtype_holds_the_kernels_nvcc_flags(tmp_path, flags, messages):
    """The fixture's build lost -prec-sqrt and gained --use_fast_math;
    the port's own ``kernels/_build.py`` keeps all four."""
    if flags is None:
        vs = run_rule("dtype-hazard", "kernels/_build.py")
    else:
        (tmp_path / "kernels").mkdir()
        (tmp_path / "kernels" / "_build.py").write_text(
            f"NVCC_FLAGS = {flags}\n")
        project = load_project([str(tmp_path)], root=str(tmp_path))
        vs = get_pass("dtype-hazard")().run(project)
    assert sorted(m for v in vs for m in messages if m in v.message) \
        == sorted(messages)
    assert len(vs) == len(messages)
    project = load_project(
        [os.path.join(REPO_ROOT, "src", "repro_torch", "kernels",
                      "_build.py")], root=REPO_ROOT)
    assert get_pass("dtype-hazard")().run(project) == []


# --------------------------------------------------------------- baseline

def _seed_violations():
    return run_rule("host-sync-in-device-path", "bad_host_sync.py")


def test_baseline_save_load_round_trip(tmp_path):
    vs = _seed_violations()
    bl = tmp_path / "baseline.json"
    baseline_mod.save(str(bl), vs)
    loaded = baseline_mod.load(str(bl))
    assert sorted(loaded) == sorted({v.fingerprint() for v in vs})
    new, stale = baseline_mod.diff(vs, loaded)
    assert new == [] and stale == []


def test_baseline_fingerprint_ignores_line_numbers():
    v = _seed_violations()[0]
    moved = Violation(rule=v.rule, path=v.path, line=v.line + 40,
                      scope=v.scope, message=v.message)
    new, stale = baseline_mod.diff([moved], [v.fingerprint()])
    assert new == [] and stale == []


def test_baseline_diff_reports_new_and_stale():
    vs = _seed_violations()
    known = [v.fingerprint() for v in vs[:-1]]
    new, stale = baseline_mod.diff(vs, known)
    assert new == [vs[-1]] and stale == []
    new, stale = baseline_mod.diff(vs[:-1], [v.fingerprint() for v in vs])
    assert new == [] and stale == [vs[-1].fingerprint()]


def test_baseline_missing_file_is_empty():
    assert baseline_mod.load("/nonexistent/baseline.json") == []


# --------------------------------------------------------- format closure

def test_format_closure_flags_unsanctioned_renames():
    vs = run_rule("format-closure", "bad_publish.py")
    assert lines_of(vs) == [18, 22]
    assert {v.scope for v in vs} == {"sloppy_publish", "sloppy_rename"}
    assert all("atomic_commit" in v.message for v in vs)


def _port_container_violations():
    project = load_project(
        [os.path.join(REPO_ROOT, "src", "repro_torch", "core",
                      "container.py")], root=REPO_ROOT)
    return get_pass("format-closure")().run(project)


def test_format_closure_manifest_magic_is_closed():
    # The port's container: _MANIFEST_MAGIC (NCKM) has a reader branch
    # and a port test fixture.
    vs = _port_container_violations()
    assert not [v for v in vs if "_MANIFEST_MAGIC" in v.message], vs


def test_format_closure_checksum_frame_is_closed():
    # The NCK4 checksum frame ("crc32" / "block_crc32") has writer
    # stores, reader loads and a port test.
    vs = _port_container_violations()
    assert not [v for v in vs if "checksum key" in v.message], vs


def test_format_closure_reads_the_ports_tests_only(tmp_path):
    """A magic that only the reference's tests exercise is unclosed in
    the port: the magic-in-tests check reads tests/test_torch_*.py."""
    src = tmp_path / "src" / "repro_torch" / "core"
    src.mkdir(parents=True)
    (src / "container.py").write_text(
        '_MAGIC_V1 = b"NCKZ"\n_MAGICS = {_MAGIC_V1: 1}\n'
        "_W = {1: _MAGIC_V1}\n")
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_container.py").write_text('M = b"NCKZ"\n')
    (tmp_path / "tests" / "test_torch_other.py").write_text("x = 1\n")
    project = load_project([str(tmp_path / "src")], root=str(tmp_path))
    vs = get_pass("format-closure")().run(project)
    assert [v.message for v in vs] == [
        "container magic `_MAGIC_V1` (NCKZ) has no test fixture "
        "exercising it"]
    (tmp_path / "tests" / "test_torch_other.py").write_text(
        'M = b"NCKZ"\n')
    assert get_pass("format-closure")().run(project) == []


def test_format_closure_blob_versions_and_key_canon_are_closed():
    """The port's rANS blob versions and telemetry records."""
    project = load_project([os.path.join(REPO_ROOT, "src", "repro_torch")],
                           root=REPO_ROOT)
    vs = get_pass("format-closure")().run(project)
    assert vs == []


# -------------------------------------------------------- retry discipline

def test_retry_discipline_flags_unbounded_sleep_loops():
    vs = run_rule("retry-discipline", "bad_retry.py")
    assert {v.scope for v in vs} == {"wait_for_file", "poll_until_ready"}
    assert all("unbounded retry loop" in v.message for v in vs)


def test_retry_discipline_allows_bounded_and_exiting_loops():
    vs = run_rule("retry-discipline", "bad_retry.py")
    scopes = {v.scope for v in vs}
    assert "bounded_ok" not in scopes
    assert "exit_edge_ok" not in scopes


# ------------------------------------------------------------------- CLI

def test_cli_repo_is_clean_against_committed_baseline(capsys):
    # The acceptance gate: the port has zero NEW violations.
    rc = cli_main(["--root", REPO_ROOT])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "0 new violation(s)" in out


def test_cli_committed_baseline_has_no_stale_entries(capsys):
    rc = cli_main(["--root", REPO_ROOT])
    out = capsys.readouterr().out
    assert rc == 0
    assert "0 stale" in out


def test_module_entry_point_exits_zero_on_the_port():
    """``python -m repro_torch.analysis`` from the repo root: the port
    against its committed baseline."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO_ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis"],
                         cwd=REPO_ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 new violation(s)" in out.stdout


def test_seeded_item_in_encode_device_exits_nonzero(tmp_path, capsys):
    """The acceptance demo on the port itself: a copy of the port with a
    `.item()` seeded into core/compress.encode_device fails against the
    committed baseline."""
    dst = tmp_path / "src" / "repro_torch"
    shutil.copytree(os.path.join(REPO_ROOT, "src", "repro_torch"), dst,
                    ignore=shutil.ignore_patterns("__pycache__", "csrc"))
    path = dst / "core" / "compress.py"
    src = path.read_text()
    anchor = "    tele = telemetry.enabled()\n"
    i = src.index(anchor, src.index("def encode_device("))
    path.write_text(src[:i] + "    curr.item()\n" + src[i:])
    bl = os.path.join(REPO_ROOT, baseline_mod.DEFAULT_BASELINE)
    rc = cli_main([str(dst), "--root", str(tmp_path), "--baseline", bl])
    out = capsys.readouterr().out
    assert rc == 1, out
    assert "`.item()` in device-resident function `encode_device`" in out


def test_cli_seeded_violation_exits_nonzero(tmp_path, capsys):
    # A compile in a per-call body and a .cpu() in encode_device must turn
    # the build red.
    p = tmp_path / "seeded.py"
    p.write_text(textwrap.dedent("""\
        import torch

        def encode_device(x):
            return x.cpu()

        def quant_step(x):
            return torch.compile(lambda y: y + 1)(x)
        """))
    rc = cli_main([str(p), "--root", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 1
    assert "host-sync-in-device-path" in out
    assert "jit-cache-hygiene" in out


def test_cli_select_narrows_to_one_rule(tmp_path, capsys):
    p = tmp_path / "seeded.py"
    p.write_text("def encode_device(x):\n"
                 "    return x.item()\n")
    rc = cli_main([str(p), "--root", str(tmp_path),
                   "--select", "jit-cache-hygiene"])
    assert rc == 0            # the host-sync finding is out of scope
    rc = cli_main([str(p), "--root", str(tmp_path),
                   "--select", "host-sync-in-device-path"])
    capsys.readouterr()
    assert rc == 1


def test_cli_write_baseline_then_clean_then_regress(tmp_path, capsys):
    p = tmp_path / "seeded.py"
    p.write_text("def encode_device(x):\n"
                 "    return x.cpu()\n")
    assert cli_main([str(p), "--root", str(tmp_path),
                     "--write-baseline"]) == 0
    bl = tmp_path / baseline_mod.DEFAULT_BASELINE
    assert bl.exists()
    payload = json.loads(bl.read_text())
    assert len(payload["entries"]) == 1
    # Accepted: the same tree now lints clean.
    assert cli_main([str(p), "--root", str(tmp_path)]) == 0
    # A NEW violation alongside the baselined one still fails.
    p.write_text(p.read_text()
                 + "\ndef decompress_step_device(x):\n"
                   "    return x.item()\n")
    capsys.readouterr()
    rc = cli_main([str(p), "--root", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 1
    assert "decompress_step_device" in out


def test_cli_stale_entries_warn_but_do_not_fail(tmp_path, capsys):
    p = tmp_path / "clean.py"
    p.write_text("def host_helper(x):\n    return x\n")
    bl = tmp_path / baseline_mod.DEFAULT_BASELINE
    baseline_mod.save(str(bl), [Violation(
        rule="host-sync-in-device-path", path="clean.py", line=2,
        scope="encode_device", message="host sync `.cpu()` ...")])
    rc = cli_main([str(p), "--root", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "stale baseline entry" in out


def test_cli_no_baseline_reports_accepted_violations():
    rc = cli_main(["--root", REPO_ROOT, "--no-baseline",
                   "--select", "host-sync-in-device-path"])
    # The port has accepted boundary syncs (encode_device's analyze-stage
    # fetches); without the baseline they surface (and the exit goes red).
    assert rc == 1


def test_cli_list_rules_prints_catalogue(capsys):
    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in ALL_RULES:
        assert rule in out


def test_run_lint_sorts_by_path_line_rule():
    vs = run_lint([FIXTURES], root=FIXTURES)
    keys = [(v.path, v.line, v.rule) for v in vs]
    assert keys == sorted(keys)
    assert {v.rule for v in vs} == ALL_RULES
