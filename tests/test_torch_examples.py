"""The port's examples (``examples/torch_*.py``) against the JAX
package's (``examples/*.py``), on the CPU.

* Every example has its port counterpart, and each counterpart runs on
  CUDA unless asked: without a GPU it raises.
* quickstart and compress_simulation print the JAX examples' lines, line
  for line (the algorithm and the baselines are byte-identical to the
  reference's).  The JAX quickstart's hard-coded archive path is moved
  onto ``tmp_path`` through the module's ``TemporalArchive`` name, so it
  never races ``tests/test_system.py``'s run of the script.
* serve_lm returns (batch, max_new) tokens; its weights are torch's
  draws, so its tokens are its own.
* train_restart keeps the JAX example's checkpoint schedule: at 52 steps
  the crash at 26 restores step 25 in both, with the same manifest
  ``steps`` and ``anchors``, and the loss falls across the restart.
"""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
JAX_ARCHIVE = "/tmp/quickstart.nck"


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(capsys) -> list:
    return capsys.readouterr().out.splitlines()


def test_every_example_has_a_port_counterpart():
    names = {p.stem for p in EXAMPLES.glob("*.py")}
    ref = sorted(n for n in names if not n.startswith("torch_"))
    assert ref == ["compress_simulation", "quickstart", "serve_lm",
                   "train_restart"]
    assert sorted(n for n in names if n.startswith("torch_")) == [
        f"torch_{n}" for n in ref]


@pytest.mark.parametrize("name", ["torch_quickstart",
                                  "torch_compress_simulation",
                                  "torch_serve_lm", "torch_train_restart"])
def test_examples_run_on_cuda_unless_asked(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main([])


def test_quickstart_prints_the_jax_examples_lines(tmp_path, monkeypatch,
                                                  capsys):
    ref = _load("quickstart")
    base = ref.TemporalArchive
    moved = str(tmp_path / "quickstart.nck")

    def move(path):
        assert path == JAX_ARCHIVE, path
        return moved

    class Moved(base):
        def __init__(self, path):
            super().__init__(move(path))

        @staticmethod
        def write(path, *args, **kw):
            base.write(move(path), *args, **kw)

    monkeypatch.setattr(ref, "TemporalArchive", Moved)
    ref.main()
    want = _lines(capsys)

    port = _load("torch_quickstart")
    assert port.ARCHIVE.endswith("quickstart_torch.nck")
    monkeypatch.setattr(port, "ARCHIVE", str(tmp_path / "q_torch.nck"))
    port.main(["--device", "cpu"])
    got = _lines(capsys)
    assert len(want) == 10 and "exact ✓" in want[-2]
    assert got == want
    assert (tmp_path / "q_torch.nck").read_bytes() == Path(
        moved).read_bytes()


def test_compress_simulation_prints_the_jax_examples_lines(capsys):
    _load("compress_simulation").main()
    want = _lines(capsys)
    _load("torch_compress_simulation").main(["--device", "cpu"])
    got = _lines(capsys)
    assert len(want) == 14 and "exact ✓" in want[-1]
    assert got == want


def test_serve_lm_returns_batch_by_max_new_tokens(capsys):
    port = _load("torch_serve_lm")
    out = port.main(["--device", "cpu"])
    lines = _lines(capsys)
    assert out.shape == (4, 16) and out.dtype == np.int32
    assert ((out >= 0) & (out < 256)).all()
    assert lines[:2] == ["arch=llama3.2-1b (smoke config)",
                         "generated (4, 16) tokens"]
    assert [line.split(":")[0] for line in lines[3:]] == [
        f"  req{b}" for b in range(4)]
    out2 = port.main(["--device", "cpu", "--batch", "2", "--max-new", "5"])
    assert out2.shape == (2, 5)


def test_train_restart_keeps_the_jax_checkpoint_schedule(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    flags = ["--steps", "52", "--ckpt-dir"]
    monkeypatch.setattr(sys, "argv", ["train_restart.py", *flags,
                                      str(tmp_path / "jax")])
    _load("train_restart").main()
    want = _lines(capsys)
    ref_manifest = json.loads((tmp_path / "jax" / "MANIFEST.json")
                              .read_text())

    got = _load("torch_train_restart").main(
        [*flags, str(tmp_path / "torch"), "--device", "cpu"])
    lines = _lines(capsys)
    assert "restored step 25; resuming deterministic data stream" in want
    assert got["start"] == 25
    assert ({k: got["manifest"][k] for k in ("steps", "anchors")}
            == {k: ref_manifest[k] for k in ("steps", "anchors")}
            == {"steps": [25, 50], "anchors": [25]})
    assert got["hist2"][-1] < got["hist1"][0]
    assert len(got["hist1"]) == 26 and len(got["hist2"]) == 27
    assert lines[-1] == want[-1] == (
        "checkpoints on disk: [25, 50] (anchors: [25])")
    assert "restored step 25; resuming deterministic data stream" in lines
