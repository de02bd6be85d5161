"""The port's serving engine against the JAX package's, on the CPU.

Greedy generation gives the JAX engine's tokens (each compared step's
top-2 logit margin above the float32 tolerance, so a tie cannot pass as
agreement); ``snapshot_cache`` of one numpy tree (float32, int32, a 0-d
int32 and a bfloat16 leaf) writes byte-identical NCK files in both
packages, with zlib and with rANS; a session file saved by either engine
loads in the other and resumes to the same tokens.  Then the engine's
own contract, as tests/test_serve.py holds the reference's: resume after
save/load, consecutive resumes without keep_session, a bare snapshot
refused, resume without a session, determinism, sampling, and the port's
strict session template (the reference's "no retrace" check).  A
subprocess with ml_dtypes blocked saves and loads a bfloat16 session and
checkpoint leaf through the port alone, byte-identical to files the JAX
package wrote.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.core.types import NumarckParams as JParams  # noqa: E402
from repro.kernels import rans as jrans  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.model import build as jbuild  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import container  # noqa: E402
from repro_torch.kernels import rans as trans  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = 1e-4
ARCH = "llama3.2-1b"
S0, NEW = 10, 6


@pytest.fixture(scope="module")
def models():
    """(jax model, jax params, port model, port params) at the reduced
    float32 config, the same weights in both."""
    jmodel = jbuild(ARCH, smoke=True)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    model = build(ARCH, smoke=True)
    params = interop.model_params_from_reference(tree, model.cfg,
                                                 device="cpu")
    return jmodel, jparams, model, params


def _prompts(cfg, B, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S0)).astype(np.int32)


def _engine(models, B=2, s_max=32, **kw):
    _, _, model, params = models
    return engine.Engine(model, params, B, s_max, device="cpu", **kw)


def _jengine(models, B=2, s_max=32, **kw):
    jmodel, jparams, _, _ = models
    return jengine.Engine(jmodel, jparams, B, s_max, **kw)


def _margins(models, prompts, toks):
    """Top-2 logit margin of each greedy step, from the JAX model fed its
    own tokens."""
    jmodel, jparams, _, _ = models
    logits, cache, pos = jlm.prefill(jparams, jmodel.cfg,
                                     tokens=prompts, s_max=32)
    out = []
    for i in range(toks.shape[1]):
        top2 = np.sort(np.asarray(logits[:, -1]), axis=-1)[:, -2:]
        out.append(top2[:, 1] - top2[:, 0])
        logits, cache = jlm.decode_step(jparams, jmodel.cfg, cache,
                                        token=toks[:, i:i + 1], pos=pos)
        pos = pos + 1
    return np.stack(out, axis=1)


def test_greedy_tokens_match_jax(models):
    prompts = _prompts(models[2].cfg, 2, seed=0)
    want = _jengine(models).generate(prompts, max_new=NEW)
    eng = _engine(models)
    got = eng.generate(prompts, max_new=NEW)
    assert got.dtype == np.int32 and got.shape == (2, NEW)
    np.testing.assert_array_equal(got, want)
    assert (_margins(models, prompts, want) > F32_TOL).all()
    assert eng.stats.tokens_out == 2 * NEW and eng.stats.tokens_per_s > 0


def _tree():
    rng = np.random.default_rng(7)
    return {"cache": {"attn": {
        "k": rng.standard_normal((2, 3, 40, 8)).astype(ml_dtypes.bfloat16),
        "v": rng.standard_normal((2, 3, 40, 8)).astype(np.float32),
        "pos_map": np.arange(80, dtype=np.int32).reshape(2, 40)}},
        "tok": np.array([[3], [4]], np.int32), "pos": np.int32(17)}


def _bf16_tensor(a):
    return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)


@pytest.mark.parametrize("codec", ["zlib", "rans"])
def test_snapshot_files_are_byte_identical(tmp_path, monkeypatch, codec):
    """One numpy tree through both snapshot_cache's (the port also from
    tensors, bf16 as torch.bfloat16): the same file bytes; the rANS
    device route on in both (DEVICE_MIN_BYTES = 0).  The port loads the
    file back bit for bit, bf16 as torch.bfloat16."""
    monkeypatch.setattr(jrans, "DEVICE_MIN_BYTES", 0)
    monkeypatch.setattr(trans, "DEVICE_MIN_BYTES", 0)
    tree = _tree()
    jstats = jengine.snapshot_cache(tree, str(tmp_path / "j.nck"), codec)
    tstats = engine.snapshot_cache(tree, str(tmp_path / "t.nck"), codec)
    ttree = {"cache": {"attn": {
        "k": _bf16_tensor(tree["cache"]["attn"]["k"]),
        "v": torch.from_numpy(tree["cache"]["attn"]["v"]),
        "pos_map": torch.from_numpy(tree["cache"]["attn"]["pos_map"])}},
        "tok": torch.from_numpy(tree["tok"]),
        "pos": torch.tensor(17, dtype=torch.int32)}
    engine.snapshot_cache(ttree, str(tmp_path / "tt.nck"), codec)
    want = (tmp_path / "j.nck").read_bytes()
    assert (tmp_path / "t.nck").read_bytes() == want
    assert (tmp_path / "tt.nck").read_bytes() == want
    assert tstats == jstats
    back = engine.load_cache(str(tmp_path / "j.nck"), device="cpu")
    k = back["cache"]["attn"]["k"]
    assert k.dtype == torch.bfloat16
    assert torch.equal(k.view(torch.int16), ttree["cache"]["attn"]["k"].view(
        torch.int16))
    assert back["pos"].dim() == 0 and int(back["pos"]) == 17
    assert back["tok"].dtype == torch.int32


def _sessions_equal(a, b):
    for (ka, la), (kb, lb) in zip(engine._tree_keys(a), engine._tree_keys(b)):
        assert ka == kb and la.dtype == lb.dtype and la.shape == lb.shape
        assert torch.equal(la.view(torch.uint8) if la.dim() else la,
                           lb.view(torch.uint8) if lb.dim() else lb), ka


@pytest.mark.parametrize("codec", ["zlib", "rans"])
def test_sessions_load_across_packages(models, tmp_path, monkeypatch, codec):
    """A JAX save_session file resumes in the port's engine to the JAX
    resume's tokens, and a port file in the JAX engine to the port's."""
    monkeypatch.setattr(jrans, "DEVICE_MIN_BYTES", 0)
    monkeypatch.setattr(trans, "DEVICE_MIN_BYTES", 0)
    prompts = _prompts(models[2].cfg, 2, seed=1)
    jpath, tpath = str(tmp_path / "j.nck"), str(tmp_path / "t.nck")
    jsaver = _jengine(models, keep_session=True)
    jsaver.generate(prompts, max_new=NEW)
    jsaver.save_session(jpath, codec=codec)
    jrest = jsaver.resume(max_new=NEW)
    tsaver = _engine(models, keep_session=True)
    tsaver.generate(prompts, max_new=NEW)
    tsaver.save_session(tpath, codec=codec)
    trest = tsaver.resume(max_new=NEW)
    np.testing.assert_array_equal(trest, jrest)

    port = _engine(models)
    port.generate(prompts, max_new=2)           # records the template
    port.load_session(jpath)
    np.testing.assert_array_equal(port.resume(max_new=NEW), jrest)
    jax_eng = _jengine(models)
    jax_eng.generate(prompts, max_new=2)
    jax_eng.load_session(tpath)
    np.testing.assert_array_equal(jax_eng.resume(max_new=NEW), trest)


def test_session_save_load_resume(models, tmp_path):
    """A restored session continues the stream exactly where it stopped,
    on the engine's device, with the template's shapes and dtypes."""
    p = _prompts(models[2].cfg, 1, seed=2)
    full = _engine(models, B=1).generate(p, max_new=10)
    eng = _engine(models, B=1, keep_session=True)
    first = eng.generate(p, max_new=5)
    path = str(tmp_path / "sess.nck")
    assert eng.save_session(path)["orig_bytes"] > 0
    saved = eng._session.to_host()
    eng2 = _engine(models, B=1, keep_session=True)
    eng2.generate(p, max_new=5)
    eng2.load_session(path)
    _sessions_equal(eng2._session.tree, saved)
    assert eng2.last_pos.dim() == 0 and eng2.last_tok.shape == (1, 1)
    assert eng2.last_cache["attn"]["k"].device.type == "cpu"
    rest = eng2.resume(max_new=5)
    np.testing.assert_array_equal(np.concatenate([first, rest], axis=1),
                                  full)


def test_resume_advances_without_keep_session(models, tmp_path):
    p = _prompts(models[2].cfg, 1, seed=3)
    full = _engine(models, B=1, s_max=24).generate(p, max_new=9)
    saver = _engine(models, B=1, s_max=24, keep_session=True)
    first = saver.generate(p, max_new=3)
    path = str(tmp_path / "s.nck")
    saver.save_session(path)
    eng = _engine(models, B=1, s_max=24)          # keep_session=False
    eng.generate(p, max_new=2)
    assert eng.last_cache is None
    eng.load_session(path)
    a = eng.resume(max_new=3)
    b = eng.resume(max_new=3)                     # continues, not replays
    np.testing.assert_array_equal(np.concatenate([first, a, b], axis=1),
                                  full)


def test_load_session_rejects_bare_cache_snapshot(models, tmp_path):
    eng = _engine(models, B=1, s_max=16)
    path = str(tmp_path / "old.nck")
    engine.snapshot_cache({"layer0": np.zeros((2, 2), np.float32)}, path)
    with pytest.raises(ValueError, match="session file"):
        eng.load_session(path)


def test_resume_without_session_raises(models):
    eng = _engine(models, B=1, s_max=16)
    with pytest.raises(RuntimeError, match="no session"):
        eng.resume(max_new=2)
    with pytest.raises(RuntimeError, match="no session cache"):
        eng.save_session("unused.nck")


def test_load_session_without_template_raises(models, tmp_path):
    saver = _engine(models, B=1, s_max=16, keep_session=True)
    saver.generate(_prompts(models[2].cfg, 1, seed=4), max_new=2)
    path = str(tmp_path / "s.nck")
    saver.save_session(path)
    with pytest.raises(RuntimeError, match="template"):
        _engine(models, B=1, s_max=16).load_session(path)


def test_template_mismatch_raises(models, tmp_path):
    """A session saved at another s_max or batch does not fit the
    engine's template: load_session raises instead of reshaping, and
    leaves no session behind."""
    p = _prompts(models[2].cfg, 1, seed=5)
    saver = _engine(models, B=1, s_max=24, keep_session=True)
    saver.generate(p, max_new=2)
    path = str(tmp_path / "s.nck")
    saver.save_session(path)
    eng = _engine(models, B=1, s_max=16)
    eng.generate(p, max_new=2)
    with pytest.raises(ValueError, match=r"leaf 'cache/attn/k' is "
                                         r"\(2, 1, 24, 2, 16\)"):
        eng.load_session(path)
    assert eng.last_cache is None
    with pytest.raises(ValueError, match="do not match the template"):
        engine.load_cache(path, template={"tok": torch.zeros(1, 1)},
                          device="cpu")


def test_engine_deterministic_greedy(models):
    eng = _engine(models, B=1, s_max=20)
    p = _prompts(models[2].cfg, 1, seed=6)
    np.testing.assert_array_equal(eng.generate(p, max_new=6),
                                  eng.generate(p, max_new=6))


def test_sampling_is_seeded_and_in_range(models):
    """Sampling draws from an explicit generator: the same seed the same
    tokens, in range; another seed other tokens."""
    cfg = models[2].cfg
    p = _prompts(cfg, 2, seed=7)
    eng = _engine(models)

    def run(seed):
        return eng.generate(p, max_new=8, greedy=False,
                            generator=torch.Generator().manual_seed(seed))
    a, b, c = run(0), run(0), run(1)
    assert a.shape == (2, 8) and a.dtype == np.int32
    assert (a >= 0).all() and (a < cfg.vocab_size).all()
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    logits = torch.tensor([[0.0, 50.0, 0.0], [0.0, 0.0, 50.0]])
    gen = torch.Generator().manual_seed(3)
    assert engine.sample(logits, gen).tolist() == [1, 2]


def test_engine_refuses_parameters_elsewhere(models):
    _, _, model, params = models
    with pytest.raises(ValueError, match="the engine runs on"):
        engine.Engine(model, params, 1, 16, device="meta")


# ---------------------------------------------------------------------------
# bfloat16 without ml_dtypes
# ---------------------------------------------------------------------------

_NO_ML_DTYPES = r"""
import sys
sys.modules["ml_dtypes"] = None          # blocked before any import
import json, os
import numpy as np
import torch
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.types import NumarckParams
from repro_torch.serve import engine

d = sys.argv[1]
bits = np.load(os.path.join(d, "k_bits.npy"))           # uint16
k = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
tree = {"cache": {"attn": {"k": k,
                           "pos_map": torch.arange(6, dtype=torch.int32)}},
        "tok": torch.tensor([[5]], dtype=torch.int32),
        "pos": torch.tensor(9, dtype=torch.int32)}
engine.snapshot_cache(tree, os.path.join(d, "port.nck"))
back = engine.load_cache(os.path.join(d, "jax.nck"), device="cpu")
assert back["cache"]["attn"]["k"].dtype == torch.bfloat16
assert torch.equal(back["cache"]["attn"]["k"].view(torch.int16),
                   k.view(torch.int16))
mgr = CheckpointManager(os.path.join(d, "port_ckpt"),
                        NumarckParams(error_bound=1e-3, block_bytes=4096),
                        device="cpu")
mgr.save(0, {"w": k, "step": np.int32(3)})
step, got = mgr.restore_latest(template={"w": torch.zeros_like(k),
                                         "step": 0})
assert step == 0 and got["w"].dtype == torch.bfloat16 and got["step"] == 3
assert torch.equal(got["w"].view(torch.int16), k.view(torch.int16))
assert "ml_dtypes" not in {m.split(".")[0] for m in sys.modules
                           if sys.modules[m] is not None}
assert not any(m.split(".")[0] in ("jax", "repro") for m in sys.modules)
print("ok")
"""


def test_bfloat16_session_and_checkpoint_without_ml_dtypes(tmp_path):
    """The JAX package writes a bf16 session snapshot and a bf16
    checkpoint leaf here; a subprocess with ml_dtypes blocked writes the
    same through the port (tensors only) and must give the same bytes,
    and reads the JAX files back as torch.bfloat16."""
    rng = np.random.default_rng(8)
    k = rng.standard_normal((1, 6, 2, 4)).astype(ml_dtypes.bfloat16)
    np.save(tmp_path / "k_bits.npy", k.view(np.uint16))
    jengine.snapshot_cache(
        {"cache": {"attn": {"k": k, "pos_map": np.arange(6, dtype=np.int32)}},
         "tok": np.array([[5]], np.int32), "pos": np.int32(9)},
        str(tmp_path / "jax.nck"))
    JManager(str(tmp_path / "jax_ckpt"), JParams(error_bound=1e-3,
                                                 block_bytes=4096)
             ).save(0, {"w": k, "step": np.int32(3)})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _NO_ML_DTYPES,
                          str(tmp_path)], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert (tmp_path / "port.nck").read_bytes() == (
        tmp_path / "jax.nck").read_bytes()
    for name in ("step_00000000.nck", "MANIFEST.json"):
        assert (tmp_path / "port_ckpt" / name).read_bytes() == (
            tmp_path / "jax_ckpt" / name).read_bytes(), name
    r = container.NCKReader(str(tmp_path / "port.nck"))
    names = json.loads(bytes(r.read_array("__names__")).decode())
    assert r.read_step("c0000").dtype == "bfloat16"
    assert names["c0000"] == "cache/attn/k"


def test_serve_spans_match_jax(models, tmp_path):
    """generate, save_session, load_session and resume under telemetry
    record the reference's span names, serve.* and the anchor spans
    under them."""
    from repro.obs import telemetry as jtelemetry
    from repro_torch.obs import telemetry

    p = _prompts(models[2].cfg, 2, seed=9)
    names = []
    for make, tele in ((_jengine, jtelemetry), (_engine, telemetry)):
        eng = make(models, keep_session=True)
        path = str(tmp_path / f"{tele.__name__}.nck")
        with tele.capture() as reg:
            eng.generate(p, max_new=2)
            eng.save_session(path)
            eng.load_session(path)
            eng.resume(max_new=2)
        names.append(reg.span_names())
    assert names[1] == names[0]
    assert {"serve.prefill", "serve.decode_loop", "serve.save_session",
            "serve.load_session"} <= set(names[1])
