"""The port's SSM (mamba2) and hybrid (hymba) families in files, against
the JAX package, on the CPU.

bfloat16 session files (mamba2's stacked float32 SSD state; hymba's
per-layer list of attention caches and SSD states, its prompt past the
window) byte-identical both ways with zlib and rANS, the port restoring
the JAX file's session bit for bit; float32 sessions resumed in the other
engine to the writer's tokens; train states checkpointed by either
trainer (gradient compression on every SSD leaf) restored by the other.
Configs and helpers are tests/test_torch_ssm.py's; everything here is
exact.
"""
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.core.types import NumarckParams as JParams  # noqa: E402
from repro.data.tokens import TokenPipeline as JPipe  # noqa: E402
from repro.kernels import rans as jrans  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.train import optim as jopt  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core.tree import leaves_with_keys  # noqa: E402
from repro_torch.core.types import NumarckParams  # noqa: E402
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.kernels import rans as trans  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from test_torch_ssm import _both, _cfgs, _jkeys  # noqa: E402

S0, NEW = 40, 4


def _engines(family, dtype):
    jcfg, cfg, jp, tp = _both(family, dtype=dtype)
    jm, tm = JModel(jcfg), Model(cfg)
    s_max = S0 + 3 * NEW
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, S0)).astype(np.int32)
    return (lambda **kw: jengine.Engine(jm, jp, 2, s_max, **kw),
            lambda **kw: engine.Engine(tm, tp, 2, s_max, device="cpu", **kw),
            prompts)


@pytest.mark.parametrize("codec", ["zlib", "rans"])
@pytest.mark.parametrize("family", ["mamba2", "hymba"])
def test_session_files_are_byte_identical_both_ways(tmp_path, monkeypatch,
                                                    family, codec):
    """Each engine's bfloat16 session (mamba2: the stacked float32
    {"ssm": {conv, h}}; hymba: the per-layer list of {"attn", "ssm"},
    its 40-token prompt past the window) loaded by the other package's
    load_cache and snapshotted again gives the writer's file byte for
    byte (rANS on the device route in both, DEVICE_MIN_BYTES = 0), and
    the port's engine restores the JAX file's session bit for bit (as
    the JAX package reads it)."""
    monkeypatch.setattr(jrans, "DEVICE_MIN_BYTES", 0)
    monkeypatch.setattr(trans, "DEVICE_MIN_BYTES", 0)
    jengine_, tengine, prompts = _engines(family, "bfloat16")
    jeng, teng = jengine_(keep_session=True), tengine(keep_session=True)
    jeng.generate(prompts, max_new=NEW)
    teng.generate(prompts, max_new=NEW)
    jpath, tpath = tmp_path / "j.nck", tmp_path / "t.nck"
    jeng.save_session(str(jpath), codec=codec)
    teng.save_session(str(tpath), codec=codec)
    keys = {k for k, _ in leaves_with_keys(teng.last_cache)}
    assert ({"ssm/conv", "ssm/h"} <= keys if family == "mamba2"
            else {"0/ssm/h", "1/attn/k", "1/ssm/conv"} <= keys)
    engine.snapshot_cache(engine.load_cache(str(jpath), device="cpu"),
                          str(tmp_path / "jt.nck"), codec)
    jengine.snapshot_cache(jengine.load_cache(str(tpath)),
                           str(tmp_path / "tj.nck"), codec)
    assert (tmp_path / "jt.nck").read_bytes() == jpath.read_bytes()
    assert (tmp_path / "tj.nck").read_bytes() == tpath.read_bytes()
    port = tengine()
    port.generate(prompts, max_new=1)            # records the template
    port.load_session(str(jpath))
    want = _jkeys(jengine.load_cache(str(jpath)))
    got = dict(leaves_with_keys(port._session.tree))
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and \
            str(g.dtype).removeprefix("torch.") == str(w.dtype), k
        assert np.array_equal(
            np.atleast_1d(g.view(torch.int16).numpy() if g.dtype ==
                          torch.bfloat16 else g.numpy()).view(np.uint8),
            np.atleast_1d(w).view(np.uint8)), k


@pytest.mark.parametrize("family", ["mamba2", "hymba"])
def test_sessions_resume_in_the_other_engine(tmp_path, monkeypatch, family):
    """A float32 session saved by either engine (rANS, device route)
    resumes in the other package's engine to the writer's own tokens.
    (float32: a bfloat16 stream can part at a near-tie of two logits.)"""
    monkeypatch.setattr(jrans, "DEVICE_MIN_BYTES", 0)
    monkeypatch.setattr(trans, "DEVICE_MIN_BYTES", 0)
    jengine_, tengine, prompts = _engines(family, "float32")
    jeng, teng = jengine_(keep_session=True), tengine(keep_session=True)
    np.testing.assert_array_equal(teng.generate(prompts, max_new=NEW),
                                  jeng.generate(prompts, max_new=NEW))
    jpath, tpath = str(tmp_path / "j.nck"), str(tmp_path / "t.nck")
    jeng.save_session(jpath, codec="rans")
    teng.save_session(tpath, codec="rans")
    jrest, trest = jeng.resume(max_new=NEW), teng.resume(max_new=NEW)
    port = tengine()
    port.generate(prompts, max_new=1)
    port.load_session(jpath)
    np.testing.assert_array_equal(port.resume(max_new=NEW), jrest)
    other = jengine_()
    other.generate(prompts, max_new=1)
    other.load_session(tpath)
    np.testing.assert_array_equal(other.resume(max_new=NEW), trest)


TCFG = dict(grad_compression_bits=6, checkpoint_every=2)
CKPT_E = 1e-4


def _opt():
    return dict(lr=3e-3, warmup_steps=5, decay_steps=60)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("family", ["mamba2", "hymba"])
def test_train_state_restores_in_the_other_package(tmp_path, family, writer):
    """Four steps of one trainer with gradient compression (every SSD
    leaf through compress_grads), checkpointed at 2 and 4: the other
    package's restore_or_init gives the writer's own restore leaf for
    leaf."""
    jcfg, cfg = _cfgs(family)
    jm, tm = JModel(jcfg), Model(cfg)
    V = cfg.vocab_size
    if writer == "jax":
        tr = JTrainer(jm, JTrainerConfig(opt=jopt.AdamWConfig(**_opt()),
                                         **TCFG),
                      checkpoint_manager=JManager(
                          str(tmp_path), JParams(error_bound=CKPT_E),
                          anchor_every=2))
        tr.fit(tr.init_state(jax.random.PRNGKey(0)),
               iter(JPipe(V, 17, 4)), n_steps=4, log=lambda *_: None)
    else:
        tr = Trainer(tm, TrainerConfig(opt=optim.AdamWConfig(**_opt()),
                                       **TCFG),
                     checkpoint_manager=CheckpointManager(
                         str(tmp_path), NumarckParams(error_bound=CKPT_E),
                         anchor_every=2, device="cpu"), device="cpu")
        tr.fit(tr.init_state(0), iter(TokenPipeline(V, 17, 4)),
               n_steps=4, log=lambda *_: None)
    assert sorted(os.listdir(tmp_path)) == [
        "MANIFEST.json", "step_00000002.nck", "step_00000004.nck"]
    jtr = JTrainer(jm, JTrainerConfig(opt=jopt.AdamWConfig(**_opt()), **TCFG),
                   checkpoint_manager=JManager(str(tmp_path)))
    jstate, jstep = jtr.restore_or_init(jax.random.PRNGKey(5))
    ttr = Trainer(tm, TrainerConfig(opt=optim.AdamWConfig(**_opt()), **TCFG),
                  checkpoint_manager=CheckpointManager(str(tmp_path),
                                                       device="cpu"),
                  device="cpu")
    tstate, tstep = ttr.restore_or_init(5)
    assert jstep == tstep == 4
    want = {k: np.asarray(v) for k, v in _jkeys(jstate.tree()).items()}
    got = {k: v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)
           for k, v in leaves_with_keys(tstate.tree())}
    assert list(got) == list(want)
    assert "params/layers/ssm/A_log" in got
    assert "gc_state/.residual/layers/ssm/in_proj" in got
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        assert np.array_equal(np.atleast_1d(got[k]).view(np.uint8),
                              np.atleast_1d(w).view(np.uint8)), k
