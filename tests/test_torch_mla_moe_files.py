"""The port's MLA and MoE models in training and in files, against the
JAX package, on the CPU.

``lm_loss`` with the MoE's load-balance loss and its gradients on every
leaf (3-D MLA projections, slot-wise expert stacks; ``remat="block"``
carrying the aux through ``torch.utils.checkpoint``), ``compress_grads``
of those gradients bit for bit; an MLA session file (bfloat16 latent
cache) byte-identical both ways and resumed in the other engine; a MoE
train state checkpointed by either trainer and restored by the other.
Configs and helpers are tests/test_torch_mla_moe.py's.

Tolerances: the loss within 1e-4 and the gradients within 1e-4 of each
leaf's largest magnitude (the frameworks sum matmuls and softmaxes in
other orders); files and restored states exact.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.core.types import NumarckParams as JParams  # noqa: E402
from repro.data.tokens import TokenPipeline as JPipe  # noqa: E402
from repro.kernels import rans as jrans  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.train import gradcomp as jgc  # noqa: E402
from repro.train import optim as jopt  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core.tree import leaves_with_keys  # noqa: E402
from repro_torch.core.types import NumarckParams  # noqa: E402
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.kernels import rans as trans  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train import gradcomp, optim  # noqa: E402
from repro_torch.train.trainer import (Trainer, TrainerConfig,  # noqa: E402
                                       loss_and_grads)
from test_torch_mla_moe import F32_TOL, GRAD_TOL, _cfgs, _ref_params  # noqa: E402


def _jkeys(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tkeys(tree):
    return {k: v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)
            for k, v in leaves_with_keys(tree)}


@pytest.mark.parametrize("name,remat", [("mla_f32", "none"),
                                        ("mla_f32", "block"),
                                        ("moe_f32", "block"),
                                        ("moe_drop", "none")])
def test_lm_loss_and_grads_match_jax(name, remat):
    """lm_loss (with the MoE aux) and its gradients on every leaf (3-D
    MLA projections, slot-wise expert stacks) against
    jax.value_and_grad; remat="block" carries the aux through
    torch.utils.checkpoint.  Then compress_grads of the reference's
    gradients is its own bit for bit on those leaves."""
    jcfg, cfg = _cfgs(name, remat=remat)
    jm, tm = JModel(jcfg), Model(cfg)
    jp = jax.tree.map(jnp.asarray, _ref_params(jcfg))
    batch = JPipe(cfg.vocab_size, 17, 4, seed=2).batch(0)
    batch["labels"][:, :3] = -100
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jm.loss(p, batch), has_aux=True)(jp)
    st = interop.train_state_from_reference(
        {"params": jax.device_get(jp), "opt_state": jopt.init_state(jp)},
        cfg, device="cpu")
    tl, tmet, tg = loss_and_grads(
        tm, st.params, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=F32_TOL)
    np.testing.assert_allclose(float(tmet["aux"]), float(jmet["aux"]),
                               rtol=F32_TOL)
    want, got = _jkeys(jg), _tkeys(tg)
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        np.testing.assert_allclose(got[k], w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=k)
    if remat != "none":
        return
    jh, _ = jgc.compress_grads(jg, jgc.init_state(jg), b_bits=6)
    g_np = {k: torch.from_numpy(v.copy()) for k, v in want.items()}
    th, _ = gradcomp.compress_grads(g_np, gradcomp.init_state(g_np), b_bits=6)
    for k, w in _jkeys(jh).items():
        assert np.array_equal(th[k].numpy().view(np.uint32),
                              w.view(np.uint32)), k


# ---------------------------------------------------------------------------
# files across the packages
# ---------------------------------------------------------------------------

S0, NEW = 10, 4


@pytest.fixture(scope="module")
def mla_models():
    """(jax model, jax params, port model, port params) of the reduced
    minicpm3-4b in bfloat16, the same weights in both."""
    jcfg, cfg = _cfgs("mla_bf16")
    jm, tm = JModel(jcfg), Model(cfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    return jm, jax.tree.map(jnp.asarray, tree), tm, \
        interop.model_params_from_reference(tree, cfg, device="cpu")


@pytest.mark.parametrize("codec", ["zlib", "rans"])
def test_mla_session_files_are_byte_identical_both_ways(mla_models, tmp_path,
                                                         monkeypatch, codec):
    """Each engine's bf16 MLA session ({"cache": {"attn": {ckv, krope,
    pos_map}}, tok, pos}) loaded by the other package's load_cache and
    snapshotted again gives the writer's file byte for byte (rANS on the
    device route in both, DEVICE_MIN_BYTES = 0); each file resumes in
    the other engine."""
    monkeypatch.setattr(jrans, "DEVICE_MIN_BYTES", 0)
    monkeypatch.setattr(trans, "DEVICE_MIN_BYTES", 0)
    jm, jp, tm, tp = mla_models
    prompts = np.random.default_rng(1).integers(
        0, tm.cfg.vocab_size, (2, S0)).astype(np.int32)
    jeng = jengine.Engine(jm, jp, 2, 24, keep_session=True)
    teng = engine.Engine(tm, tp, 2, 24, device="cpu", keep_session=True)
    jeng.generate(prompts, max_new=NEW)
    teng.generate(prompts, max_new=NEW)
    jpath, tpath = tmp_path / "j.nck", tmp_path / "t.nck"
    jeng.save_session(str(jpath), codec=codec)
    teng.save_session(str(tpath), codec=codec)
    assert set(teng.last_cache["attn"]) == {"ckv", "krope", "pos_map"}
    assert teng.last_cache["attn"]["ckv"].dtype == torch.bfloat16
    engine.snapshot_cache(engine.load_cache(str(jpath), device="cpu"),
                          str(tmp_path / "jt.nck"), codec)
    jengine.snapshot_cache(jengine.load_cache(str(tpath)),
                           str(tmp_path / "tj.nck"), codec)
    assert (tmp_path / "jt.nck").read_bytes() == jpath.read_bytes()
    assert (tmp_path / "tj.nck").read_bytes() == tpath.read_bytes()
    jrest = jeng.resume(max_new=NEW)
    trest = teng.resume(max_new=NEW)
    port = engine.Engine(tm, tp, 2, 24, device="cpu")
    port.generate(prompts, max_new=1)
    port.load_session(str(jpath))
    np.testing.assert_array_equal(port.resume(max_new=NEW), jrest)
    other = jengine.Engine(jm, jp, 2, 24)
    other.generate(prompts, max_new=1)
    other.load_session(str(tpath))
    np.testing.assert_array_equal(other.resume(max_new=NEW), trest)


# A narrow MoE (mixtral's topology: 4 experts, top-2, split 2, a window)
# whose embedding alone reaches the manager's floor for lossy deltas.
MOE_SMALL = dict(d_model=32, d_ff=32, n_heads=2, n_kv_heads=1, vocab_size=128)
TCFG = dict(grad_compression_bits=6, checkpoint_every=2)
CKPT_E = 1e-4


def _opt():
    return dict(lr=3e-3, warmup_steps=5, decay_steps=60)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_moe_train_state_restores_in_the_other_package(tmp_path, writer):
    """Four steps of one trainer with gradient compression (every expert
    stack through compress_grads), checkpointed at 2 and 4: the other
    package's restore_or_init gives the writer's own restore leaf for
    leaf."""
    jcfg, cfg = _cfgs("moe_f32", **MOE_SMALL)
    jm, tm = JModel(jcfg), Model(cfg)
    if writer == "jax":
        tr = JTrainer(jm, JTrainerConfig(opt=jopt.AdamWConfig(**_opt()),
                                         **TCFG),
                      checkpoint_manager=JManager(
                          str(tmp_path), JParams(error_bound=CKPT_E),
                          anchor_every=2))
        tr.fit(tr.init_state(jax.random.PRNGKey(0)),
               iter(JPipe(128, 17, 4)), n_steps=4, log=lambda *_: None)
    else:
        tr = Trainer(tm, TrainerConfig(opt=optim.AdamWConfig(**_opt()),
                                       **TCFG),
                     checkpoint_manager=CheckpointManager(
                         str(tmp_path), NumarckParams(error_bound=CKPT_E),
                         anchor_every=2, device="cpu"), device="cpu")
        tr.fit(tr.init_state(0), iter(TokenPipeline(128, 17, 4)),
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
    want, got = _jkeys(jstate.tree()), _tkeys(tstate.tree())
    assert list(got) == list(want)
    assert "params/layers/mlp/we_down" in got
    assert "gc_state/.residual/layers/mlp/router" in got
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        assert np.array_equal(np.atleast_1d(got[k]).view(np.uint8),
                              np.atleast_1d(w).view(np.uint8)), k
