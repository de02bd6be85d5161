"""The port's training path against the JAX package's, on the CPU.

A tiny float32 model (2 layers, d = 64, vocab 128; tests/test_train.py's)
and the same seeded data go through both: the token pipeline (bit for
bit), the train state's checkpoint keys, ``lm_loss`` and its gradients,
gradient compression (``quantize_dequantize``, ``compress_grads``: bit
for bit but ``alpha``), AdamW, 10-step ``fit``s, checkpoints written by
one trainer and restored by the other, step files of the same state
(byte for byte), and the ``launch/train.py`` driver.  Reference
parameters enter the port through ``interop.train_state_from_reference``.

Tolerances, each with its reason:
  * loss and gradients: 1e-5 of the leaf's largest magnitude (the two
    frameworks sum matmuls and softmaxes in other orders: ulps through
    two layers);
  * ``alpha``: 1e-6 relative (a float32 mean; the sums run in other
    orders);
  * one AdamW step: 1e-6 relative, 1e-9 absolute (the global norm is a
    float32 sum in another order, and ``pow``/``cos`` are each library's
    own);
  * losses of a 10-step fit: 1e-5 relative without gradient compression
    (the reference jits the step and XLA contracts its multiply-adds to
    fmas), 1e-4 with it (an ulp in a gradient can move a value across a
    bin edge).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.core.types import NumarckParams as JParams  # noqa: E402
from repro.data.tokens import TokenPipeline as JPipe  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.train import gradcomp as jgc  # noqa: E402
from repro.train import optim as jopt  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core.tree import leaves_with_keys  # noqa: E402
from repro_torch.core.types import NumarckParams  # noqa: E402
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.kernels import hist  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.train import gradcomp, optim  # noqa: E402
from repro_torch.train.trainer import (Trainer, TrainerConfig,  # noqa: E402
                                       loss_and_grads)

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128,
            dtype="float32")
GRAD_TOL = 1e-5
ALPHA_RTOL = 1e-6
FIT_RTOL = {0: 1e-5, 6: 1e-4}
QUIET = dict(log=lambda *_: None)


# Narrower still for the checkpoint tests: only the embedding reaches the
# manager's 4,096-element floor for lossy deltas (its m, v and residual
# are the delta's lossy leaves), which keeps the reference's eager delta
# encode short.
SMALL = dict(TINY, n_heads=2, n_kv_heads=1, d_model=32, d_ff=32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny model's ops are microseconds long: torch's intra-op
    threads only contend, most of all beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def models(kw=TINY):
    return JModel(JConfig(**kw)), Model(ModelConfig(**kw))


def jkeys(tree) -> dict:
    """key -> numpy leaf, keyed as the reference's checkpoint manager
    keys jax's tree paths."""
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path):
            leaf if isinstance(leaf, jax.ShapeDtypeStruct) else np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def tkeys(tree) -> dict:
    return {k: (v.detach().numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in leaves_with_keys(tree)}


def port_state(jtrainer, cfg, seed=0):
    """The reference trainer's initial state, carried into the port."""
    js = jtrainer.init_state(jax.random.PRNGKey(seed))
    return interop.train_state_from_reference(jax.device_get(js.tree()),
                                              cfg, device="cpu")


def opt_cfg(**kw):
    return dict(lr=3e-3, warmup_steps=5, decay_steps=60, **kw)


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 1), (11, 250)])
def test_token_batches_match_jax(seed, step):
    want = JPipe(128, 33, 4, seed=seed).batch(step)
    got = TokenPipeline(128, 33, 4, seed=seed).batch(step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    it = TokenPipeline(128, 33, 4, seed=seed).from_step(step)
    np.testing.assert_array_equal(next(it)["tokens"], want["tokens"])


@pytest.mark.parametrize("bits", [0, 6])
def test_train_state_keys_shapes_and_dtypes_match_jax(bits):
    """TrainState.tree() of both trainers: the reference's keys
    (``opt_state/.step``, ``opt_state/.m/...``), shapes and dtypes."""
    jm, tm = models()
    tcfg = dict(grad_compression_bits=bits)
    want = jkeys(jax.eval_shape(lambda: JTrainer(
        jm, JTrainerConfig(**tcfg)).init_state(jax.random.PRNGKey(0))
        .tree()))
    got = tkeys(Trainer(tm, TrainerConfig(**tcfg), device="cpu")
                .init_state(0).tree())
    assert list(got) == list(want)
    assert "opt_state/.step" in got and "opt_state/.m/layers/attn/wq" in got
    assert ("gc_state/.residual/embed" in got) == bool(bits)
    for k in want:
        assert got[k].shape == want[k].shape and \
            got[k].dtype == want[k].dtype, k


@pytest.mark.parametrize("variant", ["plain", "masked", "remat"])
def test_lm_loss_and_grads_match_jax(variant):
    """lm_loss and its gradients against jax.value_and_grad of the
    reference: -100 labels masked, remat="block" recomputing layers."""
    import dataclasses
    jm, tm = models()
    if variant == "remat":
        jm = JModel(dataclasses.replace(jm.cfg, remat="block"))
        tm = Model(dataclasses.replace(tm.cfg, remat="block"))
    jp = jm.init(jax.random.PRNGKey(1))
    batch = JPipe(128, 33, 8, seed=2).batch(0)
    if variant == "masked":
        batch["labels"][:, :5] = -100
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jm.loss(p, batch), has_aux=True)(jp)
    st = interop.train_state_from_reference(
        {"params": jax.device_get(jp), "opt_state": jopt.init_state(jp)},
        tm.cfg, device="cpu")
    tl, tmet, tg = loss_and_grads(
        tm, st.params, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=GRAD_TOL)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=GRAD_TOL)
    assert float(tmet["aux"]) == float(jmet["aux"]) == 0.0
    want, got = jkeys(jg), tkeys(tg)
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        np.testing.assert_allclose(got[k], w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=k)


def grad_case(kind: str, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "gaussian":
        return rng.normal(0, 1e-2, (64, 300)).astype(np.float32)
    if kind == "clustered":
        return np.concatenate([np.zeros(3000), rng.normal(1e-2, 1e-4, 1000),
                               rng.normal(-1e-2, 1e-4, 1000)]
                              ).astype(np.float32)
    if kind == "outliers":
        return np.concatenate([rng.normal(0, 1e-3, 5000),
                               [5.0, -7.0]]).astype(np.float32)
    if kind == "constant":
        return np.full((33, 7), 0.25, np.float32)
    return np.zeros(512, np.float32)


def same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        np.array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("b_bits", [4, 6])
@pytest.mark.parametrize("kind", ["gaussian", "clustered", "outliers",
                                  "constant", "zero"])
def test_quantize_dequantize_matches_jax(kind, b_bits):
    g = grad_case(kind)
    jh, jinfo = jgc.quantize_dequantize(jnp.asarray(g), b_bits=b_bits)
    hist.KERNEL.launches = 0
    th, tinfo = gradcomp.quantize_dequantize(torch.from_numpy(g.copy()),
                                             b_bits=b_bits)
    assert same_bits(th.numpy(), jh)
    np.testing.assert_allclose(float(tinfo["alpha"]), float(jinfo["alpha"]),
                               rtol=ALPHA_RTOL)
    assert hist.KERNEL.launches == 0          # the CPU takes the plain one


@pytest.mark.parametrize("b_bits", [4, 6])
def test_compress_grads_matches_jax(b_bits):
    """Three error-feedback steps over a tree of every kind: g_hat and
    the residual bit for bit at each."""
    tree = {k: grad_case(k, seed=i) for i, k in enumerate(
        ["gaussian", "clustered", "outliers", "constant", "zero"])}
    jstate = jgc.init_state(tree)
    tstate = gradcomp.init_state({k: torch.from_numpy(v.copy())
                                  for k, v in tree.items()})
    for step in range(3):
        g = {k: v * np.float32(1 + step) for k, v in tree.items()}
        jh, jstate = jgc.compress_grads(g, jstate, b_bits=b_bits)
        th, tstate = gradcomp.compress_grads(
            {k: torch.from_numpy(v) for k, v in g.items()}, tstate,
            b_bits=b_bits)
        for k in tree:
            assert same_bits(th[k].numpy(), jh[k]), (step, k)
            assert same_bits(tstate.residual[k].numpy(),
                             jstate.residual[k]), (step, k)


def test_wire_bits_matches_jax():
    for b_bits, alpha in ((6, 0.02), (4, 0.5)):
        assert gradcomp.wire_bits(torch.zeros(1000), b_bits, alpha) == \
            jgc.wire_bits(np.zeros(1000, np.float32), b_bits, alpha)


def test_schedule_and_apply_updates_match_jax():
    jc, tc = jopt.AdamWConfig(), optim.AdamWConfig()
    steps = [0, 1, 5, 50, 99, 100, 101, 2500, 9999, 10_000, 20_000]
    got = [float(optim.schedule(tc, torch.tensor(s, dtype=torch.int32)))
           for s in steps]
    want = [float(jopt.schedule(jc, jnp.int32(s))) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)

    rng = np.random.default_rng(4)
    params = {"w": rng.normal(0, 0.02, (32, 48)).astype(np.float32),
              "layers": {"s": np.ones((2, 48), np.float32),
                         "w": rng.normal(0, 0.02, (2, 48, 16))
                         .astype(np.float32)},
              "b": rng.normal(0, 1, 48).astype(np.float32)}
    grads = jax.tree.map(lambda p: rng.normal(0, 1, p.shape)
                         .astype(np.float32), params)
    cfg = dict(lr=1e-2, warmup_steps=2, decay_steps=20)
    jstate = jopt.init_state(params)._replace(
        step=jnp.int32(3),
        m=jax.tree.map(lambda g: 0.1 * g, grads),
        v=jax.tree.map(lambda g: 0.01 * g * g + 1e-6, grads))
    jp, js, jmet = jopt.apply_updates(params, grads, jstate,
                                      jopt.AdamWConfig(**cfg))
    def t(tree):
        return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)

    tp, ts, tmet = optim.apply_updates(
        t(params), t(grads), optim.AdamState(
            torch.tensor(3, dtype=torch.int32), t(jstate.m), t(jstate.v)),
        optim.AdamWConfig(**cfg))
    assert ts.step.dtype == torch.int32 and int(ts.step) == int(js.step) == 4
    for name in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[name]), float(jmet[name]),
                                   rtol=1e-6)
    for label, got, want in (("params", tp, jp), ("m", ts.m, js.m),
                             ("v", ts.v, js.v)):
        want, got = jkeys(want), tkeys(got)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=1e-9, err_msg=f"{label} {k}")


# The fits beyond the dense TINY model: the smoke configs of the MLA, MoE
# (at its drop-free smoke capacity and at the full configs' 1.25), SSM and
# hybrid families.
FIT_ARCHS = {"mla": ("minicpm3-4b", {}), "moe": ("mixtral-8x7b", {}),
             "moe_cf125": ("mixtral-8x7b", {"capacity_factor": 1.25}),
             "ssm": ("mamba2-780m", {}), "hybrid": ("hymba-1.5b", {})}


def fit_models(family):
    if family == "dense":
        return models()
    import dataclasses
    from repro.configs import get_smoke_config as jsmoke
    from repro_torch.configs import get_smoke_config
    arch, kw = FIT_ARCHS[family]
    return (JModel(dataclasses.replace(jsmoke(arch), **kw)),
            Model(dataclasses.replace(get_smoke_config(arch), **kw)))


@pytest.mark.parametrize("family,bits", [
    pytest.param("dense", 0, id="0"), pytest.param("dense", 6, id="6")] + [
    pytest.param(f, b, id=f"{f}-{b}") for f in FIT_ARCHS for b in (0, 6)])
def test_fit_matches_jax(family, bits):
    """Ten steps of both trainers from the same initial parameters and
    batches: the losses within FIT_RTOL, for the dense model and the
    MLA, MoE, SSM and hybrid families."""
    jm, tm = fit_models(family)
    V = tm.cfg.vocab_size
    jt = JTrainer(jm, JTrainerConfig(opt=jopt.AdamWConfig(**opt_cfg()),
                                     grad_compression_bits=bits))
    tt = Trainer(tm, TrainerConfig(opt=optim.AdamWConfig(**opt_cfg()),
                                   grad_compression_bits=bits),
                 device="cpu")
    state = port_state(jt, tm.cfg)
    _, _, want = jt.fit(jt.init_state(jax.random.PRNGKey(0)),
                        iter(JPipe(V, 33, 8)), n_steps=10, **QUIET)
    hist.KERNEL.launches = 0
    state, step, got = tt.fit(state, iter(TokenPipeline(V, 33, 8)),
                              n_steps=10, **QUIET)
    assert step == 10 and int(state.opt_state.step) == 10
    np.testing.assert_allclose(got, want, rtol=FIT_RTOL[bits])
    assert hist.KERNEL.launches == 0


def test_trainer_runs_on_cuda_unless_asked(monkeypatch):
    """Without a GPU the trainer, the train-state converter and the
    driver raise unless asked for the CPU; nothing falls back."""
    from repro_torch.launch import train as launch_train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, model = models()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(model)
    state = Trainer(model, device="cpu").init_state(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.train_state_from_reference(
            interop.train_state_to_reference(state), model.cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "llama3.2-1b", "--smoke"])


# -- port copies of tests/test_train.py --------------------------------------

def pipeline(B=8, S=32, seed=0):
    return TokenPipeline(TINY["vocab_size"], S + 1, B, seed=seed)


def test_loss_decreases():
    _, model = models()
    tr = Trainer(model, TrainerConfig(opt=optim.AdamWConfig(**opt_cfg())),
                 device="cpu")
    state = tr.init_state(0)
    state, step, hist_ = tr.fit(state, iter(pipeline()), n_steps=60, **QUIET)
    assert float(np.mean(hist_[-5:])) < float(np.mean(hist_[:5])) - 0.3


def test_restart_resumes_from_checkpoint(tmp_path):
    _, model = models()
    tcfg = TrainerConfig(opt=optim.AdamWConfig(lr=1e-3, warmup_steps=2,
                                               decay_steps=50),
                         checkpoint_every=5)
    pipe = pipeline()
    mgr = CheckpointManager(str(tmp_path), NumarckParams(error_bound=1e-4),
                            anchor_every=2, keep=5, device="cpu")
    tr = Trainer(model, tcfg, checkpoint_manager=mgr, device="cpu")
    state, step, hist_ = tr.fit(tr.init_state(1), iter(pipe), n_steps=10,
                                **QUIET)
    assert step == 10
    # a crash: a new trainer restores and resumes the data stream there
    tr2 = Trainer(model, tcfg, device="cpu",
                  checkpoint_manager=CheckpointManager(str(tmp_path),
                                                       device="cpu"))
    state2, start = tr2.restore_or_init(99)
    assert start == 10
    assert isinstance(state2.opt_state, optim.AdamState)
    assert state2.opt_state.step.dtype == torch.int32
    assert int(state2.opt_state.step) == 10
    state2, step2, hist2 = tr2.fit(state2, pipe.from_step(start),
                                   start_step=start, n_steps=15, **QUIET)
    assert step2 == 15 and np.isfinite(hist2).all()
    assert hist2[0] < hist_[0], (hist2[0], hist_[0])


def test_grad_compression_converges():
    _, model = models()
    tr = Trainer(model, TrainerConfig(opt=optim.AdamWConfig(**opt_cfg()),
                                      grad_compression_bits=6), device="cpu")
    state, step, hist_ = tr.fit(tr.init_state(0), iter(pipeline()),
                                n_steps=60, **QUIET)
    assert float(np.mean(hist_[-5:])) < float(np.mean(hist_[:5])) - 0.25


# -- checkpoints across the two packages -------------------------------------

TCFG = dict(grad_compression_bits=6, checkpoint_every=2)
CKPT_E = 1e-4


def jax_trainer(jm, ckpt):
    return JTrainer(jm, JTrainerConfig(opt=jopt.AdamWConfig(**opt_cfg()),
                                       **TCFG), checkpoint_manager=ckpt)


def port_trainer(tm, ckpt):
    return Trainer(tm, TrainerConfig(opt=optim.AdamWConfig(**opt_cfg()),
                                     **TCFG), checkpoint_manager=ckpt,
                   device="cpu")


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Four steps of the reference trainer with gradient compression,
    checkpointed at 2 (an anchor) and 4 (a delta): its directory and the
    host copy of each state it saved."""
    d = tmp_path_factory.mktemp("jax_ckpt")
    saved = {}

    class Recording(JManager):
        def save(self, step, tree, blocking=None):
            saved[step] = jax.device_get(tree)
            return super().save(step, tree, blocking)

    jm, _ = models(SMALL)
    tr = jax_trainer(jm, Recording(str(d), JParams(error_bound=CKPT_E),
                                   anchor_every=2))
    tr.fit(tr.init_state(jax.random.PRNGKey(0)), iter(JPipe(128, 33, 8)),
           n_steps=4, **QUIET)
    return d, saved


def jax_restore(jm, d):
    tr = jax_trainer(jm, JManager(str(d)))
    state, step = tr.restore_or_init(jax.random.PRNGKey(5))
    return step, jkeys(state.tree())


def port_restore(tm, d):
    tr = port_trainer(tm, CheckpointManager(str(d), device="cpu"))
    state, step = tr.restore_or_init(5)
    assert isinstance(state.opt_state, optim.AdamState)
    assert isinstance(state.gc_state, gradcomp.GradCompState)
    return step, tkeys(state.tree())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_trainer_checkpoints_restore_in_the_other_package(tmp_path, jax_run,
                                                          writer):
    """Four steps (an anchor at 2, a delta at 4) written by one trainer
    restore through the other's restore_or_init to the writer's own
    restore, leaf for leaf, keys, shapes and dtypes included."""
    jm, tm = models(SMALL)
    d = jax_run[0]
    if writer == "port":
        d = tmp_path
        tr = port_trainer(tm, CheckpointManager(
            str(d), NumarckParams(error_bound=CKPT_E), anchor_every=2,
            device="cpu"))
        tr.fit(tr.init_state(0), iter(pipeline()), n_steps=4, **QUIET)
        assert sorted(os.listdir(d)) == ["MANIFEST.json",
                                         "step_00000002.nck",
                                         "step_00000004.nck"]
    (js, want), (ts, got) = jax_restore(jm, d), port_restore(tm, d)
    assert js == ts == 4
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert same_bits(got[k], want[k]) if want[k].dtype == np.float32 \
            else np.array_equal(got[k], want[k]), k


def test_step_files_of_a_train_state_match_jax(tmp_path, jax_run):
    """The reference trainer's saved states, carried into the port and
    saved by the port's manager: the step files (an anchor and a delta,
    keys ``opt_state/.m/...``) and the manifest equal the reference's
    byte for byte."""
    d, saved = jax_run
    _, tm = models(SMALL)
    mgr = CheckpointManager(str(tmp_path), NumarckParams(error_bound=CKPT_E),
                            anchor_every=2, device="cpu")
    for step, tree in sorted(saved.items()):
        mgr.save(step, interop.train_state_from_reference(
            tree, tm.cfg, device="cpu").tree())
    names = sorted(os.listdir(d))
    assert names == ["MANIFEST.json", "step_00000002.nck",
                     "step_00000004.nck"]
    assert names == sorted(os.listdir(tmp_path))
    for n in names:
        assert (tmp_path / n).read_bytes() == (d / n).read_bytes(), n


def test_interop_round_trip_and_params_to_reference(jax_run):
    _, tm = models(SMALL)
    want = jax_run[1][4]
    state = interop.train_state_from_reference(want, tm.cfg, device="cpu")
    back = interop.train_state_to_reference(state)
    assert isinstance(back["opt_state"], optim.AdamState)
    assert isinstance(back["gc_state"], gradcomp.GradCompState)
    got, ref = jkeys(back), jkeys(want)
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k])
    lm_ = interop.model_params_from_reference(want["params"], tm.cfg,
                                              device="cpu")
    again = jkeys(interop.model_params_to_reference(lm_))
    assert list(again) == list(jkeys(want["params"]))
    for k, v in jkeys(want["params"]).items():
        np.testing.assert_array_equal(again[k], v)
    bad = dict(want, params=dict(want["params"], extra=np.zeros(3)))
    with pytest.raises(ValueError, match="extra"):
        interop.train_state_from_reference(bad, tm.cfg, device="cpu")


def test_launch_train_runs_and_restarts(tmp_path, capsys):
    """launch/train.py in a subprocess, then again in this process on
    the same checkpoint directory: the second run restores the first's
    final checkpoint and goes on to --steps."""
    from repro_torch.launch import train as launch_train
    args = ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2", "--batch",
            "4", "--seq", "16"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *args, "--steps", "3"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "done at step 3" in out.stdout
    assert "final checkpoint saved" in out.stdout
    launch_train.main(args + ["--steps", "5"])
    printed = capsys.readouterr().out
    assert "restored checkpoint at step 3" in printed
    assert "done at step 5" in printed
