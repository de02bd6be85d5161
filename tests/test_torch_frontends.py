"""The port's frontend families against the JAX package's, on the CPU.

paligemma-3b (``family="vlm"``: ``n_prefix`` patch embeddings ahead of
the text tokens under the prefix-LM mask, the inputs scaled by
``d_model**0.5`` rounded to the compute dtype) and musicgen-medium
(``frontend="frames"``: frame embeddings in place of tokens, decoded
through ``decode_step(embed=)``), at their smoke configs in float32 and
bfloat16: ``embed_inputs``, ``forward``, ``prefill`` with its cache,
teacher-forced decode steps, ``lm_loss`` and its gradients (with and
without ``remat="block"``), a few trainer steps, the prefix mask at a
prompt shorter and longer than ``n_prefix``, the interop of both trees,
``launch/train.py``'s refusal and an Engine session round trip.

One deliberate divergence is held here: the reference's ``decode_step``
looks a vlm token up unscaled, where its prefill scales it; the port
scales it as the prefill does, so its ``decode_step(token=t)`` is the
reference's ``decode_step(embed=scaled embed[t])``, and
``test_reference_vlm_token_decode_diverges_from_its_prefill`` records
the reference's own fault.

Tolerances as tests/test_torch_models.py's: float32 1e-4, bfloat16 5e-2;
gradients within 1e-4 of each leaf's largest magnitude.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.config import reduced as jreduced  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.train import optim as jopt  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import rans as trans  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.config import reduced  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.trainer import (Trainer, TrainerConfig,  # noqa: E402
                                       loss_and_grads)
from test_torch_models import (BF16_TOL, F32_TOL, _assert_cache_close,  # noqa: E402
                               _close, _np, _ref_params, _t)

GRAD_TOL = 1e-4
VLM, AUDIO = "paligemma-3b", "musicgen-medium"
# name -> (arch, reduced() overrides); the smoke configs' widths
CONFIGS = {
    "vlm_f32": (VLM, {}),
    "vlm_bf16": (VLM, {"dtype": "bfloat16"}),
    "audio_f32": (AUDIO, {}),
    "audio_bf16": (AUDIO, {"dtype": "bfloat16"}),
}


def _cfgs(name, **extra):
    arch, kw = CONFIGS[name]
    return (jreduced(jget_config(arch), **kw, **extra),
            reduced(get_config(arch), **kw, **extra))


def _both(name, seed=0, **extra):
    jcfg, cfg = _cfgs(name, **extra)
    tree = _ref_params(jcfg, seed)
    return (jcfg, cfg, jax.tree.map(jnp.asarray, tree),
            interop.model_params_from_reference(tree, cfg, device="cpu"))


def _tol(cfg):
    return BF16_TOL if cfg.dtype == "bfloat16" else F32_TOL


def _inputs(cfg, B, T, seed):
    """(embeds float32 numpy or None, tokens int32 numpy or None) of a
    T-position input: frames (B, T, d); or n_prefix patches and T -
    n_prefix text tokens."""
    rng = np.random.default_rng(seed)
    n_emb = T if cfg.frontend == "frames" else cfg.n_prefix
    emb = rng.standard_normal((B, n_emb, cfg.d_model)).astype(np.float32)
    toks = (None if cfg.frontend == "frames" else rng.integers(
        0, cfg.vocab_size, (B, T - n_emb)).astype(np.int32))
    return emb, toks


def _jin(cfg, emb, toks):
    """The reference's (tokens, extra_embeds) arguments."""
    dt = jnp.dtype(cfg.dtype)
    return (None if toks is None else jnp.asarray(toks),
            None if emb is None else jnp.asarray(emb).astype(dt))


def _tin(cfg, emb, toks):
    dt = getattr(torch, cfg.dtype)
    return (None if toks is None else _t(toks).long(),
            None if emb is None else _t(emb).to(dt))


def _cosine(a, b):
    a, b = _np(a).ravel().astype(np.float64), _np(b).ravel().astype(
        np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [VLM, AUDIO])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_inputs_match_jax_exactly(arch, dtype):
    """embed_inputs at paligemma's full width d = 2048: the patch prefix
    and the token embeddings concatenated, a vlm's scaled by
    sqrt(2048) rounded to the compute dtype (45.25 in bfloat16); equal,
    not close."""
    jcfg = dataclasses.replace(jget_config(arch), dtype=dtype,
                               vocab_size=40)
    cfg = dataclasses.replace(get_config(arch), dtype=dtype, vocab_size=40)
    rng = np.random.default_rng(1)
    table = rng.standard_normal((40, cfg.d_model)).astype(np.float32)
    emb, toks = (rng.standard_normal((2, 3, cfg.d_model)).astype(np.float32),
                 rng.integers(0, 40, (2, 5)).astype(np.int32))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    for e, t in ((emb, toks), (emb, None), (None, toks)):
        want = jlm.embed_inputs({"embed": jnp.asarray(table).astype(jdt)},
                                jcfg, *_jin(jcfg, e, t))
        got = lm.embed_inputs(SimpleNamespace(embed=_t(table).to(tdt)), cfg,
                              *_tin(cfg, e, t))
        assert got.dtype == tdt and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(_np(got), _np(want))
    if dtype == "bfloat16":
        assert L._weak_scalar(2048 ** 0.5, torch.bfloat16) == 45.25


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_prefill_and_decode_match_jax(name):
    """forward logits over embeds (+ tokens), prefill logits and every
    cache leaf, then six teacher-forced decode steps against the JAX
    model: musicgen through decode_step(embed=) in both, paligemma
    through the port's decode_step(token=) against the reference's
    decode_step(embed=) of the scaled token embedding."""
    jcfg, cfg, jparams, params = _both(name)
    tol = _tol(cfg)
    B, T, n_dec = 2, 13, 6
    emb, toks = _inputs(cfg, B, T, seed=4)
    got, _ = lm.forward(params, cfg, *_tin(cfg, emb, toks))
    want, _ = jlm.forward(jparams, jcfg, *_jin(jcfg, emb, toks))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert want.shape == (B, T, cfg.vocab_size)
    _close(got, want, tol)

    s_max = T + n_dec
    glog, gcache, gpos = lm.prefill(params, cfg, *_tin(cfg, emb, toks),
                                    s_max=s_max)
    wlog, wcache, wpos = jlm.prefill(jparams, jcfg, *_jin(jcfg, emb, toks),
                                     s_max=s_max)
    _close(glog, wlog, tol)
    assert int(gpos) == int(wpos) == T
    _assert_cache_close(gcache, wcache, tol)

    rng = np.random.default_rng(5)
    for _ in range(n_dec):
        if cfg.frontend == "frames":
            e = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
            glog, gcache = lm.decode_step(params, cfg, gcache, pos=gpos,
                                          embed=_tin(cfg, e, None)[1])
            wlog, wcache = jlm.decode_step(jparams, jcfg, wcache, pos=wpos,
                                           embed=_jin(jcfg, e, None)[1])
        else:
            tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
            glog, gcache = lm.decode_step(params, cfg, gcache,
                                          token=_t(tok).long(), pos=gpos)
            scaled = jlm.embed_inputs(jparams, jcfg, tokens=jnp.asarray(tok))
            wlog, wcache = jlm.decode_step(jparams, jcfg, wcache, pos=wpos,
                                           embed=scaled)
        _close(glog, wlog, tol)
        gpos, wpos = gpos + 1, wpos + 1
    _assert_cache_close(gcache, wcache, tol)


def _decode_vs_prefill(prefill, decode, emb, toks):
    """(the last logits of a prefill over the whole input, those of a
    prefill without its last text token followed by that token's decode
    step)."""
    full, _, _ = prefill(toks, emb)
    _, cache, pos = prefill(toks[:, :-1], emb)
    step, _ = decode(cache, toks[:, -1:], pos)
    return full, step


def test_reference_vlm_token_decode_diverges_from_its_prefill():
    """The reference's fault: its decode_step looks a vlm token up
    unscaled (lm.py:314-317) where its prefill scales the input by
    d_model**0.5, so a token decoded after the prompt disagrees with the
    prefill over the same tokens (cosine < 0.99 at the smoke config).
    The port's decode scales the token and agrees (1e-4)."""
    jcfg, cfg, jparams, params = _both("vlm_f32")
    emb, toks = _inputs(cfg, 2, 20, seed=6)
    ref = _cosine(*_decode_vs_prefill(
        lambda t, e: jlm.prefill(jparams, jcfg, tokens=t, extra_embeds=e,
                                 s_max=20),
        lambda c, t, p: jlm.decode_step(jparams, jcfg, c, token=t, pos=p),
        *_jin(jcfg, emb, toks)[::-1]))
    assert ref < 0.99, ref
    full, step = _decode_vs_prefill(
        lambda t, e: lm.prefill(params, cfg, t, e, s_max=20),
        lambda c, t, p: lm.decode_step(params, cfg, c, token=t, pos=p),
        *_tin(cfg, emb, toks)[::-1])
    _close(step, full, F32_TOL)
    assert _cosine(step, full) > 0.9999


@pytest.mark.parametrize("T", [5, 8, 14], ids=["short", "equal", "long"])
def test_prefix_mask_matches_jax(T):
    """A token-only prompt shorter than, as long as and longer than
    n_prefix (8): the first n_prefix positions see each other both ways,
    the rest causally.  forward and prefill logits against the JAX
    model, and the mask's reach: changing a token inside the prefix moves
    position 0's logits; changing one after it does not."""
    jcfg, cfg, jparams, params = _both("vlm_f32")
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, T)).astype(np.int32)
    got, _ = lm.forward(params, cfg, _t(toks).long())
    want, _ = jlm.forward(jparams, jcfg, tokens=jnp.asarray(toks))
    _close(got, want, F32_TOL)
    glog, gcache, _ = lm.prefill(params, cfg, _t(toks).long(), s_max=T + 2)
    wlog, wcache, _ = jlm.prefill(jparams, jcfg, tokens=jnp.asarray(toks),
                                  s_max=T + 2)
    _close(glog, wlog, F32_TOL)
    _assert_cache_close(gcache, wcache, F32_TOL)
    for p in range(1, T):
        moved = toks.copy()
        moved[:, p] = (moved[:, p] + 1) % cfg.vocab_size
        out, _ = lm.forward(params, cfg, _t(moved).long())
        changed = not torch.equal(out[:, 0], got[:, 0])
        assert changed == (p < cfg.n_prefix), p


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _batch(cfg, B, T, seed):
    """A sample batch as numpy: the reference's frontend shapes, labels
    over the text (or frame) positions, a few masked."""
    emb, toks = _inputs(cfg, B, T, seed)
    n_lab = T if cfg.frontend == "frames" else T - cfg.n_prefix
    labels = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, (B, n_lab)).astype(np.int32)
    labels[:, :2] = -100
    batch = {"embeds": emb, "labels": labels}
    if toks is not None:
        batch["tokens"] = toks
    return batch


def _jleaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): x
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jkeys(tree):
    return {k: np.asarray(x) for k, x in _jleaves(tree).items()}


@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("name", ["vlm_f32", "audio_f32"])
def test_lm_loss_and_grads_match_jax(name, remat):
    """lm_loss over the labelled positions (the patch prefix carries no
    labels; frames are labelled everywhere) and its gradients on every
    leaf against jax.value_and_grad; remat="block" runs each layer
    through torch.utils.checkpoint on inputs that carry no grad
    (musicgen's frames).  musicgen's token table is unused under frame
    inputs: its gradient is zeros in both."""
    jcfg, cfg = _cfgs(name, remat=remat)
    jm, tm = JModel(jcfg), Model(cfg)
    jp = jax.tree.map(jnp.asarray, _ref_params(jcfg))
    batch = _batch(cfg, 3, 14, seed=8)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jm.loss(p, batch), has_aux=True)(jp)
    st = interop.train_state_from_reference(
        {"params": jax.device_get(jp), "opt_state": jopt.init_state(jp)},
        cfg, device="cpu")
    tl, _, tg = loss_and_grads(
        tm, st.params, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=F32_TOL)
    want = _jkeys(jg)
    got = _jkeys(interop._to_numpy(tg))
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        np.testing.assert_allclose(got[k], w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=k)
    if cfg.frontend == "frames":
        assert not got["embed"].any() and not want["embed"].any()


@pytest.mark.parametrize("name", ["vlm_f32", "audio_f32"])
def test_fit_matches_jax(name):
    """Four steps of both trainers from the same parameters on the same
    frontend batches (gradient compression at B = 6): the losses within
    1e-4."""
    jcfg, cfg = _cfgs(name)
    jm, tm = JModel(jcfg), Model(cfg)
    kw = dict(lr=3e-3, warmup_steps=2, decay_steps=10)
    jt = JTrainer(jm, JTrainerConfig(opt=jopt.AdamWConfig(**kw),
                                     grad_compression_bits=6))
    tt = Trainer(tm, TrainerConfig(opt=optim.AdamWConfig(**kw),
                                   grad_compression_bits=6), device="cpu")
    js = jt.init_state(jax.random.PRNGKey(0))
    state = interop.train_state_from_reference(jax.device_get(js.tree()),
                                               cfg, device="cpu")
    batches = [_batch(cfg, 2, 12, seed=20 + i) for i in range(4)]
    quiet = dict(log=lambda *_: None)
    _, _, want = jt.fit(js, iter(batches), n_steps=4, **quiet)
    _, step, got = tt.fit(state, iter(batches), n_steps=4, **quiet)
    assert step == 4 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_sample_batch_has_the_reference_shapes(arch):
    """Model.sample_batch: the reference's keys, shapes and dtypes (its
    values are torch's draws), at the full config's widths."""
    cfg = dataclasses.replace(get_config(arch), n_layers=1)
    gen = torch.Generator().manual_seed(0)
    got = Model(cfg).sample_batch(gen, 2, 300)
    want = JModel(jget_config(arch)).sample_batch(jax.random.PRNGKey(0), 2,
                                                  300)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        if k == "embeds":
            assert str(got[k].dtype).removeprefix("torch.") == str(w.dtype)
        else:
            assert not got[k].is_floating_point()
            assert int(got[k].max()) < cfg.vocab_size


# ---------------------------------------------------------------------------
# interop, the driver, the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_interop_carries_both_trees(arch):
    """The full configs' reference trees (paligemma: tied, MQA with head
    dim 256; musicgen: untied, 24 MHA heads) have exactly the port's
    leaves, shapes and dtypes; the smoke bf16 tree round-trips bit for
    bit."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert (cfg.tie_embeddings, cfg.n_kv_heads, cfg.head_dim) == (
        (True, 1, 256) if arch == VLM else (False, 24, 64))
    shapes = _jleaves(jax.eval_shape(
        lambda: jlm.init_params(jax.random.PRNGKey(0), jcfg)))
    meta = lm.stack_layers(lm.LM(cfg, "meta").named_parameters())
    from repro_torch.core.tree import leaves_with_keys
    port = dict(leaves_with_keys(meta))
    assert sorted(port) == sorted(shapes)
    for k, w in shapes.items():
        assert tuple(port[k].shape) == w.shape, k
        assert str(port[k].dtype).removeprefix("torch.") == str(w.dtype), k
    assert ("unembed" in port) == (arch == AUDIO)

    name = "vlm_bf16" if arch == VLM else "audio_bf16"
    jcfg, cfg = _cfgs(name)
    tree = _ref_params(jcfg)
    back = interop.model_params_to_reference(
        interop.model_params_from_reference(tree, cfg, device="cpu"))
    want, got = _jkeys(tree), _jkeys(back)
    assert want.keys() == got.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].view(np.uint8),
                                      w.view(np.uint8), err_msg=k)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_launch_train_refuses_frontends(arch):
    """launch/train.py refuses the frontend archs with the reference's
    SystemExit message."""
    from repro_torch.launch import train as launch_train
    with pytest.raises(SystemExit, match=f"{arch}: frontend archs train "
                       "via examples/train_restart.py sample batches"):
        launch_train.main(["--arch", arch, "--smoke", "--device", "cpu"])


@pytest.mark.parametrize("codec", ["zlib", "rans"])
def test_engine_session_round_trip_on_paligemma(codec, tmp_path,
                                                monkeypatch):
    """The Engine on paligemma's smoke config serves token prompts longer
    than n_prefix (their first 8 tokens under the prefix mask): generate,
    save_session, load_session in a new engine, resume; the stream
    equals an uninterrupted run and the restored leaves are bit-exact
    (rANS with DEVICE_MIN_BYTES 0, so the device route decodes them)."""
    monkeypatch.setattr(trans, "DEVICE_MIN_BYTES", 0)
    _, cfg, _, params = _both("vlm_bf16")
    model = Model(cfg)
    prompts = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    full = engine.Engine(model, params, 2, 40, device="cpu").generate(
        prompts, max_new=12)
    eng = engine.Engine(model, params, 2, 40, keep_session=True,
                        device="cpu")
    first = eng.generate(prompts, max_new=6)
    path = str(tmp_path / "sess.nck")
    eng.save_session(path, codec=codec)
    saved = eng._session.to_host()
    eng2 = engine.Engine(model, params, 2, 40, keep_session=True,
                         device="cpu")
    eng2.generate(prompts, max_new=1)
    eng2.load_session(path)
    for (ka, a), (kb, b) in zip(engine._tree_keys(saved),
                                engine._tree_keys(eng2._session.tree)):
        assert ka == kb and a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.uint8) if a.dim() else a,
                           b.view(torch.uint8) if b.dim() else b), ka
    rest = eng2.resume(max_new=6)
    np.testing.assert_array_equal(np.concatenate([first, rest], axis=1),
                                  full)
