"""The port's SSM (mamba2) and hybrid (hymba) families against the JAX
package's, on the CPU.

The same seeded numpy weights (through ``interop``) and inputs go through
both, at the smoke widths (SSD chunk 16; hymba's window 32 beside its
global layer 0): ``ssd_apply`` at T = 40 (three chunks, the last padded)
with and without ``valid_len``, ``ssd_prefill_cache`` and ``ssd_decode``;
the port's copy of the reference's chunked-against-recurrent check; then
``forward``, ``prefill`` (logits and every cache leaf) and eight
teacher-forced ``decode_step``s of both families, hymba's prompt past its
window; ``lm_loss`` and its gradients; and, at the full configs' chunk of
256, the gradients that the reference's ``_segsum_decay`` makes NaN and
the port keeps finite.  Files across the packages are
tests/test_torch_ssm_files.py's.

The SSD-level comparisons hold the port to the reference's compiled
(``jax.jit``) program, whose bfloat16 rules the port keeps
(``models/ssm.py``); hymba's whole-model bfloat16 test holds it to both
the eager call (the reference's layer loop runs op by op) and the
jitted one.

Tolerances: float32 within rtol = atol = 1e-4 (the frameworks sum
matmuls and reductions in other orders), bfloat16 within 5e-2 (8 bits of
mantissa, products rounded at other places in the layers outside the
SSD); gradients within 1e-4 of each leaf's largest magnitude.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.data.tokens import TokenPipeline as JPipe  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.train import optim as jopt  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.tree import leaves_with_keys  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.train.trainer import loss_and_grads  # noqa: E402

F32_TOL = 1e-4
BF16_TOL = 5e-2
GRAD_TOL = 1e-4
ARCHS = {"mamba2": "mamba2-780m", "hymba": "hymba-1.5b"}


def _cfgs(family, **kw):
    """(reference, port) smoke configs of a family, with overrides."""
    arch = ARCHS[family]
    return (dataclasses.replace(jget_smoke(arch), **kw),
            dataclasses.replace(get_smoke_config(arch), **kw))


def _tol(cfg):
    return BF16_TOL if cfg.dtype == "bfloat16" else F32_TOL


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=msg)


def _ref_params(jcfg, seed=0):
    """The reference's parameters as numpy, the leaves it initialises to
    constants perturbed: norm scales, the conv bias and D."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray,
                        jlm.init_params(jax.random.PRNGKey(seed), jcfg))
    base = {"scale": 1.0, "D": 1.0, "conv_b": 0.0}

    def perturb(path, x):
        name = str(path[-1].key)
        if name in base:
            return (base[name] + 0.1 * rng.standard_normal(x.shape)
                    ).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(perturb, tree)


def _both(family, seed=0, **kw):
    jcfg, cfg = _cfgs(family, **kw)
    tree = _ref_params(jcfg, seed)
    return jcfg, cfg, jax.tree.map(jnp.asarray, tree), \
        interop.model_params_from_reference(tree, cfg, device="cpu")


def _input(cfg, shape, seed):
    """(jax, torch) copies of one N(0, 0.5^2) input in cfg.dtype."""
    x = (np.random.default_rng(seed).standard_normal(shape) * 0.5
         ).astype(np.float32)
    dt = L.cdtype(cfg)
    return jnp.asarray(x, jnp.dtype(cfg.dtype)), torch.from_numpy(x).to(dt)


def _jkeys(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# the SSD block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family,dtype", [("mamba2", "float32"),
                                          ("mamba2", "bfloat16"),
                                          ("hymba", "bfloat16")])
def test_ssd_apply_prefill_cache_and_decode_match_jax(family, dtype):
    """ssd_apply at T = 40 over chunks of 16 (the last padded), with
    valid_len 33 and without; ssd_prefill_cache's output and cache; one
    ssd_decode step from a random float32 cache, written in place."""
    jcfg, cfg, jp, tp = _both(family, dtype=dtype)
    tol = _tol(cfg)
    jssd = jax.tree.map(lambda a: a[0], jp["layers"]["ssm"])
    ssd = tp.layers[0].ssm
    xj, xt = _input(cfg, (2, 40, cfg.d_model), 1)
    for vl in (None, 33):
        want_y, want_h = jax.jit(lambda p, x: JS.ssd_apply(
            p, x, cfg=jcfg, valid_len=vl))(jssd, xj)
        with L.matmul_numerics():
            got_y, got_h = S.ssd_apply(ssd, xt, cfg=cfg, valid_len=vl)
        assert got_y.dtype == L.cdtype(cfg) and got_h.dtype == torch.float32
        assert tuple(got_h.shape) == want_h.shape
        _close(got_y, want_y, tol, f"y valid_len={vl}")
        _close(got_h, want_h, tol, f"h valid_len={vl}")
    want_y, want_c = jax.jit(lambda p, x: JS.ssd_prefill_cache(
        p, x, cfg=jcfg))(jssd, xj)
    with L.matmul_numerics():
        got_y, got_c = S.ssd_prefill_cache(ssd, xt, cfg=cfg)
    _close(got_y, want_y, tol)
    for k in ("conv", "h"):
        assert tuple(got_c[k].shape) == want_c[k].shape
        assert got_c[k].dtype == torch.float32
        _close(got_c[k], want_c[k], tol, k)

    rng = np.random.default_rng(2)
    cache = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in want_c.items()}
    xj1, xt1 = _input(cfg, (2, 1, cfg.d_model), 3)
    want_y, want_c = jax.jit(lambda p, x, c: JS.ssd_decode(
        p, x, c, cfg=jcfg))(jssd, xj1, jax.tree.map(jnp.asarray, cache))
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    with L.matmul_numerics():
        got_y, out_cache = S.ssd_decode(ssd, xt1, tcache, cfg=cfg)
    assert out_cache is tcache                    # written in place
    _close(got_y, want_y, tol)
    for k in ("conv", "h"):
        _close(tcache[k], want_c[k], tol, k)


def test_ssd_chunked_equals_recurrent():
    """Mamba2 SSD dual form == step-by-step recurrence (the port's copy
    of tests/test_models.py's check, at its sizes and tolerance)."""
    cfg = get_smoke_config("mamba2-780m")
    p = S.SSD(cfg)
    S.ssd_init(p, torch.Generator().manual_seed(7))
    B, T = 2, 24
    x = torch.randn((B, T, cfg.d_model),
                    generator=torch.Generator().manual_seed(8)) * 0.5
    y_chunk, h_final = S.ssd_apply(p, x, cfg=cfg)
    cache = S.ssd_empty_cache(cfg, B)
    ys = [S.ssd_decode(p, x[:, t: t + 1], cache, cfg=cfg)[0]
          for t in range(T)]
    np.testing.assert_allclose(y_chunk.numpy(), torch.cat(ys, 1).numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(h_final.numpy(), cache["h"].numpy(),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("T", [1, 2, 3, 7])
def test_short_prompt_prefill_cache_continues_exactly(T):
    """A prompt shorter than the conv window (w - 1 = 3): the port's conv
    tail is led by the conv's zero padding (the reference's tail would be
    short and its decode could not run), so decoding on from the prefill
    gives the chunked form's outputs over the whole sequence."""
    cfg = get_smoke_config("mamba2-780m")
    p = S.SSD(cfg)
    S.ssd_init(p, torch.Generator().manual_seed(3))
    x = torch.randn((2, T + 5, cfg.d_model),
                    generator=torch.Generator().manual_seed(4)) * 0.5
    want, _ = S.ssd_apply(p, x, cfg=cfg)
    y, cache = S.ssd_prefill_cache(p, x[:, :T], cfg=cfg)
    assert cache["conv"].shape == (2, cfg.conv_width - 1,
                                   cfg.d_inner + 2 * cfg.ssm_state)
    ys = [y] + [S.ssd_decode(p, x[:, t: t + 1], cache, cfg=cfg)[0]
                for t in range(T, T + 5)]
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), want.numpy(),
                               rtol=2e-4, atol=2e-4)


def test_ssd_init_values_and_dtypes():
    """ssd_init gives the reference's constants (A_log, D, dt_bias,
    conv_b) and scales; in bfloat16 every SSD leaf but the norm's scale
    is bfloat16, as the reference stores it."""
    jcfg, cfg = _cfgs("mamba2", dtype="bfloat16")
    want = jax.tree.map(lambda a: np.asarray(a[0]), jlm.init_params(
        jax.random.PRNGKey(0), jcfg)["layers"]["ssm"])
    p = Model(cfg).init(0, device="cpu").layers[0].ssm
    for name in ("A_log", "D", "dt_bias", "conv_b"):
        got = getattr(p, name)
        assert got.dtype == torch.bfloat16, name
        np.testing.assert_array_equal(_np(got), want[name].astype(np.float32),
                                      err_msg=name)
    assert p.gate_norm.scale.dtype == torch.float32
    assert abs(float(p.in_proj.float().std()) / cfg.d_model ** -0.5 - 1) < 0.05
    assert abs(float(p.conv_w.float().std()) / cfg.conv_width ** -0.5
               - 1) < 0.15


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def _assert_cache_close(got, want, tol):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_cache_close(g, w, tol)
        return
    wk, gk = _jkeys(want), dict(leaves_with_keys(got))
    assert set(gk) == set(wk)
    for key, w in wk.items():
        g = gk[key]
        assert tuple(g.shape) == w.shape, key
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), key
        if key.endswith("pos_map"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            _close(g, w, tol, key)


@pytest.mark.parametrize("family,dtype,jit", [
    ("mamba2", "float32", False), ("mamba2", "bfloat16", False),
    ("hymba", "float32", False), ("hymba", "bfloat16", False),
    ("hymba", "bfloat16", True)])
def test_forward_prefill_and_decode_match_jax(family, dtype, jit):
    """forward logits (mamba2 also with valid_len), prefill logits and
    cache, then eight teacher-forced decode steps against the JAX model;
    hymba's 40-token prompt runs past its 32-token window (the ring
    wraps).  `jit`: the reference's prefill and decode compiled, where
    its hymba layer loop otherwise runs op by op."""
    jcfg, cfg, jparams, params = _both(family, dtype=dtype)
    tol = _tol(cfg)
    B, T, n_dec = 2, 40, 8
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (B, T + n_dec)).astype(np.int32)
    prompt = toks[:, :T]
    for vl in ((None, 33) if family == "mamba2" else (None,)):
        got, _ = lm.forward(params, cfg, torch.from_numpy(prompt).long(),
                            valid_len=vl)
        want, _ = jlm.forward(jparams, jcfg, tokens=jnp.asarray(prompt),
                              valid_len=vl)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        _close(got, want, tol, f"forward valid_len={vl}")

    jprefill, jdecode = jlm.prefill, jlm.decode_step
    if jit:
        jprefill = jax.jit(jlm.prefill, static_argnums=(1,),
                           static_argnames=("s_max",))
        jdecode = jax.jit(jlm.decode_step, static_argnums=(1,))
    s_max = T + n_dec
    glog, gcache, gpos = lm.prefill(params, cfg,
                                    torch.from_numpy(prompt).long(),
                                    s_max=s_max)
    wlog, wcache, wpos = jprefill(jparams, jcfg, tokens=jnp.asarray(prompt),
                                  s_max=s_max)
    _close(glog, wlog, tol)
    assert int(gpos) == int(wpos) and gpos.dim() == 0
    _assert_cache_close(gcache, wcache, tol)
    if family == "hymba":
        assert gcache[1]["attn"]["k"].shape[1] == cfg.sliding_window
        assert gcache[0]["attn"]["k"].shape[1] == s_max
    for i in range(n_dec):
        tok = toks[:, T + i:T + i + 1]
        glog, gcache = lm.decode_step(params, cfg, gcache,
                                      torch.from_numpy(tok).long(), gpos)
        wlog, wcache = jdecode(jparams, jcfg, wcache,
                               token=jnp.asarray(tok), pos=wpos)
        _close(glog, wlog, tol, f"decode {i}")
        gpos, wpos = gpos + 1, wpos + 1
    _assert_cache_close(gcache, wcache, tol)


def test_sdpa_block_skip_adds_nothing_to_mixed_windows():
    """hymba's windows are Python ints in the port, so chunked_sdpa skips
    the blocks outside each query block's band; the reference traces
    them and visits every block.  The skipped blocks add exactly
    nothing: skipping and not are bit-identical, and both are the
    reference's traced-window attention."""
    rng = np.random.default_rng(5)
    B, T, H, K, hd = 2, 80, 4, 2, 16
    q, k, v = (rng.standard_normal((B, T, n, hd)).astype(np.float32)
               for n in (H, K, K))
    pos = np.arange(T, dtype=np.int32)
    kw = dict(n_rep=H // K, q_block=16, kv_block=8, has_window=True)
    for window in (0, 32):
        got = [L.chunked_sdpa(*(torch.from_numpy(a) for a in (q, k, v)),
                              q_pos=torch.from_numpy(pos),
                              kv_pos=torch.from_numpy(pos), window=window,
                              block_skip=skip, **kw) for skip in (True,
                                                                  False)]
        assert torch.equal(got[0], got[1])
        want = jax.jit(lambda q, k, v, w: JL.chunked_sdpa(
            q, k, v, q_pos=jnp.asarray(pos), kv_pos=jnp.asarray(pos),
            window=w, block_skip=True, **kw))(q, k, v, jnp.int32(window))
        _close(got[0], want, F32_TOL, f"window {window}")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _loss_and_grads_both(family, seed=1, batch_seq=17, **kw):
    jcfg, cfg = _cfgs(family, **kw)
    jm, tm = JModel(jcfg), Model(cfg)
    jp = jax.tree.map(jnp.asarray, _ref_params(jcfg, seed))
    batch = JPipe(cfg.vocab_size, batch_seq, 4, seed=2).batch(0)
    batch["labels"][:, :3] = -100
    (jl, _), jg = jax.value_and_grad(
        lambda p: jm.loss(p, batch), has_aux=True)(jp)
    st = interop.train_state_from_reference(
        {"params": jax.device_get(jp), "opt_state": jopt.init_state(jp)},
        cfg, device="cpu")
    tl, _, tg = loss_and_grads(
        tm, st.params, {k: torch.from_numpy(v) for k, v in batch.items()})
    return jl, jg, tl, tg


@pytest.mark.parametrize("family,remat", [("mamba2", "none"),
                                          ("mamba2", "block"),
                                          ("hymba", "none")])
def test_lm_loss_and_grads_match_jax(family, remat):
    """lm_loss and its gradients on every leaf (the SSD's among them)
    against jax.value_and_grad at chunk 16, 33 tokens (three chunks);
    remat="block" recomputes each layer in the backward."""
    jl, jg, tl, tg = _loss_and_grads_both(family, batch_seq=33, remat=remat)
    np.testing.assert_allclose(float(tl), float(jl), rtol=F32_TOL)
    want = {k: np.asarray(v) for k, v in _jkeys(jg).items()}
    got = {k: v.numpy() for k, v in leaves_with_keys(tg)}
    assert list(got) == list(want)
    assert "layers/ssm/A_log" in got and "layers/ssm/gate_norm/scale" in got
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        np.testing.assert_allclose(got[k], w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=k)


@pytest.mark.parametrize("family", ["mamba2", "hymba"])
def test_chunk_256_gradients_are_finite_where_the_reference_is_nan(family):
    """At the full configs' chunk of 256 and T = 256, x ~ N(0, 1): the
    reference's _segsum_decay takes exp of the positive log-decays above
    the diagonal (past 88: inf), and its backward gives NaN for A_log,
    dt_bias and in_proj.  The port masks before exp: the same forward,
    every gradient finite."""
    jcfg, cfg = _cfgs(family, ssm_chunk=256)
    tree = _ref_params(jcfg)
    jssd = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["layers"]["ssm"])
    ssd = interop.model_params_from_reference(
        tree, cfg, device="cpu").layers[0].ssm
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 256, cfg.d_model)).astype(np.float32)
    r = rng.standard_normal((2, 256, cfg.d_model)).astype(np.float32)

    def jloss(p):
        y, h = JS.ssd_apply(p, jnp.asarray(x), cfg=jcfg)
        return jnp.sum(y * r) + jnp.sum(h), (y, h)
    jg, (jy, jh) = jax.grad(jloss, has_aux=True)(jssd)
    nan = sorted(k for k, v in _jkeys(jg).items()
                 if np.isnan(np.asarray(v)).any())
    assert nan == ["A_log", "dt_bias", "in_proj"]

    leaves = dict(ssd.named_parameters())
    for t in leaves.values():
        t.requires_grad_(True)
    y, h = S.ssd_apply(ssd, torch.from_numpy(x), cfg=cfg)
    _close(y, jy, F32_TOL)
    _close(h, jh, F32_TOL)
    grads = torch.autograd.grad((y * torch.from_numpy(r)).sum() + h.sum(),
                                list(leaves.values()))
    for name, g in zip(leaves, grads):
        assert torch.isfinite(g).all(), name
    # where the reference is finite, the gradients agree
    for name, g in zip(leaves, grads):
        w = np.asarray(_jkeys(jg)[name.replace(".", "/")])
        if name.replace(".", "/") not in nan:
            np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_TOL,
                                       atol=GRAD_TOL * np.abs(w).max(),
                                       err_msg=name)
