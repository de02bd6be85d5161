"""The port's MLA attention and MoE FFN against the JAX package's, on the
CPU.

The same seeded numpy weights and inputs go through both, at the reduced
configs of minicpm3-4b (MLA), mixtral-8x7b (MoE with ``moe_ep_split`` 2
and a sliding window) and phi3.5-moe (MoE, full attention): ``mla_apply``,
the absorbed ``mla_decode`` and the expanded ``mla_decode_naive`` (the
reference's oracle for the absorbed form) with the slot clamp at
pos >= S; ``moe_apply`` output and aux, its routing (``keep`` and ``pos``
equal, not close) with and without drops, the priority order of
tests/test_moe.py, the router gradient against ``jax.grad``, the FFN's
and MoE's gradients at saturated gates (|x| > 100) against ``jax.grad``
and ``lax.top_k``'s tie order; then each whole model's ``forward``,
``prefill`` (logits and every cache leaf) and eight teacher-forced
``decode_step``s.  Training and files: tests/test_torch_mla_moe_files.py.

Tolerances: float32 within rtol = atol = 1e-4 and bfloat16 within 5e-2,
as the dense tests hold them (the frameworks sum matmuls and softmaxes
in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.config import reduced as jreduced  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.tree import leaves_with_keys  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.config import reduced  # noqa: E402

F32_TOL = 1e-4
BF16_TOL = 5e-2
GRAD_TOL = 1e-4

# name -> (arch, reduced() overrides)
CONFIGS = {
    "mla_f32": ("minicpm3-4b", {}),
    "mla_bf16": ("minicpm3-4b", {"dtype": "bfloat16"}),
    "moe_f32": ("mixtral-8x7b", {}),
    "moe_bf16": ("mixtral-8x7b", {"dtype": "bfloat16"}),
    "phi_f32": ("phi3.5-moe-42b-a6.6b", {}),
    # capacity 1.25 (the full configs'): the prefill drops choices
    "moe_drop": ("mixtral-8x7b", {"capacity_factor": 1.25}),
}


def _cfgs(name, **kw):
    arch, over = CONFIGS[name]
    over = dict(over, **kw)
    return (jreduced(jget_config(arch), **over),
            reduced(get_config(arch), **over))


def _tol(cfg):
    return BF16_TOL if cfg.dtype == "bfloat16" else F32_TOL


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=msg)


def _t(x):
    x = np.array(x)
    if x.dtype.name == "bfloat16":                # an ml_dtypes array
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _ref_params(jcfg, seed=0):
    """The reference's parameters as numpy, norm scales perturbed (the
    reference initialises them to 1)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray,
                        jlm.init_params(jax.random.PRNGKey(seed), jcfg))

    def perturb(path, x):
        if str(path[-1].key) == "scale":
            return (1.0 + 0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(perturb, tree)


def _layer0(jcfg, key):
    return jax.tree.map(lambda a: a[0], _ref_params(jcfg)["layers"][key])


def _module(mod, tree: dict):
    """Fill a port module's parameters from a nested numpy dict."""
    flat = {"/".join(str(k.key) for k in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}
    with torch.no_grad():
        for name, p in mod.named_parameters():
            p.copy_(_t(flat[name.replace(".", "/")]))
    return mod


def _x(cfg, shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.5
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def test_mla_apply_matches_jax():
    """Prefill: the output, the normed latent and the roped shared key
    (q/k head dim 24, v head dim 16 through chunked_sdpa)."""
    jcfg, cfg = _cfgs("mla_f32")
    p = _layer0(jcfg, "attn")
    T = 13
    x, pos = _x(cfg, (2, T, cfg.d_model), 1), np.arange(T, dtype=np.int32)
    got, (gc, gk) = L.mla_apply(_module(L.MLA(cfg), p), _t(x), cfg=cfg,
                                positions=_t(pos))
    want, (wc, wk) = JL.mla_apply(p, jnp.asarray(x), cfg=jcfg,
                                  positions=jnp.asarray(pos))
    for g, w in ((got, want), (gc, wc), (gk, wk)):
        assert tuple(g.shape) == w.shape
        _close(g, w, F32_TOL)


def _mla_cache(cfg, S, pos, seed):
    rng = np.random.default_rng(seed)
    filled = np.arange(S) < min(pos, S)
    return {"ckv": rng.standard_normal((2, S, cfg.kv_lora_rank)
                                       ).astype(np.float32),
            "krope": rng.standard_normal((2, S, cfg.qk_rope_dim)
                                         ).astype(np.float32),
            "pos_map": np.where(filled, np.arange(S), -1).astype(np.int32)}


@pytest.mark.parametrize("pos", [5, 12, 14])
def test_mla_decode_matches_jax(pos):
    """One decode step into S = 12 slots, absorbed and naive, against the
    reference's: the output and the cache, written in place in the port;
    at pos >= S the latent lands in slot S - 1 (dynamic_update_slice's
    clamp) and pos_map[S - 1] reads pos."""
    jcfg, cfg = _cfgs("mla_f32")
    p = _layer0(jcfg, "attn")
    S = 12
    c0 = _mla_cache(cfg, S, pos, seed=pos)
    x = _x(cfg, (2, 1, cfg.d_model), 2)
    attn = _module(L.MLA(cfg), p)
    for fn, jfn in ((L.mla_decode, JL.mla_decode),
                    (L.mla_decode_naive, JL.mla_decode_naive)):
        cache = {k: _t(v.copy()) for k, v in c0.items()}
        got, out_cache = fn(attn, _t(x), cache, cfg=cfg,
                            pos=torch.tensor(pos, dtype=torch.int32))
        assert out_cache is cache
        want, wcache = jfn(p, jnp.asarray(x),
                           {k: jnp.asarray(v) for k, v in c0.items()},
                           cfg=jcfg, pos=jnp.int32(pos))
        _close(got, want, F32_TOL, fn.__name__)
        for k in ("ckv", "krope"):
            _close(cache[k], wcache[k], F32_TOL, k)
        np.testing.assert_array_equal(cache["pos_map"].numpy(),
                                      np.asarray(wcache["pos_map"]))
        slot = min(pos, S - 1)
        assert int(cache["pos_map"][slot]) == pos
        assert not torch.equal(cache["ckv"][:, slot], _t(c0["ckv"][:, slot]))


@pytest.mark.parametrize("name", ["mla_f32", "mla_bf16"])
def test_mla_absorbed_decode_matches_the_naive_one(name):
    """The port's absorbed decode against its own expanded oracle over a
    half-filled cache."""
    jcfg, cfg = _cfgs(name)
    attn = _module(L.MLA(cfg), _layer0(jcfg, "attn"))
    dt = L.cdtype(cfg)
    c0 = {k: _t(v) for k, v in _mla_cache(cfg, 16, 9, seed=3).items()}
    c0 = {k: v.to(dt) if v.is_floating_point() else v for k, v in c0.items()}
    x = _t(_x(cfg, (2, 1, cfg.d_model), 4)).to(dt)
    pos = torch.tensor(9, dtype=torch.int32)
    a, ca = L.mla_decode(attn, x, {k: v.clone() for k, v in c0.items()},
                         cfg=cfg, pos=pos)
    b, cb = L.mla_decode_naive(attn, x, {k: v.clone() for k, v in c0.items()},
                               cfg=cfg, pos=pos)
    _close(a, b, _tol(cfg))
    for k in ca:
        assert torch.equal(ca[k], cb[k]), k


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

class _VmapSpy:
    """Stands in for the ``jax`` module inside repro.models.layers and
    records the arguments of each ``jax.vmap``-ed call: the reference's
    moe_apply vmaps dispatch_one(x, slot_e, pos, keep) first."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def vmap(self, fn, *a, **kw):
        mapped = jax.vmap(fn, *a, **kw)

        def run(*args):
            self.calls.append(args)
            return mapped(*args)
        return run


def _jax_moe(monkeypatch, p, x, jcfg):
    """The reference's (out, aux) and its routing: (slot_e, pos, keep)."""
    spy = _VmapSpy()
    monkeypatch.setattr(JL, "jax", spy)
    out, aux = JL.moe_apply(p, jnp.asarray(x), cfg=jcfg)
    monkeypatch.undo()
    _, slot_e, pos, keep = spy.calls[0]
    return out, aux, (np.asarray(slot_e), np.asarray(pos), np.asarray(keep))


def _moe_cfgs(split, cf):
    return _cfgs("phi_f32" if split == 1 else "moe_f32",
                 capacity_factor=cf)


@pytest.mark.parametrize("split", [1, 2])
@pytest.mark.parametrize("cf", [2.0, 0.5])
def test_moe_apply_and_routing_match_jax(monkeypatch, split, cf):
    """moe_apply's output and aux against the reference's, drop-free
    (cf 2.0: capacity T) and dropping (cf 0.5), with moe_ep_split 1 and
    2; slot_e, pos and keep equal the reference's exactly."""
    jcfg, cfg = _moe_cfgs(split, cf)
    p = _layer0(jcfg, "mlp")
    x = _x(cfg, (2, 16, cfg.d_model), 5)
    want, waux, (we, wpos, wkeep) = _jax_moe(monkeypatch, p, x, jcfg)
    moe = _module(L.MoE(cfg), p)
    got, aux = L.moe_apply(moe, _t(x), cfg=cfg)
    _, _, slot_e, _, pos, keep, cap = L.moe_route(moe, _t(x), cfg)
    assert cap == max(1, int(16 * 2 * cf / cfg.n_experts))
    np.testing.assert_array_equal(slot_e.numpy(), we)
    np.testing.assert_array_equal(pos.numpy(), wpos)
    np.testing.assert_array_equal(keep.numpy(), wkeep)
    assert wkeep.all() == (cf == 2.0)
    _close(got, want, F32_TOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)
    assert aux.dtype == torch.float32


def test_moe_drop_priority_is_order_independent():
    """tests/test_moe.py's case in the port: under overflow, permuting
    the tokens permutes the outputs (the same choices drop)."""
    _, cfg = _moe_cfgs(1, 0.25)
    jcfg, _ = _moe_cfgs(1, 0.25)
    moe = _module(L.MoE(cfg), _layer0(jcfg, "mlp"))
    x = _t(_x(cfg, (1, 32, cfg.d_model), 6))
    y, _ = L.moe_apply(moe, x, cfg=cfg)
    assert (y[0].norm(dim=-1) < 1e-6).any()          # drops happen
    perm = torch.from_numpy(np.random.default_rng(2).permutation(32))
    yp, _ = L.moe_apply(moe, x[:, perm], cfg=cfg)
    _close(yp, y[:, perm], 2e-5)


@pytest.mark.parametrize("split", [1, 2])
def test_moe_router_gradient_matches_jax(split):
    """jax.grad of sum(y^2) + 0.01 * aux against the port's autograd, on
    the router, every expert weight and the input."""
    jcfg, cfg = _moe_cfgs(split, 0.5)
    p = _layer0(jcfg, "mlp")
    x = _x(cfg, (1, 16, cfg.d_model), 7)

    def jloss(pp, xx):
        y, aux = JL.moe_apply(pp, xx, cfg=jcfg)
        return jnp.sum(y ** 2) + 0.01 * aux
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    moe = _module(L.MoE(cfg), p).requires_grad_(True)
    xt = _t(x).requires_grad_(True)
    y, aux = L.moe_apply(moe, xt, cfg=cfg)
    (torch.sum(y ** 2) + 0.01 * aux).backward()
    assert float(moe.router.grad.abs().sum()) > 0
    for name, g in [(n, q.grad) for n, q in moe.named_parameters()] + [
            ("x", xt.grad)]:
        w = np.asarray(jgx if name == "x" else jg[name])
        np.testing.assert_allclose(_np(g), w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("kind", ["ffn", "moe"])
def test_saturated_gate_gradients_match_jax(kind):
    """Gate pre-activations beyond +-100 (where exp(-x) overflows in
    float32): jax.grad of sum(y^2) against the port's autograd on every
    weight and the input, all finite."""
    jcfg, cfg = _moe_cfgs(2, 2.0)
    if kind == "ffn":
        jcfg, cfg = _cfgs("mla_f32")
    p = dict(_layer0(jcfg, "mlp"))
    gate = "w_gate" if kind == "ffn" else "we_gate"
    p[gate] = p[gate] * np.float32(300.0)
    x = _x(cfg, (1, 16, cfg.d_model), 8)
    japply = JL.ffn_apply if kind == "ffn" else (
        lambda pp, xx: JL.moe_apply(pp, xx, cfg=jcfg)[0])

    def jloss(pp, xx):
        return jnp.sum(japply(pp, xx) ** 2)
    g = np.asarray(jnp.einsum("btd,df->btf", x, p["w_gate"])
                   if kind == "ffn" else
                   jnp.einsum("btd,edf->betf", x, p["we_gate"]))
    assert g.min() < -100 and g.max() > 100
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    mod = _module(L.FFN(cfg) if kind == "ffn" else L.MoE(cfg), p)
    mod.requires_grad_(True)
    xt = _t(x).requires_grad_(True)
    y = (L.ffn_apply(mod, xt) if kind == "ffn"
         else L.moe_apply(mod, xt, cfg=cfg)[0])
    torch.sum(y ** 2).backward()
    for name, gt in [(n, q.grad) for n, q in mod.named_parameters()] + [
            ("x", xt.grad)]:
        w = np.asarray(jgx if name == "x" else jg[name])
        assert np.isfinite(_np(gt)).all(), name
        np.testing.assert_allclose(_np(gt), w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=name)


def test_top_k_ties_take_the_lower_index(monkeypatch):
    """Equal router logits (a zero router): every expert ties and the
    lower indices win, as lax.top_k orders them; the routing equals the
    reference's.  top_k itself on partial ties too."""
    jcfg, cfg = _moe_cfgs(2, 2.0)
    p = dict(_layer0(jcfg, "mlp"))
    p["router"] = np.zeros_like(p["router"])
    x = _x(cfg, (2, 8, cfg.d_model), 8)
    want, _, (we, wpos, wkeep) = _jax_moe(monkeypatch, p, x, jcfg)
    moe = _module(L.MoE(cfg), p)
    _, top_e, slot_e, _, pos, keep, _ = L.moe_route(moe, _t(x), cfg)
    assert (top_e == torch.tensor([0, 1])).all()
    np.testing.assert_array_equal(slot_e.numpy(), we)
    np.testing.assert_array_equal(pos.numpy(), wpos)
    np.testing.assert_array_equal(keep.numpy(), wkeep)
    _close(L.moe_apply(moe, _t(x), cfg=cfg)[0], want, F32_TOL)
    probs = np.array([[0.1, 0.3, 0.2, 0.3, 0.1],
                      [0.25, 0.25, 0.25, 0.25, 0.0]], np.float32)
    vals, idx = L.top_k(_t(probs), 3)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def _both(name, **kw):
    jcfg, cfg = _cfgs(name, **kw)
    tree = _ref_params(jcfg)
    return jcfg, cfg, jax.tree.map(jnp.asarray, tree), \
        interop.model_params_from_reference(tree, cfg, device="cpu")


def _assert_cache_close(got, want, tol):
    """The stacked cache: the reference's keys, shapes and dtypes."""
    assert set(got["attn"]) == set(want["attn"])
    for key, w in want["attn"].items():
        g = got["attn"][key]
        assert tuple(g.shape) == w.shape, key
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), key
        if key == "pos_map":
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            _close(g, w, tol, key)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_prefill_and_decode_match_jax(name):
    """forward logits and aux, prefill logits and cache (the MLA latent
    cache: ckv, krope, pos_map), then eight teacher-forced decode steps
    (MoE at T = 1: capacity 1) against the JAX model."""
    jcfg, cfg, jparams, params = _both(name)
    tol = _tol(cfg)
    B, T, n_dec = 2, 11, 8
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (B, T + n_dec)).astype(np.int32)
    prompt = toks[:, :T]
    got, gaux = lm.forward(params, cfg, _t(prompt).long())
    want, waux = jlm.forward(jparams, jcfg, tokens=jnp.asarray(prompt))
    _close(got, want, tol)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=tol)
    assert (float(gaux) > 0) == bool(cfg.n_experts)

    s_max = T + n_dec
    glog, gcache, gpos = lm.prefill(params, cfg, _t(prompt).long(),
                                    s_max=s_max)
    wlog, wcache, wpos = jlm.prefill(jparams, jcfg, tokens=jnp.asarray(prompt),
                                     s_max=s_max)
    _close(glog, wlog, tol)
    assert int(gpos) == int(wpos)
    _assert_cache_close(gcache, wcache, tol)
    keys = {"ckv", "krope", "pos_map"} if cfg.attn_kind == "mla" else \
        {"k", "v", "pos_map"}
    assert set(gcache["attn"]) == keys
    for i in range(n_dec):
        tok = toks[:, T + i:T + i + 1]
        glog, gcache = lm.decode_step(params, cfg, gcache, _t(tok), gpos)
        wlog, wcache = jlm.decode_step(jparams, jcfg, wcache,
                                       token=jnp.asarray(tok), pos=wpos)
        _close(glog, wlog, tol, f"decode {i}")
        gpos, wpos = gpos + 1, wpos + 1
    _assert_cache_close(gcache, wcache, tol)


def test_builds_and_param_tree_keys():
    """A reduced model's parameter tree carries the reference's keys,
    shapes and dtypes (shapes only, on the meta device)."""
    for name in ("mla_bf16", "moe_bf16", "phi_f32"):
        jcfg, cfg = _cfgs(name)
        want = {"/".join(str(k.key) for k in path): leaf for path, leaf in
                jax.tree_util.tree_flatten_with_path(
                    JModel(jcfg).shape_params())[0]}
        got = dict(leaves_with_keys(lm.param_tree(lm.LM(cfg, "meta"))))
        assert list(got) == list(want)
        for k, w in want.items():
            assert tuple(got[k].shape) == w.shape, k
            assert str(got[k].dtype).removeprefix("torch.") == str(w.dtype), k


@pytest.mark.parametrize("name", ["mla_bf16", "moe_bf16"])
def test_weights_round_trip_through_interop(name):
    """model_params_from_reference then model_params_to_reference gives
    the reference tree bit for bit (bf16 weights, f32 norm scales, the
    MLA latent norms and the slot-wise expert stacks), and a tree with a
    leaf too many or of another shape is refused."""
    jcfg, cfg = _cfgs(name)
    tree = _ref_params(jcfg)
    params = interop.model_params_from_reference(tree, cfg, device="cpu")
    back = interop.model_params_to_reference(params)
    flat_w = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat_w.keys() == flat_g.keys()
    for k, w in flat_w.items():
        g = flat_g[k]
        assert g.shape == w.shape and g.itemsize == w.itemsize, k
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))
    layers = dict(tree["layers"])
    key = "attn" if cfg.attn_kind == "mla" else "mlp"
    bad = dict(layers[key])
    big = "wq_b" if key == "attn" else "we_down"
    bad[big] = bad[big][..., :-1]
    with pytest.raises(ValueError, match=big):
        interop.model_params_from_reference(
            dict(tree, layers=dict(layers, **{key: bad})), cfg, device="cpu")
    with pytest.raises(ValueError, match="extra"):
        interop.model_params_from_reference(
            dict(tree, layers=dict(layers, **{key: dict(
                layers[key], extra=np.zeros(3, np.float32))})), cfg,
            device="cpu")
