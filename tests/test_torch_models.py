"""The port's dense GQA model against the JAX package's, on the CPU.

The same seeded numpy weights and inputs go through both: each layer
function (``rms_norm``, RoPE, ``chunked_sdpa`` causal / SWA / ragged,
``_sdpa``, ``gqa_apply``, ``gqa_decode`` with its slot clamp, the FFN),
then ``forward``, ``prefill`` (logits and every cache leaf) and eight
teacher-forced ``decode_step``s, for the reduced llama3.2-1b config in
float32 and in bfloat16, with ``qkv_bias`` (qwen), with a sliding window,
and with a sliding window beside a global layer (per-layer caches).
Reference weights enter the port through
``interop.model_params_from_reference``.

Tolerances: float32 within rtol = atol = 1e-4 (the two frameworks sum
matmuls and softmaxes in other orders: ulps, amplified through a few
layers); bfloat16 within 5e-2 (bf16 keeps 8 bits of mantissa, and the
two round intermediate products at different places).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.config import reduced as jreduced  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.config import reduced  # noqa: E402
from repro_torch.models.model import Model, build  # noqa: E402

F32_TOL = 1e-4
BF16_TOL = 5e-2
CPU = torch.device("cpu")

# name -> (arch, reduced() overrides)
CONFIGS = {
    "f32": ("llama3.2-1b", {}),
    "bf16": ("llama3.2-1b", {"dtype": "bfloat16"}),
    "qkv_bias": ("qwen1.5-110b", {"qkv_bias": True}),
    "swa": ("llama3.2-1b", {"sliding_window": 8}),
    # SWA with a global layer: per-layer caches (uses_layer_loop)
    "mixed": ("llama3.2-1b", {"sliding_window": 8,
                              "global_attn_layers": (0,)}),
}


def _cfgs(name):
    arch, kw = CONFIGS[name]
    return (jreduced(jget_config(arch), **kw),
            reduced(get_config(arch), **kw))


def _tol(cfg):
    return BF16_TOL if cfg.dtype == "bfloat16" else F32_TOL


def _np(x):
    """A jax array or torch tensor as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _ref_params(jcfg, seed=0):
    """The reference's parameters as numpy, with random norm scales and
    biases (the reference initialises them to 1 and 0)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray,
                        jlm.init_params(jax.random.PRNGKey(seed), jcfg))

    def perturb(path, x):
        name = str(path[-1].key)
        if name == "scale" or name.startswith("b"):
            base = 1.0 if name == "scale" else 0.0
            return (base + 0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(perturb, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _module(mod, arrays: dict):
    """Fill a port module's parameters from numpy arrays by name."""
    with torch.no_grad():
        for name, p in mod.named_parameters():
            p.copy_(_t(arrays[name]))
    return mod


# ---------------------------------------------------------------------------
# layer functions
# ---------------------------------------------------------------------------

def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    got = L.rms_norm(_module(L.RMSNorm(16), {"scale": scale}), _t(x), 1e-5)
    want = JL.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5)
    _close(got, want, F32_TOL)
    pos = np.arange(3, 12, dtype=np.int32)
    cos, sin = L.rope_tables(_t(pos), 16, 500000.0)
    jcos, jsin = JL.rope_tables(jnp.asarray(pos), 16, 500000.0)
    _close(cos, jcos, F32_TOL)
    _close(sin, jsin, F32_TOL)
    _close(L.apply_rope(_t(x), cos, sin),
           JL.apply_rope(jnp.asarray(x), jcos, jsin), F32_TOL)


@pytest.mark.parametrize("T,window,block_skip", [
    (37, 0, True),        # causal, ragged T over 16/8 blocks
    (37, 0, False),
    (40, 8, True),        # SWA band
    (40, 8, False),
    (5, 0, True),         # one block
])
def test_chunked_sdpa_matches_jax(T, window, block_skip):
    rng = np.random.default_rng(T + window)
    B, H, K, hd = 2, 4, 2, 16
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, K, hd)).astype(np.float32)
    pos = np.arange(T, dtype=np.int32)
    kw = dict(window=window, has_window=bool(window), n_rep=H // K,
              q_block=16, kv_block=8, block_skip=block_skip)
    got = L.chunked_sdpa(_t(q), _t(k), _t(v), q_pos=_t(pos), kv_pos=_t(pos),
                         **kw)
    want = JL.chunked_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           q_pos=jnp.asarray(pos), kv_pos=jnp.asarray(pos),
                           **kw)
    assert tuple(got.shape) == want.shape
    _close(got, want, F32_TOL)


def test_decode_sdpa_matches_jax():
    rng = np.random.default_rng(1)
    B, S, H, K, hd = 2, 11, 4, 2, 16
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    mask = rng.random((1, 1, S)) < 0.6
    mask[..., 0] = True
    _close(L._sdpa(_t(q), _t(k), _t(v), _t(mask), H // K),
           JL._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(mask), H // K), F32_TOL)


@pytest.mark.parametrize("name", ["f32", "qkv_bias"])
def test_gqa_and_ffn_match_jax(name):
    jcfg, cfg = _cfgs(name)
    layer = jax.tree.map(lambda a: a[0], _ref_params(jcfg)["layers"])
    rng = np.random.default_rng(2)
    T = 13
    x = (rng.standard_normal((2, T, cfg.d_model)) * 0.5).astype(np.float32)
    pos = np.arange(T, dtype=np.int32)
    attn = _module(L.GQA(cfg), layer["attn"])
    got, (gk, gv) = L.gqa_apply(attn, _t(x), cfg=cfg, positions=_t(pos))
    want, (wk, wv) = JL.gqa_apply(layer["attn"], jnp.asarray(x), cfg=jcfg,
                                  positions=jnp.asarray(pos))
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        _close(g, w, F32_TOL)
    mlp = _module(L.FFN(cfg), layer["mlp"])
    _close(L.ffn_apply(mlp, _t(x)), JL.ffn_apply(layer["mlp"], jnp.asarray(x)),
           F32_TOL)


@pytest.mark.parametrize("window,pos", [(0, 5), (0, 12), (0, 14), (4, 9)])
def test_gqa_decode_matches_jax(window, pos):
    """One decode step into a cache of S = 12 slots: in place in the
    port, the slot clamped to S - 1 at pos >= S (full attention) as
    dynamic_update_slice clamps it, and a ring slot pos % S for SWA."""
    jcfg, cfg = _cfgs("f32")
    layer = jax.tree.map(lambda a: a[0], _ref_params(jcfg)["layers"])
    rng = np.random.default_rng(3 + pos)
    S = 12 if not window else window
    K, hd = cfg.n_kv_heads, cfg.head_dim
    ck = rng.standard_normal((2, S, K, hd)).astype(np.float32)
    cv = rng.standard_normal((2, S, K, hd)).astype(np.float32)
    pos_map = np.where(np.arange(S) < min(pos, S),
                       np.arange(S) + max(0, pos - S), -1).astype(np.int32)
    x = (rng.standard_normal((2, 1, cfg.d_model)) * 0.5).astype(np.float32)
    cache = {"k": _t(ck.copy()), "v": _t(cv.copy()),
             "pos_map": _t(pos_map.copy())}
    attn = _module(L.GQA(cfg), layer["attn"])
    got, out_cache = L.gqa_decode(attn, _t(x), cache, cfg=cfg,
                                  pos=torch.tensor(pos, dtype=torch.int32),
                                  window=window)
    assert out_cache is cache                     # written in place
    want, wcache = JL.gqa_decode(
        layer["attn"], jnp.asarray(x),
        {"k": jnp.asarray(ck), "v": jnp.asarray(cv),
         "pos_map": jnp.asarray(pos_map)}, cfg=jcfg,
        pos=jnp.int32(pos), window=window)
    _close(got, want, F32_TOL)
    for key in ("k", "v"):
        _close(cache[key], wcache[key], F32_TOL)
    np.testing.assert_array_equal(cache["pos_map"].numpy(),
                                  np.asarray(wcache["pos_map"]))


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def _both(name, seed=0):
    jcfg, cfg = _cfgs(name)
    tree = _ref_params(jcfg, seed)
    jparams = jax.tree.map(jnp.asarray, tree)
    return jcfg, cfg, jparams, interop.model_params_from_reference(
        tree, cfg, device="cpu")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_prefill_and_decode_match_jax(name):
    """forward logits, prefill logits and cache, then eight teacher-forced
    decode steps (the same fed tokens in both) against the JAX model."""
    jcfg, cfg, jparams, params = _both(name)
    tol = _tol(cfg)
    B, T, n_dec = 2, 11, 8
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (B, T + n_dec)).astype(np.int32)
    prompt = toks[:, :T]
    got, _ = lm.forward(params, cfg, _t(prompt).long())
    want, _ = jlm.forward(jparams, jcfg, tokens=jnp.asarray(prompt))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got, want, tol)

    s_max = T + n_dec
    glog, gcache, gpos = lm.prefill(params, cfg, _t(prompt).long(),
                                    s_max=s_max)
    wlog, wcache, wpos = jlm.prefill(jparams, jcfg, tokens=jnp.asarray(prompt),
                                     s_max=s_max)
    _close(glog, wlog, tol)
    assert int(gpos) == int(wpos) and gpos.dtype == torch.int32
    assert gpos.dim() == 0
    _assert_cache_close(gcache, wcache, tol)

    for i in range(n_dec):
        tok = toks[:, T + i:T + i + 1]
        glog, gcache = lm.decode_step(params, cfg, gcache, _t(tok), gpos)
        wlog, wcache = jlm.decode_step(jparams, jcfg, wcache,
                                       token=jnp.asarray(tok), pos=wpos)
        _close(glog, wlog, tol)
        gpos, wpos = gpos + 1, wpos + 1
    _assert_cache_close(gcache, wcache, tol)


def _assert_cache_close(got, want, tol):
    """The stacked cache (a per-layer list for mixed windows): the
    reference's keys, shapes and dtypes -- the attention's {k, v,
    pos_map} and an SSD layer's float32 {conv, h} state."""
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_cache_close(g, w, tol)
        return
    assert set(got) == set(want) and set(want) <= {"attn", "ssm"}
    if "attn" in want:
        assert set(got["attn"]) == set(want["attn"]) == {"k", "v", "pos_map"}
    if "ssm" in want:
        assert set(got["ssm"]) == set(want["ssm"]) == {"conv", "h"}
    for group in want:
        for key, w in want[group].items():
            g = got[group][key]
            assert tuple(g.shape) == w.shape, key
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype), key
            if key == "pos_map":
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            else:
                _close(g, w, tol)


def test_swa_prefill_longer_than_the_window_fills_the_ring():
    """A prompt longer than the window keeps its trailing positions at
    their ring slots, as the reference's _kv_to_cache does."""
    jcfg, cfg, jparams, params = _both("swa")
    prompt = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (1, 13)).astype(np.int32)
    _, gcache, _ = lm.prefill(params, cfg, _t(prompt).long(), s_max=20)
    _, wcache, _ = jlm.prefill(jparams, jcfg, tokens=jnp.asarray(prompt),
                               s_max=20)
    assert gcache["attn"]["k"].shape[2] == 8
    _assert_cache_close(gcache, wcache, F32_TOL)


def test_weights_round_trip_through_interop():
    """Every reference leaf lands in its parameter: the port's module,
    restacked, is the reference tree bit for bit (bf16 included)."""
    jcfg, cfg = _cfgs("bf16")
    tree = _ref_params(jcfg)
    params = interop.model_params_from_reference(tree, cfg, device="cpu")
    back = _to_reference(params)
    flat_w = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat_w.keys() == flat_g.keys()
    for k, w in flat_w.items():
        g = flat_g[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))
    assert params.embed.dtype == torch.bfloat16
    assert params.layers[0].ln_attn.scale.dtype == torch.float32


def _to_reference(params):
    """The inverse of model_params_from_reference (tests only): the
    reference's tree, layer leaves stacked, bf16 as ml_dtypes arrays."""
    import ml_dtypes

    def arr(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    tree = {"embed": arr(params.embed),
            "ln_f": {"scale": arr(params.ln_f.scale)}, "layers": {}}
    if hasattr(params, "unembed"):
        tree["unembed"] = arr(params.unembed)
    names = [n for n, _ in params.layers[0].named_parameters()]
    for n in names:
        mod, leaf = n.split(".")
        tree["layers"].setdefault(mod, {})[leaf] = np.stack(
            [arr(dict(layer.named_parameters())[n]) for layer in params.layers])
    return tree


def test_init_scales_and_dtypes():
    """Model.init draws at the reference's scales from a seeded
    generator: the same seed the same weights, bf16 weights with f32
    norm scales, embed std 0.02, wq (d, H, hd) std (d*H)^-1/2 (the
    reference's fan-in of a 3-d weight), wo (H*hd)^-1/2."""
    cfg = reduced(get_config("llama3.2-1b"), dtype="bfloat16", d_model=256,
                  n_heads=8, n_kv_heads=2, head_dim=32, d_ff=512)
    model = Model(cfg)
    a, b = model.init(0, device="cpu"), model.init(0, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))
    assert not torch.equal(a.embed, model.init(1, device="cpu").embed)
    assert a.embed.dtype == torch.bfloat16
    assert a.layers[0].ln_attn.scale.dtype == torch.float32
    attn = a.layers[0].attn
    for t, want in ((a.embed, 0.02), (attn.wq, (256 * 8) ** -0.5),
                    (attn.wo, 256 ** -0.5),
                    (a.layers[0].mlp.w_down, 512 ** -0.5)):
        assert abs(t.float().std().item() / want - 1) < 0.05
    assert not any(p.requires_grad for p in a.parameters())


@pytest.mark.parametrize("arch", list_archs())
def test_param_counts_match_the_reference(arch):
    """Every config's param_count (and active count) is the reference's,
    and for every arch (dense, MoE with GQA or MLA, SSM, hybrid and the
    frontends) the port's Model counts the reference's leaves."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert cfg == type(cfg)(**{f: getattr(jcfg, f)
                               for f in cfg.__dataclass_fields__})
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    model = build(arch)
    # The reference's leaves of its abstract parameter tree, summed in
    # Python ints (its Model.param_count takes jnp.prod in int32, which
    # wraps for qwen1.5-110b's and the MoE archs' stacked layer leaves).
    shapes = jax.tree.leaves(JModel(jcfg).shape_params())
    assert model.param_count() == sum(math.prod(x.shape) for x in shapes)


def test_sample_batch_and_empty_cache():
    cfg = reduced(get_config("llama3.2-1b"))
    model = Model(cfg)
    gen = torch.Generator().manual_seed(0)
    batch = model.sample_batch(gen, 3, 7)
    assert batch["tokens"].shape == (3, 7) and batch["labels"].shape == (3, 7)
    assert int(batch["tokens"].max()) < cfg.vocab_size
    cache = model.empty_cache(3, 16, device="cpu")
    jcache = JModel(jreduced(jget_config("llama3.2-1b"))).empty_cache(3, 16)
    _assert_cache_close(cache, jcache, 0.0)
    from repro.configs import get_smoke_config as jsmoke
    from repro_torch.configs import get_smoke_config
    for arch in ("mamba2-780m", "hymba-1.5b"):
        _assert_cache_close(
            Model(get_smoke_config(arch)).empty_cache(3, 40, device="cpu"),
            JModel(jsmoke(arch)).empty_cache(3, 40), 0.0)


def test_cuda_default_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(reduced(get_config("llama3.2-1b"))).init(0)
