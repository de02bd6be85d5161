"""The port's meshes, sharding rules, runtime preset and GPipe schedule
against the JAX package's.

``repro_torch.launch.runtime_env`` and ``launch.distributed.rank_env``
against the reference's dict helpers; ``distributed.sharding``'s
parameter, cache and batch specs against the reference's for the ten
full configs on the rule meshes (4, 2), (16, 16) and (2, 16, 16) (a
stand-in mesh that only names axes and sizes: the rules never count
ranks), and the smoke cases of tests/test_sharding.py;
``Model.shape_params`` against the reference's; ``launch.mesh`` and
``global_mesh`` over one process and two gloo ranks; and
``distributed.pipeline_parallel.pipeline_apply`` over four gloo ranks
(``spawn_emulated``) against the reference's over four fake XLA devices
in a subprocess, for M >= P, M < P and P = 1, also with the
backward's sends in another microbatch order than its receives.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.launch import distributed as jld  # noqa: E402
from repro.launch import runtime_env as jre  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.configs import ARCHS, get_config, get_smoke_config  # noqa: E402
from repro_torch.core.tree import leaves_with_keys  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.pipeline_parallel import stack_stages  # noqa: E402
from repro_torch.launch import distributed as ld  # noqa: E402
from repro_torch.launch import mesh as lmesh  # noqa: E402
from repro_torch.launch import runtime_env as tre  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")

# The rule meshes: name -> ({axis: size}, dp axes).
MESHES = {"4x2": ({"data": 4, "model": 2}, ("data",)),
          "16x16": ({"data": 16, "model": 16}, ("data",)),
          "2x16x16": ({"pod": 2, "data": 16, "model": 16}, ("pod", "data"))}


def _stand_in(sizes):
    """What the reference's rules read of a mesh: ``mesh.shape[name]``."""
    return types.SimpleNamespace(shape=dict(sizes))


def _jax_leaves(tree):
    return {jax.tree_util.keystr(p, simple=True, separator="/"): leaf
            for p, leaf in jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))}


def _port_specs(tree):
    return {k: tuple(v) for k, v in leaves_with_keys(tree)}


def _jax_specs(tree):
    return {k: tuple(v) for k, v in _jax_leaves(tree).items()}


@pytest.fixture
def alone():
    """A one-rank gloo group for the test, left afterwards."""
    ld.join_alone()
    yield
    ld.shutdown()


# ------------------------------------------------------------ runtime env

@pytest.mark.parametrize("found", [None, "/usr/local/lib/libtcmalloc.so.4"])
@pytest.mark.parametrize("base", [
    {}, {"LD_PRELOAD": "/a.so"},
    {"LD_PRELOAD": "/usr/local/lib/libtcmalloc.so.4"},
    {"TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD": "5", "TORCH_CPP_LOG_LEVEL":
     "INFO"}])
def test_runtime_env_matches_reference(monkeypatch, found, base):
    monkeypatch.setattr(jre, "find_tcmalloc", lambda *a: found)
    monkeypatch.setattr(tre, "find_tcmalloc", lambda *a: found)
    before = dict(os.environ)
    keys = ("LD_PRELOAD", "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD")
    for kw in ({}, {"tcmalloc": False}, {"quiet_logs": False}):
        got = tre.runtime_env(dict(base), **kw)
        want = jre.runtime_env(dict(base), **kw)
        assert {k: got.get(k) for k in keys} == \
            {k: want.get(k) for k in keys}
        level = base.get("TORCH_CPP_LOG_LEVEL")
        if kw.get("quiet_logs", True):
            level = level or "ERROR"
        assert got.get("TORCH_CPP_LOG_LEVEL") == level
        assert "TF_CPP_MIN_LOG_LEVEL" not in got
        assert "XLA_FLAGS" not in got
    assert tre.runtime_env(None).items() >= {
        k: v for k, v in os.environ.items() if k != "LD_PRELOAD"}.items()
    assert dict(os.environ) == before


def test_rank_env_preset_matches_reference(monkeypatch):
    lib = "/usr/local/lib/libtcmalloc_minimal.so.4"
    monkeypatch.setattr(jre, "find_tcmalloc", lambda *a: lib)
    monkeypatch.setattr(tre, "find_tcmalloc", lambda *a: lib)
    before = dict(os.environ)
    base = {"PATH": "/bin", "LD_PRELOAD": "/x.so"}
    got = ld.rank_env(2, 4, "127.0.0.1:9", base=base)
    want = jld.rank_env(2, 4, "127.0.0.1:9", base=base)
    for k in ("LD_PRELOAD", "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD",
              "PATH", ld.ENV_NUM_PROCESSES, ld.ENV_PROCESS_ID):
        assert got[k] == want[k], k
    assert got["LD_PRELOAD"] == f"/x.so:{lib}"
    assert got["TORCH_CPP_LOG_LEVEL"] == "ERROR"
    plain = ld.rank_env(0, 2, "h:1", base=base, preset=False)
    assert plain["LD_PRELOAD"] == "/x.so" and "TORCH_CPP_LOG_LEVEL" \
        not in plain
    assert base == {"PATH": "/bin", "LD_PRELOAD": "/x.so"}
    assert dict(os.environ) == before


def test_find_tcmalloc_matches_reference(tmp_path):
    libs = [str(tmp_path / n) for n in ("a.so", "b.so", "c.so")]
    Path(libs[1]).write_bytes(b"")
    Path(libs[2]).write_bytes(b"")
    for cands in (libs, libs[:1], [], libs[2:]):
        assert tre.find_tcmalloc(cands) == jre.find_tcmalloc(cands)
    assert tre.TCMALLOC_CANDIDATES == jre.TCMALLOC_CANDIDATES
    assert tre.TCMALLOC_REPORT_THRESHOLD == jre.TCMALLOC_REPORT_THRESHOLD


# ------------------------------------------------------- parameter specs

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_shape_params_match_reference(arch):
    """Keys, shapes and dtypes of the full config's tree; nothing is
    allocated (every leaf on "meta")."""
    want = _jax_leaves(JModel(jget_config(arch)).shape_params())
    got = dict(leaves_with_keys(Model(get_config(arch)).shape_params()))
    assert sorted(got) == sorted(want)
    for k, leaf in got.items():
        assert leaf.device.type == "meta"
        assert tuple(leaf.shape) == tuple(want[k].shape), k
        assert str(leaf.dtype).removeprefix("torch.") == \
            str(want[k].dtype), k
    assert Model(get_config(arch)).param_count() == sum(
        int(np.prod(v.shape)) for v in want.values())


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_reference(arch, mesh):
    sizes, dp = MESHES[mesh]
    want = _jax_specs(jshd.param_specs(
        JModel(jget_config(arch)).shape_params(), jget_config(arch),
        _stand_in(sizes), dp))
    tree = Model(get_config(arch)).shape_params()
    got = _port_specs(shd.param_specs(tree, get_config(arch), sizes, dp))
    assert got == want
    # the stand-in object and the mapping name the same mesh
    assert _port_specs(shd.param_specs(
        tree, get_config(arch), _stand_in(sizes), dp)) == want


def test_sharding_smoke_cases():
    """tests/test_sharding.py's cases on a (4, 2) mesh, against the
    reference and against the values that test asserts."""
    mesh = {"data": 4, "model": 2}
    cfg = get_smoke_config("llama3.2-1b")
    specs = shd.param_specs(Model(cfg).shape_params(), cfg, mesh)
    assert specs["embed"] == ("model", "data")
    lay = specs["layers"]
    assert lay["attn"]["wq"] == (None, "data", "model", None)
    assert lay["attn"]["wk"] == (None, "data", "model", None)
    assert lay["attn"]["wo"] == (None, "model", None, "data")
    assert lay["mlp"]["w_gate"] == (None, "data", "model")
    assert lay["mlp"]["w_down"] == (None, "model", "data")
    assert isinstance(specs["embed"], shd.PartitionSpec)

    cases = {"no ep": dict(n_experts=4, moe_ep_split=1),
             "ep": dict(n_experts=16, moe_ep_split=1, moe_top_k=2)}
    want_gate = {"no ep": (None, None, "data", "model"),
                 "ep": (None, "model", "data", None)}
    for name, kw in cases.items():
        tcfg = dataclasses.replace(get_smoke_config("mixtral-8x7b"), **kw)
        jcfg = dataclasses.replace(jget_smoke("mixtral-8x7b"), **kw)
        got = shd.param_specs(Model(tcfg).shape_params(), tcfg, mesh)
        assert got["layers"]["mlp"]["we_gate"] == want_gate[name]
        assert _port_specs(got) == _jax_specs(jshd.param_specs(
            JModel(jcfg).shape_params(), jcfg, _stand_in(mesh)))

    def meta(*shape):
        return torch.empty(shape, device="meta")
    caches = [
        ({"k": meta(8, 64, 3, 16), "v": meta(8, 64, 3, 16),
          "pos_map": meta(64)}, {"k": ("data", None, None, "model"),
                                 "pos_map": (None,)}),
        ({"k": meta(8, 64, 4, 16)}, {"k": ("data", None, "model", None)}),
        ({"k": meta(1, 64, 4, 16)}, {"k": (None, None, "model", None)})]
    for cache, want in caches:
        got = _port_specs(shd.cache_specs(cache, mesh))
        for k, v in want.items():
            assert got[k] == v
        ref = {k: jax.ShapeDtypeStruct(tuple(v.shape), np.float32)
               for k, v in cache.items()}
        assert got == _jax_specs(jshd.cache_specs(ref, _stand_in(mesh)))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_match_reference(arch):
    """Each family's decode cache on "meta" (stacked, or hymba's per-layer
    list), at a batch that divides the dp axes and at batch 1."""
    jcfg, tcfg = jget_config(arch), get_config(arch)
    stacked = not lm.uses_layer_loop(tcfg)
    for batch, s_max in ((32, 4096), (1, 1024)):
        jcache = jax.eval_shape(
            lambda: JModel(jcfg).empty_cache(batch, s_max))
        tcache = lm.empty_cache(tcfg, batch, s_max, stacked=stacked,
                                device="meta")
        got_keys = [k for k, _ in leaves_with_keys(tcache)]
        assert got_keys == list(_jax_leaves(jcache))
        for name, (sizes, dp) in MESHES.items():
            want = _jax_specs(jshd.cache_specs(jcache, _stand_in(sizes), dp))
            assert _port_specs(shd.cache_specs(tcache, sizes, dp)) == want, \
                (name, batch)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_specs_match_reference(mesh):
    sizes, dp = MESHES[mesh]
    for batch in (1, 3, 16, 256):
        shapes = {"tokens": (batch, 512), "labels": (batch, 512),
                  "embeds": (batch, 256, 64), "pos": ()}
        tree = {k: torch.empty(v, device="meta") for k, v in shapes.items()}
        ref = {k: jax.ShapeDtypeStruct(v, np.float32)
               for k, v in shapes.items()}
        assert _port_specs(shd.batch_specs(tree, sizes, dp)) == \
            _jax_specs(jshd.batch_specs(ref, _stand_in(sizes), dp))


def test_logical_to_spec_and_axis_size_match_reference():
    for sizes, dp in MESHES.values():
        mesh = _stand_in(sizes)
        for name in list(sizes) + [tuple(dp)]:
            assert shd.axis_size(sizes, name) == jshd.axis_size(mesh, name)
        for logical in (("dp", "tp", None), ("tp!",), (None, "tp"),
                        ("tp", "dp")):
            for shape in (None, (8, 12, 3), (32, 16, 5), (2, 24, 1)):
                want = jshd.logical_to_spec(logical, mesh, dp, "model",
                                            shape=shape)
                got = shd.logical_to_spec(logical, sizes, dp, "model",
                                          shape=shape)
                assert tuple(got) == tuple(want)


def test_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert shd.placements(shd.PartitionSpec(("pod", "data"), "model"),
                          mesh) == (Shard(0), Shard(0), Shard(1))
    assert shd.placements(shd.PartitionSpec(None, "data"), mesh) == (
        Replicate(), Shard(1), Replicate())
    assert shd.placements(shd.PartitionSpec(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        shd.placements(shd.PartitionSpec(("data", "pod")), mesh)


def test_constrain(alone):
    from torch.distributed.tensor import Shard, distribute_tensor

    x = torch.arange(24.0).reshape(4, 6)
    assert shd.constrain(x, "dp", "tp") is x          # no mesh
    mesh = lmesh.make_mesh((1, 1), ("data", "model"), "cpu")
    shd.activate(mesh)
    try:
        assert shd.constrain(x, "dp", "tp") is x      # a plain tensor
        d = distribute_tensor(x, mesh, shd.placements((None, None), mesh))
        y = shd.constrain(d, "dp", "tp")
        assert tuple(y.placements) == (Shard(0), Shard(1))
        assert torch.equal(y.full_tensor(), x)
        shd.activate(mesh, shard_seq=True)
        z = shd.constrain(d, None, "seq")
        assert tuple(z.placements)[1] == Shard(1)
    finally:
        shd.deactivate()
    assert shd.constrain(d, "dp") is d


_SITES_WORKER = """
import dataclasses, json, sys, torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.models import lm
from repro_torch.models.model import Model

recs = []
orig = shd.constrain

def spy(x, *logical):
    y = orig(x, *logical)
    site = sys._getframe(1).f_code.co_name
    if site in ("forward", "lm_loss", "moe_apply"):
        recs.append(dict(
            site=site, logical=list(logical), shape=list(x.shape),
            dtensor=isinstance(x, DTensor), same=y is x,
            placements=([f"S{p.dim}" if p.is_shard() else
                         "R" if p.is_replicate() else str(p)
                         for p in y.placements]
                        if isinstance(y, DTensor) else None)))
    return y

shd.constrain = spy
mesh, dp = dryrun.cell_mesh("single")
shd.activate(mesh, dp, "model")
# 8 experts of 2 slots fill the 16-way model axis: expert parallelism
model = Model(dataclasses.replace(get_smoke_config("mixtral-8x7b"),
                                  n_experts=8))
fn, args = dryrun.build_cell(model, "train_4k", mesh)
with implicit_replication():
    fn(*args)
params = model.init(0, device="cpu")
batch = model.sample_batch(torch.Generator().manual_seed(0), 2, 32)
lm.lm_loss(params, model.cfg, batch)
print(json.dumps(recs))
"""


def test_constrain_call_sites_redistribute_dtensors():
    """The reference's four call sites (the residual stream in
    ``forward``, the loss's logits, the MoE's dispatch buffer and expert
    outputs) on the dry run's fake (16, 16) mesh: a DTensor leaves each
    in the placements of the reference's spec there; with the same mesh
    active, a plain tensor is returned as it is (smoke mixtral with 8
    experts, whose 16 expert slots fill the model axis)."""
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _SITES_WORKER], env=env,
                         cwd=str(ROOT), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    recs = json.loads(out.stdout.strip().splitlines()[-1])
    sizes = {"data": 16, "model": 16}
    want_logical = {"forward": ["dp", "seq", None],
                    "lm_loss": ["dp", None, "tp"],
                    "moe_apply": [["dp", "tp", None, None],
                                  ["dp", None, None, None]]}
    seen = set()
    for r in recs:
        logical = r["logical"]
        want = want_logical[r["site"]]
        assert logical in (want if r["site"] == "moe_apply" else [want])
        if not r["dtensor"]:
            assert r["same"], r
            continue
        seen.add((r["site"], tuple(logical)))
        resolved = tuple(None if ax == "seq" else ax for ax in logical)
        spec = jshd.logical_to_spec(resolved, _stand_in(sizes), ("data",),
                                    "model", shape=tuple(r["shape"]))
        placements = []
        for axis in ("data", "model"):
            dims = [i for i, e in enumerate(spec)
                    if e == axis or (isinstance(e, tuple) and axis in e)]
            placements.append(f"S{dims[0]}" if dims else "R")
        assert r["placements"] == placements, (r, tuple(spec))
    assert seen == {("forward", ("dp", "seq", None)),
                    ("lm_loss", ("dp", None, "tp")),
                    ("moe_apply", ("dp", "tp", None, None)),
                    ("moe_apply", ("dp", None, None, None))}
    assert any(not r["dtensor"] for r in recs)


# ------------------------------------------------------------------ meshes

def test_make_production_mesh_shapes(monkeypatch):
    """The reference's shapes and axis names (256 and 512 ranks cannot be
    started here: init_device_mesh is recorded, not run)."""
    import torch.distributed.device_mesh as dm

    calls = []
    monkeypatch.setattr(dm, "init_device_mesh",
                        lambda *a, **kw: calls.append((a, kw)) or "mesh")
    assert lmesh.make_production_mesh() == "mesh"
    lmesh.make_production_mesh(multi_pod=True, device_type="cpu")
    assert calls == [
        (("cuda", (16, 16)), {"mesh_dim_names": ("data", "model")}),
        (("cpu", (2, 16, 16)), {"mesh_dim_names": ("pod", "data", "model")})]


def test_one_process_meshes(alone):
    mesh = lmesh.make_mesh((1, 1), ("data", "model"), "cpu")
    assert (lmesh.dp_axes(mesh), lmesh.tp_axis(mesh),
            lmesh.mesh_chips(mesh)) == (("data",), "model", 1)
    g = ld.global_mesh(device_type="cpu")
    assert g.mesh_dim_names == ("data",) and g.mesh.tolist() == [0]
    assert (ld.process_rank(), ld.process_count()) == (0, 1)


def test_global_mesh_alone_joins_and_leaves():
    import torch.distributed as dist

    assert not dist.is_initialized()
    mesh = ld.global_mesh("shards", device_type="cpu")
    try:
        assert dist.get_world_size() == 1
        assert mesh.mesh_dim_names == ("shards",)
    finally:
        ld.shutdown()
    assert not dist.is_initialized()


_MESH_WORKER = textwrap.dedent("""
    import json
    import torch.distributed as dist
    from repro_torch.launch import distributed as ld
    from repro_torch.launch import mesh as lmesh
    ld.initialize()
    g = ld.global_mesh(device_type="cpu")
    m = lmesh.make_mesh((2, 1), ("pod", "data"), "cpu")
    print("MESH " + json.dumps(dict(
        rank=dist.get_rank(), mesh=g.mesh.tolist(), names=g.mesh_dim_names,
        coord=g.get_coordinate(), dp=lmesh.dp_axes(m),
        chips=lmesh.mesh_chips(m), coord2=m.get_coordinate())))
    ld.shutdown()
""")


def test_global_mesh_over_two_ranks():
    env = dict(os.environ, PYTHONPATH=SRC)
    res = ld.spawn_emulated(2, ["-c", _MESH_WORKER], base_env=env,
                            timeout=120)
    ld.check_spawned(res)
    for rank, r in enumerate(res):
        got = json.loads(r.stdout.split("MESH ")[1])
        assert got == dict(rank=rank, mesh=[0, 1], names=["data"],
                           coord=[rank], dp=["pod", "data"], chips=2,
                           coord2=[rank, 0])
        # the preset keeps c10d's per-rank warnings out
        assert "[c10d]" not in r.stderr


# ------------------------------------------------------- the GPipe schedule

# (stages, microbatches): M >= P, M < P, one stage.
PIPE_CASES = [(4, 8), (4, 2), (1, 3)]
MB, D = 2, 16


def _pipe_inputs(n_stages, m):
    rng = np.random.default_rng(100 * n_stages + m)
    w = (rng.standard_normal((n_stages, D, D)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((n_stages, D)) * 0.1).astype(np.float32)
    x = rng.standard_normal((m, MB, D)).astype(np.float32)
    return w, b, x


_PIPE_JAX = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh
    from repro.distributed.pipeline_parallel import pipeline_apply
    out = sys.argv[1]

    def stage_fn(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])

    for tag in sys.argv[2:]:
        d = np.load(f"{out}/in_{tag}.npz")
        P_ = d["w"].shape[0]
        mesh = Mesh(np.array(jax.devices()[:P_]), ("pipe",))
        params = {"w": jnp.asarray(d["w"]), "b": jnp.asarray(d["b"])}
        x = jnp.asarray(d["x"])
        # one trace for the output and the gradient of sum(y ** 2)
        y, vjp = jax.vjp(
            lambda p: pipeline_apply(mesh, "pipe", stage_fn, p, x), params)
        g, = vjp(2 * y)
        np.savez(f"{out}/jax_{tag}.npz", out=np.asarray(y),
                 gw=np.asarray(g["w"]), gb=np.asarray(g["b"]))
    print("PIPE_JAX_OK")
""")

_PIPE_WORKER = textwrap.dedent("""
    import os, sys
    import numpy as np, torch
    import torch.distributed as dist
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.distributed.pipeline_parallel import (pipeline_apply,
                                                           stack_stages)
    from repro_torch.launch import distributed as ld
    ld.initialize()
    out = sys.argv[1]
    mesh = ld.global_mesh("pipe", device_type="cpu")
    rank = dist.get_rank()

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    for tag in sys.argv[2:]:
        d = np.load(f"{out}/in_{tag}.npz")
        stages = [{"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
                  for w, b in zip(d["w"], d["b"])]
        x = torch.from_numpy(d["x"])
        for mode in ("plain", "dtensor", "reordered"):
            params = stack_stages(stages)
            if mode == "dtensor":
                params = {k: distribute_tensor(v, mesh, [Shard(0)],
                                               src_data_rank=None)
                          for k, v in params.items()}
            params = {k: v.requires_grad_() for k, v in params.items()}
            y = pipeline_apply(mesh, "pipe", stage_fn, params, x)
            send = dist.send
            if mode == "reordered" and rank % 2:
                # Odd stages send their gradients left in ascending
                # microbatch order, against the descending order in which
                # autograd walks them and their neighbours receive.
                held = []

                def held_send(t, dst, group=None, tag=0):
                    held.append((tag, t, dst, group))
                    if len(held) == len(x):
                        for tag_, t_, dst_, g_ in sorted(
                                held, key=lambda h: h[0]):
                            send(t_, dst_, group=g_, tag=tag_)
                dist.send = held_send
            try:
                gw, gb = torch.autograd.grad((y ** 2).sum(),
                                             [params["w"], params["b"]])
            finally:
                dist.send = send
            if mode == "dtensor":
                gw, gb = gw.to_local()[0], gb.to_local()[0]
            else:
                gw, gb = gw[rank], gb[rank]
            np.savez(f"{out}/torch_{tag}_{mode}_r{rank}.npz",
                     out=y.detach().numpy(), gw=gw.numpy(), gb=gb.numpy())
    ld.shutdown()
    print("PIPE_TORCH_OK")
""")


@pytest.fixture(scope="module")
def pipe_runs(tmp_path_factory):
    """The reference's outputs and gradients over fake XLA devices (one
    subprocess), and the port's from one gloo fleet per stage count."""
    out = tmp_path_factory.mktemp("pipe")
    tags = {}
    for p_, m in PIPE_CASES:
        tag = f"p{p_}m{m}"
        w, b, x = _pipe_inputs(p_, m)
        np.savez(out / f"in_{tag}.npz", w=w, b=b, x=x)
        tags.setdefault(p_, []).append(tag)
    env = dict(os.environ, PYTHONPATH=SRC)
    jax_run = subprocess.Popen(
        [sys.executable, "-c", _PIPE_JAX, str(out)]
        + [t for ts in tags.values() for t in ts],
        env=dict(env, JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    for p_, ts in tags.items():
        res = ld.spawn_emulated(p_, ["-c", _PIPE_WORKER, str(out), *ts],
                                base_env=env, timeout=240)
        ld.check_spawned(res)
    stdout, stderr = jax_run.communicate(timeout=300)
    assert jax_run.returncode == 0 and "PIPE_JAX_OK" in stdout, stderr
    return out


@pytest.mark.parametrize("mode", ["plain", "dtensor", "reordered"])
@pytest.mark.parametrize("case", PIPE_CASES, ids=lambda c: f"p{c[0]}m{c[1]}")
def test_pipeline_apply_matches_jax(pipe_runs, case, mode):
    """Outputs within 2e-5 of the reference's on every rank, and each
    stage's gradients (w, b) within 2e-4 of its slice of jax.grad's;
    "reordered": odd stages send their backward gradients in another
    microbatch order than their neighbours receive them."""
    n_stages, m = case
    tag = f"p{n_stages}m{m}"
    want = np.load(pipe_runs / f"jax_{tag}.npz")
    w, b, x = _pipe_inputs(n_stages, m)
    seq = x
    for s in range(n_stages):
        seq = np.tanh(seq @ w[s] + b[s])
    np.testing.assert_allclose(want["out"], seq, rtol=2e-5, atol=2e-5)
    for rank in range(n_stages):
        got = np.load(pipe_runs / f"torch_{tag}_{mode}_r{rank}.npz")
        assert got["out"].shape == (m, MB, D)
        np.testing.assert_allclose(got["out"], want["out"], rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(got["gw"], want["gw"][rank], rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(got["gb"], want["gb"][rank], rtol=2e-4,
                                   atol=2e-4)
        assert np.abs(got["gw"]).max() > 0


def test_stack_stages():
    trees = [{"a": torch.full((2,), float(i)), "b": [torch.tensor(i)]}
             for i in range(3)]
    got = stack_stages(trees)
    assert torch.equal(got["a"], torch.tensor([[0.0] * 2, [1.0] * 2,
                                               [2.0] * 2]))
    assert torch.equal(got["b"][0], torch.tensor([0, 1, 2]))
