"""The port's elastic restore against the JAX package's, shard for shard.

The JAX package's ``CheckpointManager`` writes a checkpoint of numpy-
seeded smoke ``llama3.2-1b`` parameters (float32, an anchor and a lossy
delta) beside a bfloat16 table, in a subprocess with 8 fake XLA devices,
and restores it there with its own ``restore_elastic`` onto a (4, 2)
("data", "model") mesh and a (2, 2, 2) ("pod", "data", "model") mesh with
("pod", "data") as the data axes; every device's shard index is
recorded.  Eight gloo ranks of the port (``spawn_emulated``) restore the
same files with ``repro_torch.checkpoint.elastic.restore_elastic`` onto
the same meshes; each rank's local shard must equal, bit for bit, the
slice the reference gives the device at the same mesh coordinate.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.elastic import restore_elastic  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.tree import leaves_with_keys  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import distributed as ld  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
ARCH = "llama3.2-1b"
BF16_SHAPE = (16, 64)
# name -> (shape, axis names, dp axes)
MESHES = {"4x2": ((4, 2), ("data", "model"), ("data",)),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"), ("pod", "data"))}

_JAX = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh
    from repro.checkpoint.elastic import restore_elastic
    from repro.checkpoint.manager import CheckpointManager
    from repro.configs import get_smoke_config
    from repro.core import NumarckParams
    from repro.models.model import Model
    out, meshes = sys.argv[1], json.loads(sys.argv[2])
    bf16_shape = tuple(json.loads(sys.argv[3]))
    cfg = get_smoke_config("llama3.2-1b")
    shapes = Model(cfg).shape_params()
    rng = np.random.default_rng(5)

    def draw(s):
        return jnp.asarray((rng.standard_normal(s.shape) * 0.05
                            + 0.01).astype(np.float32), s.dtype)

    params = jax.tree.map(draw, shapes)
    table = jnp.asarray(rng.standard_normal(bf16_shape), jnp.bfloat16)
    first = {"params": params, "extra": {"embed": table}}
    second = {"params": jax.tree.map(lambda a: a * (1 + 0.01 * jnp.asarray(
        rng.standard_normal(a.shape), a.dtype)), params),
        "extra": {"embed": table + 1}}
    d = os.path.join(out, "ckpt")
    mgr = CheckpointManager(d, params=NumarckParams(error_bound=1e-3))
    mgr.save(0, first)
    mgr.save(1, second)
    template = {"params": shapes, "extra": {"embed": jax.ShapeDtypeStruct(
        bf16_shape, jnp.bfloat16)}}
    index, full = {}, {}
    for name, (shape, axes, dp) in meshes.items():
        mesh = Mesh(np.array(jax.devices()).reshape(shape), tuple(axes))
        step, tree = restore_elastic(CheckpointManager(d), template, cfg,
                                     mesh, dp=tuple(dp))
        assert step == 1, step
        index[name] = {}
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            key = jax.tree_util.keystr(path, simple=True, separator="/")
            arr = np.asarray(leaf)
            if arr.dtype == jnp.bfloat16:
                arr = arr.view(np.uint16)
            full.setdefault(key, arr)
            assert np.array_equal(full[key], arr)
            index[name][key] = {
                "spec": [list(e) if isinstance(e, tuple) else e
                         for e in leaf.sharding.spec],
                "shards": {str(s.device.id): [
                    list(sl.indices(n))[:2] for sl, n in zip(s.index,
                                                             arr.shape)]
                    for s in leaf.addressable_shards}}
    np.savez(os.path.join(out, "full.npz"),
             **{k.replace("/", "|"): v for k, v in full.items()})
    with open(os.path.join(out, "index.json"), "w") as f:
        json.dump(index, f)
    print("ELASTIC_JAX_OK")
""")

_RANK = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.elastic import reshard_tree, restore_elastic
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.tree import leaves_with_keys
    from repro_torch.launch import distributed as ld
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model
    ld.initialize()
    out, meshes = sys.argv[1], json.loads(sys.argv[2])
    bf16_shape = tuple(json.loads(sys.argv[3]))
    rank = dist.get_rank()
    cfg = get_smoke_config("llama3.2-1b")
    template = {"params": Model(cfg).shape_params(), "extra": {
        "embed": torch.empty(bf16_shape, dtype=torch.bfloat16,
                             device="meta")}}
    full = np.load(out + "/full.npz")
    index = json.load(open(out + "/index.json"))
    res = {}
    for name, (shape, axes, dp) in meshes.items():
        mesh = make_mesh(shape, axes, "cpu")
        mgr = CheckpointManager(out + "/ckpt", device="cpu")
        step, tree = restore_elastic(mgr, template, cfg, mesh, dp=tuple(dp))
        bad, placements = [], {}
        for key, leaf in leaves_with_keys(tree):
            local = leaf.to_local()
            if local.dtype == torch.bfloat16:
                local = local.view(torch.int16)
            got = local.numpy()
            if got.dtype == np.int16:
                got = got.view(np.uint16)
            idx = index[name][key]["shards"][str(rank)]
            want = full[key.replace("/", "|")][tuple(slice(a, b)
                                                     for a, b in idx)]
            if got.shape != want.shape or got.tobytes() != want.tobytes():
                bad.append(key)
            placements[key] = [repr(p) for p in leaf.placements]
        res[name] = dict(step=step, report=mgr.last_restore_report,
                         n=len(placements), bad=bad, placements=placements,
                         coord=list(mesh.get_coordinate()),
                         dtype=str(tree["extra"]["embed"].dtype))
    scalar = reshard_tree({"w": torch.ones(4, 2), "step": 3}, cfg, mesh)
    res["scalar"] = [scalar["step"], type(scalar["step"]).__name__,
                     type(scalar["w"]).__name__]
    ld.shutdown()
    print("ELASTIC_RANK " + json.dumps(res))
""")


@pytest.fixture(scope="module")
def elastic_runs(tmp_path_factory):
    """The reference's files and shard indices, then one fleet of 8 gloo
    ranks restoring them onto both meshes: (index, per-rank results)."""
    out = tmp_path_factory.mktemp("elastic")
    meshes = json.dumps(MESHES)
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", _JAX, str(out), meshes,
                          json.dumps(BF16_SHAPE)],
                         env=dict(env, JAX_PLATFORMS="cpu"),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "ELASTIC_JAX_OK" in res.stdout, \
        res.stderr
    ranks = ld.spawn_emulated(8, ["-c", _RANK, str(out), meshes,
                                  json.dumps(BF16_SHAPE)],
                              base_env=env, timeout=300)
    ld.check_spawned(ranks)
    got = [json.loads(r.stdout.split("ELASTIC_RANK ")[1]) for r in ranks]
    return out, json.loads((out / "index.json").read_text()), got


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_every_rank_holds_the_reference_shard(elastic_runs, mesh):
    _, index, ranks = elastic_runs
    shape = MESHES[mesh][0]
    for rank, r in enumerate(ranks):
        got = r[mesh]
        assert got["coord"] == list(np.unravel_index(rank, shape))
        assert got["step"] == 1 and got["report"] == []
        assert got["n"] == len(index[mesh]) and got["bad"] == []
        assert got["dtype"] == "torch.bfloat16"


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_placements_are_the_reference_specs(elastic_runs, mesh):
    """Each leaf's placements are those of the reference's spec on the
    same mesh, and at least one leaf is sharded over two mesh dims at
    once on the multi-pod mesh (("pod", "data") on one tensor dim)."""
    from types import SimpleNamespace

    _, index, ranks = elastic_runs
    names = SimpleNamespace(mesh_dim_names=MESHES[mesh][1])
    multi = 0
    for key, entry in index[mesh].items():
        spec = shd.PartitionSpec(*(tuple(e) if isinstance(e, list) else e
                                   for e in entry["spec"]))
        want = [repr(p) for p in shd.placements(spec, names)]
        multi += any(isinstance(e, tuple) for e in spec)
        for r in ranks:
            assert r[mesh]["placements"][key] == want, key
    assert multi > 0 if mesh == "2x2x2" else multi == 0


def test_scalar_leaves_stay_scalars(elastic_runs):
    for r in elastic_runs[2]:
        assert r["scalar"] == [3, "int", "DTensor"]


@pytest.fixture
def alone():
    ld.join_alone()
    yield
    ld.shutdown()


def _template():
    return {"params": Model(get_smoke_config(ARCH)).shape_params(),
            "extra": {"embed": torch.empty(BF16_SHAPE, dtype=torch.bfloat16,
                                           device="meta")}}


def test_one_rank_restore_equals_restore_latest(elastic_runs, alone):
    """On a (1, 1) mesh every DTensor's full tensor is restore_latest's
    leaf and the reference's restored values, bit for bit."""
    out = elastic_runs[0]
    cfg = get_smoke_config(ARCH)
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    want = CheckpointManager(str(out / "ckpt"), device="cpu").restore_latest(
        template=_template())
    step, tree = restore_elastic(CheckpointManager(str(out / "ckpt"),
                                                   device="cpu"),
                                 _template(), cfg, mesh)
    assert step == want[0] == 1
    full = np.load(out / "full.npz")
    ref = dict(leaves_with_keys(want[1]))
    ns = dict(leaves_with_keys(shd.named_shardings(want[1], cfg, mesh)))
    for key, leaf in leaves_with_keys(tree):
        t = leaf.full_tensor()
        assert t.dtype == ref[key].dtype
        assert tuple(leaf.placements) == ns[key].placements
        assert torch.equal(t.view(torch.int16) if t.dtype == torch.bfloat16
                           else t, ref[key].view(torch.int16)
                           if t.dtype == torch.bfloat16 else ref[key])
        raw = t.view(torch.int16).numpy().view(np.uint16) \
            if t.dtype == torch.bfloat16 else t.numpy()
        assert raw.tobytes() == full[key.replace("/", "|")].tobytes()


def test_restore_elastic_of_nothing_is_none(tmp_path, alone):
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    assert restore_elastic(CheckpointManager(str(tmp_path), device="cpu"),
                           _template(), get_smoke_config(ARCH), mesh) is None
