"""The port's dry run and cost model (``launch/dryrun.py``,
``launch/cost_model.py``, ``Model.input_specs``, ``models/unroll.py``)
against the reference's.

* The analytic ``flops_cell``, ``bytes_cell`` and ``collective_cell``
  equal the reference's for every config, runnable shape and mesh but
  the pairs where the port's implementation does other work
  (``DIFFERS``, each with its value and reason).
* ``input_specs`` gives the reference's shapes and dtypes.
* The op counter's train-step FLOPs against ``flops_cell`` on the
  reference test's four probe configs, and against the reference's
  fully unrolled HLO FLOPs on the dense one.
* ``run_cell`` on a fake 256- and 512-rank fleet in subprocesses:
  Llama-3.2-1B's three shapes on both meshes, an SSM decode and the
  compression cell.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.launch.cost_model as rcost
import repro_torch.models.config as tmc
from repro.configs import get_config as ref_config
from repro.models.model import Model as RefModel
from repro_torch.configs import get_config, list_archs
from repro_torch.core.tree import leaves_with_keys
from repro_torch.launch import cost_model
from repro_torch.models.config import ModelConfig, runnable_shapes
from repro_torch.models.model import Model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"single": (256, 16, 16), "multi": (512, 32, 16)}
CELLS = [(a, s) for a in list_archs() for s in runnable_shapes(get_config(a))]

# (arch, shape, function) -> (the port's value, why it is not the
# reference's).  The port's chunked_sdpa reads each layer's window as an
# int and re-reads K/V once per query block (cost_model's docstring).
_WINDOWS = ("per-layer windows: hymba's window layers skip masked blocks "
            "in training too, its 3 global layers visit every block at 32k "
            "and read their whole cache in decode")
_REREAD = "K/V re-read once per query block: 64 at 32k, not min(64, 8)"
DIFFERS = {
    ("deepseek-7b", "prefill_32k", "bytes_cell"): (35490250588160.0, _REREAD),
    ("hymba-1.5b", "train_4k", "flops_cell"): (1.0171235652599808e+16,
                                               _WINDOWS),
    ("hymba-1.5b", "train_4k", "bytes_cell"): (2997285290048.0, _WINDOWS),
    ("hymba-1.5b", "prefill_32k", "flops_cell"): (4003733214068736.0,
                                                  _WINDOWS),
    ("hymba-1.5b", "prefill_32k", "bytes_cell"): (1331546536896.0,
                                                  _WINDOWS + "; " + _REREAD),
    ("hymba-1.5b", "decode_32k", "flops_cell"): (448857522176.0, _WINDOWS),
    ("hymba-1.5b", "decode_32k", "bytes_cell"): (24718458304.0, _WINDOWS),
    ("hymba-1.5b", "long_500k", "flops_cell"): (12943883392.0, _WINDOWS),
    ("hymba-1.5b", "long_500k", "bytes_cell"): (4845612996.0, _WINDOWS),
    ("llama3.2-1b", "prefill_32k", "bytes_cell"): (3289195347968.0,
                                                   _REREAD),
    ("minicpm3-4b", "prefill_32k", "bytes_cell"): (7772650139648.0,
                                                   _REREAD),
    ("mixtral-8x7b", "prefill_32k", "bytes_cell"): (3526158188544.0,
                                                    _REREAD),
    ("musicgen-medium", "prefill_32k", "bytes_cell"): (21040386572288.0,
                                                       _REREAD),
    ("paligemma-3b", "prefill_32k", "bytes_cell"): (2939285291008.0,
                                                    _REREAD),
    ("phi3.5-moe-42b-a6.6b", "prefill_32k", "bytes_cell"): (
        11213347487744.0, _REREAD),
    ("qwen1.5-110b", "prefill_32k", "bytes_cell"): (33845569650688.0,
                                                    _REREAD),
}


# ------------------------------------------------------------- analytic

@pytest.mark.parametrize("arch,shape", CELLS)
def test_analytic_model_matches_the_reference(arch, shape):
    cfg, rcfg = get_config(arch), ref_config(arch)
    for fn in ("flops_cell", "bytes_cell"):
        got = getattr(cost_model, fn)(cfg, shape)
        want = getattr(rcost, fn)(rcfg, shape)
        if (arch, shape, fn) in DIFFERS:
            value, _ = DIFFERS[(arch, shape, fn)]
            assert got == value and got != want, (fn, got, want)
        else:
            assert got == want, (fn, got, want)
    for chips, dp, tp in MESHES.values():
        assert cost_model.collective_cell(cfg, shape, chips, dp, tp) \
            == rcost.collective_cell(rcfg, shape, chips, dp, tp)
        c = cost_model.cell_cost(cfg, shape, chips, dp, tp)
        assert c.per_device(chips) == (c.flops_total / chips,
                                       c.bytes_total / chips)


def test_every_difference_is_a_runnable_cell():
    assert {(a, s) for a, s, _ in DIFFERS} <= set(CELLS)
    assert all(reason for _, reason in DIFFERS.values())


def test_layer_windows_follow_layer_flags():
    assert cost_model.layer_windows(get_config("llama3.2-1b")) == [(0, 16)]
    assert cost_model.layer_windows(get_config("mixtral-8x7b")) \
        == [(4096, 32)]
    assert cost_model.layer_windows(get_config("hymba-1.5b")) \
        == [(0, 3), (1024, 29)]


def test_unroll_flag_is_kept_and_unread():
    from repro.models import unroll as ref
    from repro_torch.models import unroll
    assert unroll.scan_unroll() == ref.scan_unroll() == 1
    with unroll.full_unroll():
        assert unroll.scan_unroll() is True
    assert unroll.scan_unroll() == 1


# ----------------------------------------------------------- input specs

def _ref_leaves(tree):
    import jax
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = (tuple(leaf.shape), str(leaf.dtype))
    return out


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_the_reference(arch, shape):
    got = {k: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for k, t in leaves_with_keys(Model(get_config(arch))
                                        .input_specs(shape))}
    assert all(t.device.type == "meta" for _, t in leaves_with_keys(
        Model(get_config(arch)).input_specs(shape)))
    assert got == _ref_leaves(RefModel(ref_config(arch)).input_specs(shape))


def test_input_specs_refuse_like_the_reference():
    for model in (Model(get_config("llama3.2-1b")),
                  RefModel(ref_config("llama3.2-1b"))):
        with pytest.raises(ValueError):
            model.input_specs("long_500k")
        with pytest.raises(KeyError):
            model.input_specs("no_such_shape")


# ------------------------------------------------------------- counted

def _small(family="dense", **kw):
    base = dict(
        name="probe", family=family, n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
        dtype="float32")
    base.update(kw)
    return ModelConfig(**base)


PROBES = {
    "dense": ("dense", {}),
    "mla": ("dense", dict(attn_kind="mla", q_lora_rank=32, kv_lora_rank=16,
                          qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
                          n_kv_heads=4)),
    "moe": ("moe", dict(n_experts=4, moe_top_k=2)),
    "ssm": ("ssm", dict(n_heads=0, n_kv_heads=0, d_ff=0, ssm_state=16,
                        ssm_head_dim=16, ssm_chunk=16, attn_kind="none")),
}


def _counted_train_flops(cfg, B, S):
    """One eager train step (loss, gradients, AdamW) of `cfg` on "meta"
    tensors under the op counter."""
    from repro_torch.train import optim
    from repro_torch.train.trainer import loss_and_grads
    model = Model(cfg)
    params = model.shape_params()
    opt = optim.init_state(params)
    tok = torch.empty((B, S), dtype=torch.int32, device="meta")
    batch = {"tokens": tok, "labels": tok}

    def step():
        _, _, grads = loss_and_grads(model, params, batch)
        optim.apply_updates(params, grads, opt, optim.AdamWConfig())

    return cost_model.step_cost(step)[1]


def _analytic_train_flops(cfg, B, S, monkeypatch):
    monkeypatch.setitem(tmc.SHAPES, "__probe__",
                        dict(kind="train", seq_len=S, global_batch=B))
    return cost_model.flops_cell(cfg, "__probe__")


@pytest.mark.parametrize("probe", sorted(PROBES))
def test_analytic_flops_match_the_counted_step(probe, monkeypatch):
    """The reference test's envelope (0.65 <= analytic / counted <=
    1.45) on its four probe configs."""
    family, kw = PROBES[probe]
    cfg = _small(family=family, **kw)
    cost = _counted_train_flops(cfg, 2, 64)
    ana = _analytic_train_flops(cfg, 2, 64, monkeypatch)
    assert 0.65 <= ana / cost["flops"] <= 1.45, (probe, ana, cost)
    assert cost["bytes accessed"] > 0 and cost["ops"] > 0


def test_counted_flops_against_the_reference_unrolled_hlo():
    """The dense probe's counted FLOPs against XLA's cost analysis of the
    reference's fully unrolled step: the same matmuls, and XLA also counts
    each elementwise op (norms, softmax, AdamW) at a flop an element,
    which the counter counts 0 -- 7 % of this step.  So 0.9 <= counted /
    HLO <= 1."""
    import jax
    from repro.launch.cost_model import hlo_flops
    from repro.models.config import ModelConfig as RefConfig
    from repro.models.unroll import full_unroll
    from repro.train import optim

    kw = dict(name="probe", family="dense", n_layers=2, d_model=64,
              n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
              vocab_size=512, dtype="float32")
    model = RefModel(RefConfig(**kw))
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    opt = jax.eval_shape(optim.init_state, params)
    batch = {k: jax.ShapeDtypeStruct((2, 64), jax.numpy.int32)
             for k in ("tokens", "labels")}

    def step(p, o, b):
        (loss, _), g = jax.value_and_grad(lambda pp: model.loss(pp, b),
                                          has_aux=True)(p)
        p, o, _ = optim.apply_updates(p, g, o, optim.AdamWConfig())
        return p, o, loss

    with full_unroll():
        hlo = hlo_flops(jax.jit(step).lower(params, opt, batch).compile())
    counted = _counted_train_flops(_small(), 2, 64)["flops"]
    assert 0.9 <= counted / hlo <= 1.0, (counted, hlo)


def test_counter_sees_local_shards_and_collectives(tmp_path):
    """Under DTensor the counter sees each rank's local matmul and the
    collective DTensor issues, by kind and result bytes, once DTensor's
    caches are warm (in a subprocess: the fake group is process-wide)."""
    code = (
        "import json, torch\n"
        "from repro_torch.launch import cost_model, dryrun\n"
        "from torch.distributed.tensor import distribute_tensor, "
        "Shard, Replicate\n"
        "mesh, dp = dryrun.cell_mesh('single')\n"
        "a = distribute_tensor(torch.empty(64, 32, device='meta'), mesh, "
        "(Shard(0), Replicate()), src_data_rank=None)\n"
        "b = distribute_tensor(torch.empty(32, 16, device='meta'), mesh, "
        "(Shard(0), Replicate()), src_data_rank=None)\n"
        "def step():\n"
        "    return a @ b.redistribute(mesh, (Replicate(), Replicate()))\n"
        "step()\n"      # DTensor's first dispatch derives the sharding
        "with cost_model.OpCounter() as c:\n"
        "    step()\n"
        "print(json.dumps(c.cost()))\n")
    cost = _run_json(code)[-1]
    # b gathered over "data" (16 ranks), then a (4, 32) @ (32, 16) locally
    assert cost["flops"] == 2 * 4 * 32 * 16
    assert cost["collectives"] == {"all-gather": 32 * 16 * 4}
    assert cost["collective_counts"] == {"all-gather": 1}


# --------------------------------------------------------------- cells

_RECORD_KEYS = {
    "arch", "shape", "mesh", "status", "chips", "flops_per_device",
    "bytes_per_device", "collective_bytes_per_device", "collectives",
    "roofline_hlo_raw", "analytic_flops_per_device",
    "analytic_bytes_per_device", "roofline", "dominant", "model_flops",
    "useful_ratio", "memory", "lower_s", "compile_s", "n_params",
    "n_active_params"}


def _run_json(code, timeout=240):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]


def _cells_code(mesh, cells, compression):
    return (
        "import json\n"
        "from repro_torch.launch import dryrun\n"
        f"for a, s in {cells!r}:\n"
        f"    r = dryrun.run_cell(a, s, {mesh!r})\n"
        "    print(json.dumps(r, default=str), flush=True)\n"
        + (f"print(json.dumps(dryrun.run_compression_dryrun({mesh!r}, "
           "n_elems=2_000_000_000), default=str))\n" if compression else ""))


@pytest.fixture(scope="module")
def cell_records():
    """Llama-3.2-1B's three shapes on both meshes, mamba2's decode and
    train step and the compression cell on one pod, in two processes at
    once."""
    llama = [("llama3.2-1b", s) for s in ("train_4k", "prefill_32k",
                                          "decode_32k")]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    mamba2 = [("mamba2-780m", s) for s in ("decode_32k", "train_4k")]
    jobs = {
        "single": _cells_code("single", llama + mamba2, True),
        "multi": _cells_code("multi", llama, True)}
    procs = {k: subprocess.Popen([sys.executable, "-c", code], env=env,
                                 cwd=ROOT, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, code in jobs.items()}
    recs = []
    for k, p in procs.items():
        out, err = p.communicate(timeout=400)
        assert p.returncode == 0, out[-3000:] + err[-3000:]
        recs += [json.loads(line) for line in out.splitlines()
                 if line.startswith("{")]
    return recs


def test_llama_cells_are_ok_on_both_meshes(cell_records):
    cells = [r for r in cell_records if r["arch"] == "llama3.2-1b"]
    assert sorted((r["mesh"], r["shape"]) for r in cells) == sorted(
        (m, s) for m in ("single", "multi")
        for s in ("train_4k", "prefill_32k", "decode_32k"))
    for r in cells:
        assert r["status"] == "OK", r.get("error")
        assert _RECORD_KEYS <= set(r), _RECORD_KEYS - set(r)
        assert r["chips"] == (512 if r["mesh"] == "multi" else 256)
        assert r["hw"]["peak_flops_bf16"] == 989.4e12
        assert r["hw"]["hbm_bw"] == 3.35e12
        for terms in (r["roofline"], r["roofline_hlo_raw"]):
            assert set(terms) == {"compute_s", "memory_s", "collective_s"}
            assert all(np.isfinite(v) and v >= 0 for v in terms.values())
        assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
        assert r["memory"]["argument"] > 0
        if r["shape"] == "train_4k":
            assert r["collective_bytes_per_device"] > 0
            assert r["collectives"]["all-gather"] > 0
            assert r["collectives"]["reduce-scatter"] > 0


def test_cell_counts_scale_with_the_mesh(cell_records):
    """Two pods halve each rank's batch: the per-device counted FLOPs of
    prefill and decode halve too."""
    by = {(r["mesh"], r["shape"]): r for r in cell_records
          if r["arch"] == "llama3.2-1b"}
    for shape in ("prefill_32k", "decode_32k"):
        one, two = by[("single", shape)], by[("multi", shape)]
        assert two["flops_per_device"] == pytest.approx(
            one["flops_per_device"] / 2, rel=1e-9)


def test_ssm_decode_cell_and_compression_cell(cell_records):
    ssm = [r for r in cell_records if r["arch"] == "mamba2-780m"
           and r["shape"] == "decode_32k"]
    assert len(ssm) == 1 and ssm[0]["status"] == "OK", ssm
    comp = [r for r in cell_records if r["arch"] == "numarck-pipeline"]
    assert {r["mesh"] for r in comp} == {"single", "multi"}
    for r in comp:
        assert r["status"] == "OK", r.get("error")
        assert r["shards"] == (16 if r["mesh"] == "single" else 2)
        assert r["collectives"]["all-reduce"] == (1 << 16) * 4
        assert r["collectives"]["all-gather"] == 2 * 4 * r["shards"]
        assert r["bytes_per_device"] >= 2 * 4 * 2_000_000_000 // r["shards"]


# mamba2-780m train_4k on one pod, counted a rank under torch 2.13.  The
# FLOPs are those before the unembedding took a redistribute of its own of
# the tied table; bytes and collective bytes moved by +0.009 % and
# +0.066 % with it (PERF.md).
MAMBA2_TRAIN = {"flops_per_device": 21621872001024.0,
                "bytes_per_device": 6403070242816.0,
                "collective_bytes_per_device": 175009243152.0}


def test_ssm_train_cell_with_a_tied_table_is_ok(cell_records):
    """mamba2's vocabulary (50,280) does not divide the model axis, so
    its tied table shards only over dp; torch 2.11 failed this cell's
    backward (``test_tied_table_gradients_arrive_in_its_layout``)."""
    [rec] = [r for r in cell_records if r["arch"] == "mamba2-780m"
             and r["shape"] == "train_4k"]
    assert rec["status"] == "OK", rec.get("error")
    assert rec["mesh"] == "single" and rec["chips"] == 256
    assert {k: rec[k] for k in MAMBA2_TRAIN} == MAMBA2_TRAIN
    assert rec["collectives"]["reduce-scatter"] > 0


def test_tied_table_gradients_arrive_in_its_layout():
    """Each use of a tied DTensor table (the lookup, the unembedding)
    reaches it through a redistribute of its own, so every gradient that
    reaches the table arrives in the table's own placements and their sum
    redistributes nothing.  Left to the matmul, the unembedding's
    gradient arrived as (Partial(sum), ...), and torch 2.11 planned the
    sum through Shard(1) -> Partial(sum), which it refuses.  mamba2 at
    one layer on one pod, at its vocabulary (dp only) and at 50,304
    (dp and tp)."""
    code = (
        "import dataclasses, json, torch\n"
        "from torch.distributed.tensor.experimental import "
        "implicit_replication\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.distributed import sharding as shd\n"
        "from repro_torch.launch import dryrun\n"
        "from repro_torch.models import lm\n"
        "from repro_torch.models.model import Model\n"
        "mesh, dp = dryrun.cell_mesh('single')\n"
        "for vocab in (50280, 50304):\n"
        "    cfg = dataclasses.replace(get_config('mamba2-780m'), "
        "n_layers=1, vocab_size=vocab)\n"
        "    model = Model(cfg)\n"
        "    shd.activate(mesh, dp, 'model')\n"
        "    ps = model.shape_params()\n"
        "    module = lm.bind_params(dryrun._distribute(ps, "
        "shd.named_shardings(ps, cfg, mesh, dp, 'model'), mesh), cfg)\n"
        "    table = module.embed\n"
        "    tok = torch.empty((16, 64), dtype=torch.int32, "
        "device='meta')\n"
        "    b = {'tokens': tok, 'labels': tok}\n"
        "    b = dryrun._distribute(b, shd.batch_specs(b, mesh, dp), mesh)\n"
        "    with implicit_replication():\n"
        "        loss, _ = model.loss(module, b)\n"
        "    seen, todo, got = set(), [loss.grad_fn], []\n"
        "    while todo:\n"
        "        node = todo.pop()\n"
        "        if node is None or node in seen:\n"
        "            continue\n"
        "        seen.add(node)\n"
        "        for i, (nxt, _) in enumerate(node.next_functions):\n"
        "            if getattr(nxt, 'variable', None) is table:\n"
        "                node.register_hook(lambda gi, go, i=i, "
        "n=node.name(): got.append([n, str(tuple(gi[i].placements))]))\n"
        "            todo.append(nxt)\n"
        "    with implicit_replication():\n"
        "        torch.autograd.grad(loss, [table])\n"
        "    shd.deactivate()\n"
        "    print(json.dumps(dict(vocab=vocab, got=sorted(got), "
        "table=str(tuple(table.placements)))))\n")
    recs = _run_json(code)
    assert [r["table"] for r in recs] == [
        "(Shard(dim=1), Replicate())", "(Shard(dim=1), Shard(dim=0))"]
    for r in recs:
        assert len(r["got"]) == 2, r
        assert all(p == r["table"] for _, p in r["got"]), r


def test_cli_skips_and_reports_without_a_device():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "llama3.2-1b", "--shape", "long_500k", "--mesh", "single"],
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[SKIP] llama3.2-1b__long_500k__single" in out.stdout
    assert "0 OK, 1 skipped (documented), 0 FAILED" in out.stdout
