"""Multi-pod dry run: trace every (arch x shape x mesh) cell's step on a
fake 256- or 512-rank mesh (the port of the reference's
``launch/dryrun.py``).

The proof that the distribution config is coherent without the
hardware.  The reference lowers and compiles each step for 512
placeholder host devices; a torch process has no XLA, so here:

* **The mesh without the devices.**  torch.distributed's fake backend
  (``FakeStore``, the way torchtitan estimates memory) stands for 256 or
  512 ranks, this process being rank 0, and ``launch.mesh`` builds the
  production mesh on it ((16, 16) one pod; two pods' (2, 16, 16) enters
  DTensor as (32, 16), ``cell_mesh``).  Tensors
  are "meta" (shapes, no data) and collectives go to the fake group, so
  the dry run needs no device by nature, as the reference's placeholder
  host devices need none.  The group is started by ``run_cell``, never
  at import.
* **The cell.**  Parameters from ``Model.shape_params``, distributed as
  DTensors by ``sharding.named_shardings``; the optimizer state takes
  their placements; the batch ``batch_specs``, the cache
  ``cache_specs``; ``sharding.activate`` around the step.  The step is
  the port's own: ``Model.loss`` + ``torch.autograd.grad`` +
  ``optim.apply_updates`` (train), ``Model.prefill`` and one
  ``Model.decode`` token against an S-deep cache.
* **Cost.**  The step runs under ``cost_model.OpCounter``: FLOPs,
  bytes of eager traffic and every collective DTensor issues (by kind
  and result bytes).  A step of a full-depth model on meta tensors takes
  minutes in Python, so the step is traced on depth-cut copies of the
  model: one layer, and two layers with the second of each distinct
  window (hymba's global and window layers); every count is extrapolated
  linearly to the full depth (``traced`` in the record) -- the
  counterpart of the reference's ``loop_trip``, exact for a stack of
  identical layers.
* **All-to-all on a CPU mesh.**  DTensor's CPU route replaces a
  shard-to-shard all-to-all by an all-gather and a chunk; the counter
  records the all-to-all a CUDA mesh issues (the input's bytes) and not
  the all-gather, and the record counts the substitutions.
* **Memory.**  ``argument`` and ``output`` are the local shards' bytes of
  the full-depth step's inputs and outputs; ``temp`` and ``peak`` are
  None: an eager step on meta tensors has no allocator to read.
* **Roofline: the H100's own constants** (``HW``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --compression \\
      --out experiments/dryrun_torch
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from types import SimpleNamespace
from typing import Dict, List, Tuple

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.core.tree import leaves_with_keys, map_with_keys
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import change_ratio, hist
from repro_torch.launch import cost_model
from repro_torch.launch.mesh import (dp_axes, make_mesh,
                                     make_production_mesh, mesh_chips,
                                     tp_axis)
from repro_torch.models.config import SHAPES, runnable_shapes
from repro_torch.models.model import Model

# NVIDIA H100 SXM5 datasheet, per card: bf16 dense tensor FLOP/s, HBM3
# bytes/s, NVLink bytes/s each way.  The card these runs report on:
# "NVIDIA H100 80GB HBM3, 700.00 W" (nvidia-smi --query-gpu=name,
# power.limit --format=csv,noheader).
HW = dict(card="NVIDIA H100 80GB HBM3, 700.00 W",
          peak_flops_bf16=989.4e12, hbm_bw=3.35e12, nvlink_bw=450e9)

COUNTER_NOTE = ("eager unfused traffic: each op's inputs and outputs, "
                "an upper bound on a fused step; elementwise FLOPs 0")
MEMORY_NOTE = ("argument/output: local shards of the full-depth step; "
               "temp/peak: None, an eager step on meta tensors has no "
               "allocator to read")


# ---------------------------------------------------------------------------
# the fake fleet
# ---------------------------------------------------------------------------

_WORLDS: List[int] = []


def fake_world(size: int) -> None:
    """Make this process rank 0 of a fake process group of `size` ranks
    (restarting one of another size).  A process goes from one fleet to
    the next and never back: DTensor keeps redistribution plans by mesh
    shape, and a second mesh of a shape met before would reuse the
    groups of the first, which are gone."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    if size in _WORLDS:
        raise RuntimeError(f"a fake fleet of {size} ranks was this "
                           "process's before: run its cells first")
    _WORLDS.append(size)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def production_mesh(mesh_kind: str):
    """The production mesh of `mesh_kind` ("single" or "multi") on a fake
    fleet of its size."""
    multi = mesh_kind == "multi"
    fake_world(512 if multi else 256)
    return make_production_mesh(multi_pod=multi, device_type="cpu")


def cell_mesh(mesh_kind: str):
    """-> (mesh, dp axes) the cells' DTensors live on.  One pod: the
    production mesh.  Two pods: (2, 16, 16) with its "pod" and "data"
    axes flattened, row-major, into one "dp" axis of 32: the same ranks
    hold the same shards (DTensor shards a dim over (pod, data) pod-major,
    as the flattened axis does), and DTensor plans each redistribute of a
    dim sharded over two mesh dims ~25x slower in Python."""
    mesh = production_mesh(mesh_kind)
    if mesh_kind != "multi":
        return mesh, dp_axes(mesh)
    return make_mesh((32, 16), ("dp", "model"), "cpu"), ("dp",)


@contextlib.contextmanager
def _cuda_all_to_all(counter_box: List):
    """Count DTensor's CPU all-to-all fallback as the all-to-all a CUDA
    mesh issues: its input's bytes, and none of the all-gather inside."""
    from torch.distributed.tensor import placement_types as pt

    orig = pt.shard_dim_alltoall
    subs = counter_box[1]

    def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        counter = counter_box[0]
        if counter is None:
            return orig(input, gather_dim, shard_dim, mesh, mesh_dim)
        saved = dict(counter.collectives), dict(counter.collective_counts)
        out = orig(input, gather_dim, shard_dim, mesh, mesh_dim)
        counter.collectives.clear()
        counter.collectives.update(saved[0])
        counter.collective_counts.clear()
        counter.collective_counts.update(saved[1])
        counter.collectives["all-to-all"] += input.nbytes
        counter.collective_counts["all-to-all"] += 1
        subs[0] += 1
        return out

    pt.shard_dim_alltoall = shard_dim_alltoall
    try:
        yield
    finally:
        pt.shard_dim_alltoall = orig


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def _distribute(tree, specs, mesh):
    """Meta DTensors of `tree`'s leaves, each rank's shard (no data, no
    collective)."""
    from torch.distributed.tensor import distribute_tensor

    flat = dict(leaves_with_keys(specs))

    def one(key, t):
        spec = flat[key]
        if spec is None or not isinstance(t, torch.Tensor):
            return t
        pl = getattr(spec, "placements", None)
        if pl is None:
            pl = shd.placements(spec, mesh)
        return distribute_tensor(t, mesh, pl, src_data_rank=None)

    return map_with_keys(one, tree)


def _local_nbytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    total = 0
    for _, t in leaves_with_keys(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.nbytes
    return total


def _train_step_fn(model: Model):
    from repro_torch.train import optim
    from repro_torch.train.trainer import loss_and_grads
    ocfg = optim.AdamWConfig()

    def step(params, opt_state, batch):
        loss, _, grads = loss_and_grads(model, params, batch)
        params, opt_state, _ = optim.apply_updates(params, grads, opt_state,
                                                   ocfg)
        return params, opt_state, loss

    return step


def build_cell(model: Model, shape_name: str, mesh):
    """-> (fn, args): the cell's step and its DTensor arguments on
    `mesh`, the parameters, state, batch and cache of `model`."""
    from repro_torch.models import lm
    from repro_torch.train import optim

    cfg = model.cfg
    dp, tp = shd.active_axes()
    kind = SHAPES[shape_name]["kind"]
    S = SHAPES[shape_name]["seq_len"]

    params_s = model.shape_params()
    param_ns = shd.named_shardings(params_s, cfg, mesh, dp, tp)
    params = _distribute(params_s, param_ns, mesh)
    specs = model.input_specs(shape_name)

    if kind == "train":
        batch = _distribute(specs, shd.batch_specs(specs, mesh, dp), mesh)
        opt_s = optim.init_state(params_s)
        opt = optim.AdamState(
            step=_distribute(opt_s.step, shd.PartitionSpec(), mesh),
            m=_distribute(opt_s.m, param_ns, mesh),
            v=_distribute(opt_s.v, param_ns, mesh))
        return _train_step_fn(model), (params, opt, batch)

    module = lm.bind_params(params, cfg)
    if kind == "prefill":
        batch = _distribute(specs, shd.batch_specs(specs, mesh, dp), mesh)

        def fn(params, batch):
            return model.prefill(params, batch, s_max=S)

        return fn, (module, batch)

    # decode: one new token against a seq_len-deep cache
    cache_s = specs["cache"]
    cache = _distribute(cache_s, shd.cache_specs(
        cache_s, mesh, dp, tp, stacked=not lm.uses_layer_loop(cfg)), mesh)
    toks_s = {k: v for k, v in specs.items() if k != "cache"}
    toks = _distribute(toks_s, shd.batch_specs(toks_s, mesh, dp), mesh)

    def fn(params, cache, toks):
        return model.decode(params, cache, token=toks.get("token"),
                            pos=toks["pos"], embed=toks.get("embed"))

    return fn, (module, cache, toks)


def traced_depths(cfg) -> List[Tuple[object, float]]:
    """[(depth-cut config, weight)]: the full step's count is the weighted
    sum of the cut configs' counts.  One layer (the first layer's window)
    with weight 2 - L, and for each distinct window w two layers (the
    first's window, then w) with weight n_w minus one for the first
    layer's window: for a uniform stack c1 + (L - 1) (c2 - c1)."""
    from repro_torch.models.lm import layer_flags

    windows = [int(w) for w in layer_flags(cfg)]
    L = len(windows)

    def cut(ws):
        kw = dict(n_layers=len(ws))
        if cfg.global_attn_layers:
            kw["global_attn_layers"] = tuple(
                i for i, w in enumerate(ws) if w == 0)
        return dataclasses.replace(cfg, **kw)

    out = [(cut(windows[:1]), 2.0 - L)]
    for w, n in cost_model.layer_windows(cfg):
        out.append((cut([windows[0], w]), float(n - (w == windows[0]))))
    return [(c, wt) for c, wt in out if wt]


# meta outputs by op and argument shapes, shared by every trace of the
# process (cost_model.OpCounter); the counts of one local attention call
# by its arguments' layouts (_local_attention)
_META_MEMO: Dict = {}
_ATTN_MEMO: Dict = {}


@contextlib.contextmanager
def _local_attention(counter_box: List, warm: bool):
    """``layers.chunked_sdpa`` on one rank's shards (plain meta tensors,
    inference steps only), by its arguments' layouts: its block loop runs
    once and later calls with the same layouts count what it counted
    (the same ops on the same shapes).  In an uncounted warm-up the loop
    does not run at all: it touches no DTensor, so it has nothing to
    warm."""
    from repro_torch.models import layers

    orig = layers.chunked_sdpa

    def chunked_sdpa(q, k, v, **kw):
        from torch.distributed.tensor import DTensor
        if isinstance(q, DTensor) or torch.is_grad_enabled():
            return orig(q, k, v, **kw)
        shape = (*q.shape[:3], v.shape[-1])
        counter = counter_box[0]
        if warm or counter is None:
            return torch.empty(shape, dtype=q.dtype, device=q.device)
        key = (tuple((tuple(t.shape), t.stride(), t.dtype)
                     for t in (q, k, v, kw["q_pos"], kw["kv_pos"])),
               tuple(sorted((n, x) for n, x in kw.items()
                            if not isinstance(x, torch.Tensor))))
        delta = _ATTN_MEMO.get(key)
        if delta is None:
            before = counter.snapshot()
            out = orig(q, k, v, **kw)
            _ATTN_MEMO[key] = counter.difference(counter.snapshot(), before)
            return out
        counter.add(delta)
        return torch.empty(shape, dtype=q.dtype, device=q.device)

    layers.chunked_sdpa = chunked_sdpa
    try:
        yield
    finally:
        layers.chunked_sdpa = orig


def _trace(model: Model, shape_name: str, mesh, count: bool = True):
    """One step of `model` under an ``OpCounter`` -> its cost.  With
    ``count=False`` the step runs uncounted: DTensor's first dispatch of
    an op derives its sharding (shape propagation on fake tensors,
    strategy search) through ops that reach the counter, so every counted
    step runs after one that filled DTensor's caches."""
    from torch.distributed.tensor.experimental import implicit_replication

    fn, args = build_cell(model, shape_name, mesh)
    box = [None, [0]]
    # tensors the step makes itself (positions, masks) are replicated
    with _cuda_all_to_all(box), implicit_replication(), \
            _local_attention(box, warm=not count):
        with cost_model.OpCounter(_META_MEMO) as counter:
            if not count:
                fn(*args)
                return None
            box[0] = counter
            fn(*args)
        box[0] = None
    cost = counter.cost()
    cost["all_to_all_substituted"] = box[1][0]
    return cost


def _combine(parts: List[Tuple[Dict, float]]) -> Dict:
    out = dict(flops=0.0, bytes=0.0, collectives={}, collective_counts={},
               ops=0.0, all_to_all_substituted=0.0)
    for cost, wt in parts:
        out["flops"] += wt * cost["flops"]
        out["bytes"] += wt * cost["bytes accessed"]
        out["ops"] += wt * cost["ops"]
        out["all_to_all_substituted"] += wt * cost["all_to_all_substituted"]
        for field in ("collectives", "collective_counts"):
            for k, v in cost[field].items():
                out[field][k] = out[field].get(k, 0.0) + wt * v
    return out


def _io_bytes(model: Model, shape_name: str, mesh) -> Dict:
    """Local bytes of the full-depth step's arguments and outputs."""
    from repro_torch.models import lm
    cfg = model.cfg
    kind = SHAPES[shape_name]["kind"]
    dp, tp = shd.active_axes()
    params_s = model.shape_params()
    params = _distribute(params_s, shd.named_shardings(params_s, cfg, mesh,
                                                       dp, tp), mesh)
    specs = model.input_specs(shape_name)
    p = _local_nbytes(params)
    if kind == "train":
        batch = _distribute(specs, shd.batch_specs(specs, mesh, dp), mesh)
        b = _local_nbytes(batch)
        # params + Adam m and v in float32 + the step; out: the same + loss
        state = 2 * sum(t.to_local().numel() * 4
                        for _, t in leaves_with_keys(params)) + 4
        return dict(argument=p + state + b, output=p + state + 4)
    B = SHAPES[shape_name]["global_batch"]
    S = SHAPES[shape_name]["seq_len"]
    cache_s = (specs["cache"] if kind == "decode"
               else model.empty_cache(B, S, device="meta"))
    cache = _local_nbytes(_distribute(cache_s, shd.cache_specs(
        cache_s, mesh, dp, tp, stacked=not lm.uses_layer_loop(cfg)), mesh))
    logits = B * cfg.vocab_size * 4
    if kind == "prefill":
        batch = _distribute(specs, shd.batch_specs(specs, mesh, dp), mesh)
        return dict(argument=p + _local_nbytes(batch),
                    output=logits + cache + 4)
    toks_s = {k: v for k, v in specs.items() if k != "cache"}
    toks = _distribute(toks_s, shd.batch_specs(toks_s, mesh, dp), mesh)
    return dict(argument=p + cache + _local_nbytes(toks),
                output=logits + cache)


def _terms(flops, byts, coll) -> Dict[str, float]:
    return dict(compute_s=flops / HW["peak_flops_bf16"],
                memory_s=byts / HW["hbm_bw"],
                collective_s=coll / HW["nvlink_bw"])


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir=None):
    cfg = get_config(arch)
    model = Model(cfg)
    if shape_name not in runnable_shapes(cfg):
        rec = dict(arch=arch, shape=shape_name, mesh=mesh_kind,
                   status="SKIP", reason="full attention at 500k "
                   "(DESIGN.md Sec. 5)")
        _emit(rec, out_dir)
        return rec

    t0 = time.time()
    try:
        mesh, dp = cell_mesh(mesh_kind)
        parts = []
        t_build = 0.0
        shd.activate(mesh, dp, tp_axis(mesh),
                     shard_seq=(cfg.name == "qwen1.5-110b"))
        try:
            for cut_cfg, wt in traced_depths(cfg):
                _trace(Model(cut_cfg), shape_name, mesh, count=False)
                parts.append((_trace(Model(cut_cfg), shape_name, mesh), wt))
            t_trace = time.time() - t0
            io = _io_bytes(model, shape_name, mesh)
            t_build = time.time() - t0 - t_trace
        finally:
            shd.deactivate()
        cost = _combine(parts)
        chips = mesh_chips(mesh)
        colls = {k: float(v) for k, v in cost["collectives"].items()}
        colls["total"] = float(sum(cost["collectives"].values()))
        flops_dev, bytes_dev = cost["flops"], cost["bytes"]
        coll_dev = colls["total"]
        terms = _terms(flops_dev, bytes_dev, coll_dev)

        # analytical totals (held against the counted step in
        # tests/test_torch_dryrun.py)
        dp_size = 1
        for a in dp:
            dp_size *= shd.axis_size(mesh, a)
        ana = cost_model.cell_cost(cfg, shape_name, chips=chips,
                                   dp=dp_size,
                                   tp=shd.axis_size(mesh, "model"))
        ana_flops_dev = ana.flops_total / chips
        ana_bytes_dev = ana.bytes_total / chips
        ana_terms = _terms(ana_flops_dev, ana_bytes_dev, coll_dev)
        dominant = max(ana_terms, key=ana_terms.get)
        n_params = cfg.param_count()
        n_active = cfg.active_param_count()
        sh = SHAPES[shape_name]
        tokens = sh["global_batch"] * (sh["seq_len"]
                                       if sh["kind"] != "decode" else 1)
        mf = 6 * n_active * tokens * (1 if sh["kind"] == "train" else 1 / 3)
        rec = dict(
            arch=arch, shape=shape_name, mesh=mesh_kind, status="OK",
            chips=chips,
            flops_per_device=flops_dev, bytes_per_device=bytes_dev,
            collective_bytes_per_device=coll_dev,
            collectives=colls,
            collective_counts=cost["collective_counts"],
            all_to_all_substituted=cost["all_to_all_substituted"],
            roofline_hlo_raw=terms,
            analytic_flops_per_device=ana_flops_dev,
            analytic_bytes_per_device=ana_bytes_dev,
            roofline=ana_terms, dominant=dominant,
            model_flops=mf,
            useful_ratio=(mf / ana.flops_total
                          if ana.flops_total else None),
            memory=dict(argument=io["argument"], output=io["output"],
                        temp=None, peak=None),
            memory_note=MEMORY_NOTE, counter_note=COUNTER_NOTE,
            traced=[dict(n_layers=c.n_layers, weight=w)
                    for c, w in traced_depths(cfg)],
            ops_per_device=cost["ops"], hw=HW,
            lower_s=round(t_build, 2), compile_s=round(t_trace, 2),
            n_params=n_params, n_active_params=n_active,
        )
    except Exception as e:  # noqa: BLE001 -- dry-run failures are findings
        rec = dict(arch=arch, shape=shape_name, mesh=mesh_kind,
                   status="FAIL", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    _emit(rec, out_dir)
    return rec


def _emit(rec, out_dir):
    tag = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"
    if rec["status"] == "OK":
        t = rec["roofline"]
        print(f"[{rec['status']}] {tag}: dominant={rec['dominant']} "
              f"compute={t['compute_s']:.3e}s memory={t['memory_s']:.3e}s "
              f"collective={t['collective_s']:.3e}s "
              f"counted_flops/dev={rec['flops_per_device']:.4e} "
              f"arg/dev={_fmt_b(rec['memory']['argument'])} "
              f"(build {rec.get('lower_s', '-')}s "
              f"trace {rec.get('compile_s', '-')}s)", flush=True)
    else:
        print(f"[{rec['status']}] {tag}: "
              f"{rec.get('reason', rec.get('error', ''))[:300]}", flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        safe = tag.replace("/", "_").replace(".", "_")
        with open(os.path.join(out_dir, safe + ".json"), "w") as f:
            json.dump(rec, f, indent=1, default=str)


def _fmt_b(n):
    if n is None:
        return "?"
    for u in ("B", "KB", "MB", "GB", "TB"):
        if n < 1024:
            return f"{n:.1f}{u}"
        n /= 1024
    return f"{n:.1f}PB"


def collective_bytes(counter) -> Dict[str, float]:
    """Per-device bytes moved by collectives, from an ``OpCounter``: the
    result bytes of each kind, ``total`` and ``total_raw`` (equal: every
    layer is traced, so no loop body is counted once)."""
    out = {k: float(v) for k, v in counter.collectives.items()}
    out["total"] = float(sum(counter.collectives.values()))
    out["total_raw"] = out["total"]
    return out


# the plain versions of the analyze stage's kernels, which trace on meta
_PLAIN = SimpleNamespace(
    change_ratio_bins=change_ratio.change_ratio_bins_plain,
    histogram=hist.histogram_plain)


def run_compression_dryrun(mesh_kind: str, out_dir=None,
                           n_elems: int = 2_000_000_000):
    """Paper-representative cell: the NUMARCK analyze stage over the
    mesh's first axis, one shard a rank (the reference shards over the
    first axis only, for the paper's one flat Allreduce).

    The traced stage is the device part of the port's sharded
    ``_analyze``, through the plain versions on meta tensors: each
    shard's change ratios and the two ends of its range pass (gathered
    across the ranks as ``collectives.allreduce_minmax`` gathers them;
    the ends' values come to the host there, which a meta tensor
    cannot, so the domain is the fixed one), then
    ``pipeline.analyze_device``: candidate bins, histogram, the summed
    histogram's Allreduce and its sort.  Auto-B runs on the host.
    n defaults to 2e9 float32 elements (8 GB, the int32-offset envelope).
    """
    from torch.distributed import _functional_collectives as funcol

    from repro_torch.core import ratios
    from repro_torch.core.types import NumarckParams
    from repro_torch.distributed import pipeline as pl

    params = NumarckParams(error_bound=1e-3, max_bins=1 << 16)
    t0 = time.time()
    try:
        mesh = production_mesh(mesh_kind)
        axis = mesh.mesh_dim_names[0]
        n_shards = shd.axis_size(mesh, axis)
        ln = n_elems // n_shards
        group = (mesh, 0)
        prev = torch.empty(ln, dtype=torch.float32, device="meta")
        curr = torch.empty(ln, dtype=torch.float32, device="meta")
        width = 2.0 * params.error_bound
        domain_lo = -0.5 * width * params.max_bins

        def stage():
            r, valid = ratios.change_ratios(prev, curr)
            ends = ratios.valid_ends_device(r, valid)
            gather = getattr(funcol, "all_gather_single",
                             funcol.all_gather_tensor)
            gather(ends, 0, group)
            return pl.analyze_device(
                ["meta"], [prev], [curr], domain_lo, width,
                params.max_bins, max_bins=params.max_bins,
                reduce_sum=lambda hs: funcol.all_reduce(hs[0], "sum",
                                                        group),
                kernels=_PLAIN)

        with cost_model.OpCounter() as counter:
            stage()
        colls = collective_bytes(counter)
        flops, byts = float(counter.flops), float(counter.bytes)
        rec = dict(arch="numarck-pipeline", shape=f"n{n_elems:.0e}",
                   mesh=mesh_kind, status="OK", chips=mesh_chips(mesh),
                   shards=n_shards,
                   flops_per_device=flops, bytes_per_device=byts,
                   collective_bytes_per_device=colls["total"],
                   collectives=colls,
                   roofline=_terms(flops, byts, colls["total"]),
                   memory=dict(argument=prev.nbytes + curr.nbytes,
                               output=None, temp=None, peak=None),
                   memory_note=MEMORY_NOTE, counter_note=COUNTER_NOTE,
                   hw=HW, compile_s=round(time.time() - t0, 2))
        rec["dominant"] = max(rec["roofline"], key=rec["roofline"].get)
    except Exception as e:  # noqa: BLE001
        rec = dict(arch="numarck-pipeline", shape=f"n{n_elems:.0e}",
                   mesh=mesh_kind, status="FAIL",
                   error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    _emit(rec, out_dir)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all",
                    help="arch id, comma list, or 'all'")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single,multi")
    ap.add_argument("--all", action="store_true",
                    help="every arch and shape (the defaults)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--compression", action="store_true",
                    help="also dry-run the NUMARCK pipeline cell")
    args = ap.parse_args(argv)
    if args.all:
        args.arch = args.shape = "all"

    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = args.mesh.split(",")

    results = []
    for mesh_kind in meshes:
        for arch in archs:
            for shape in shapes:
                results.append(run_cell(arch, shape, mesh_kind, args.out))
        if args.compression:
            results.append(run_compression_dryrun(mesh_kind, args.out))

    n_ok = sum(r["status"] == "OK" for r in results)
    n_skip = sum(r["status"] == "SKIP" for r in results)
    n_fail = sum(r["status"] == "FAIL" for r in results)
    print(f"\n== dry-run: {n_ok} OK, {n_skip} skipped (documented), "
          f"{n_fail} FAILED ==")
    if n_fail:
        raise SystemExit(1)


__all__ = ["HW", "build_cell", "run_cell", "run_compression_dryrun",
           "collective_bytes", "main", "fake_world", "production_mesh",
           "cell_mesh", "traced_depths"]


if __name__ == "__main__":
    main()
