"""The port's checkpoint manager against the JAX package's, mirroring
tests/test_checkpoint.py.

The same numpy tree saved by both managers gives the same step files and
``MANIFEST.json`` byte for byte, with a host chain and with a device chain
on a CPU device; a tree of torch tensors gives the same files as its
numpy twin.  Then the manager's own contract: round trip within the
bound, retention, async double-buffering, mutation after submit, the
walk-back restore and its report, a crashed save never committed, and
template restore onto tensors.  All on the CPU (the kernels' plain
versions).
"""
import json
import os
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.core.types import NumarckParams as JParams  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import chain as chainmod  # noqa: E402
from repro_torch.core import compress as tcompress  # noqa: E402
from repro_torch.core import container  # noqa: E402
from repro_torch.core.types import NumarckParams  # noqa: E402
from repro_torch.obs import report, telemetry  # noqa: E402

E = 1e-3
KW = dict(error_bound=E, block_bytes=4096)


def _state(seed: int, scale: float = 1.0) -> dict:
    """The reference test's tree, as numpy arrays: lossy matrices, an
    exempt norm scale and step counter, and a list of two tensors."""
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "w1": (rng.standard_normal((64, 128)) * scale).astype(np.float32),
            "norm": {"scale": np.ones(128, np.float32)},
            "blocks": [rng.standard_normal((48, 96)).astype(np.float32),
                       rng.standard_normal(4100).astype(np.float64)],
        },
        "opt": {
            "m": (rng.standard_normal((64, 128)) * 0.01).astype(np.float32),
            "step": np.int32(7),
        },
        "big": (rng.standard_normal((100, 101)) * scale).astype(np.float32),
    }


def _evolve(state, rng):
    """Small multiplicative drift -- mimics optimizer steps."""
    if isinstance(state, dict):
        return {k: _evolve(v, rng) for k, v in state.items()}
    if isinstance(state, list):
        return [_evolve(v, rng) for v in state]
    if np.issubdtype(state.dtype, np.floating):
        return state * (1 + 0.01 * rng.standard_normal(state.shape)
                        ).astype(state.dtype)
    return state


def _to_torch(state):
    if isinstance(state, dict):
        return {k: _to_torch(v) for k, v in state.items()}
    if isinstance(state, list):
        return [_to_torch(v) for v in state]
    return torch.from_numpy(np.array(state))


def _files(d) -> dict:
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def _save_series(mgr, n_saves, seed, torch_tree=False):
    rng = np.random.default_rng(seed + 100)
    state = _state(seed)
    saved = []
    for step in range(n_saves):
        out = mgr.save(step, _to_torch(state) if torch_tree else state)
        saved.append(out)
        state = _evolve(state, rng)
    mgr.wait()
    return saved


@pytest.mark.parametrize("chain", ["host", "device"])
@pytest.mark.parametrize("keep", [10, 2])
def test_step_files_and_manifest_match_jax(tmp_path, chain, keep):
    """Five saves (two anchors at anchor_every=3) through both managers:
    identical step files and MANIFEST.json, retention included."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    _save_series(JManager(str(jdir), JParams(**KW), anchor_every=3,
                          keep=keep), 5, seed=0)
    _save_series(CheckpointManager(str(tdir), NumarckParams(**KW),
                                   anchor_every=3, keep=keep, chain=chain,
                                   device="cpu"), 5, seed=0)
    want, got = _files(jdir), _files(tdir)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    if keep == 2:
        m = json.loads(got["MANIFEST.json"])
        assert m["steps"] == [3, 4] and m["anchors"] == [3]


def test_torch_tree_gives_the_numpy_trees_files(tmp_path):
    """CPU tensors (async saves, device chain) and their numpy twins
    (blocking, host chain) write the same files."""
    a = CheckpointManager(str(tmp_path / "np"), NumarckParams(**KW),
                          anchor_every=3, keep=10, device="cpu")
    b = CheckpointManager(str(tmp_path / "pt"), NumarckParams(**KW),
                          anchor_every=3, keep=10, chain="device",
                          async_save=True, device="cpu")
    _save_series(a, 4, seed=1)
    futs = _save_series(b, 4, seed=1, torch_tree=True)
    assert [f.result()["anchor"] for f in futs] == [True, False, False, True]
    assert _files(tmp_path / "np") == _files(tmp_path / "pt")


def test_save_restore_roundtrip_within_the_bound(tmp_path):
    mgr = CheckpointManager(str(tmp_path), NumarckParams(**KW),
                            anchor_every=3, keep=10, chain="device",
                            device="cpu")
    rng = np.random.default_rng(10)
    state = _state(0)
    for step in range(6):
        stats = mgr.save(step, state)
        assert stats["comp_bytes"] > 0
        last = state
        state = _evolve(state, rng)
    step, tree = mgr.restore_latest()
    assert step == 5
    lossy = 0
    for (key, got), (_, want) in zip(_leaves(tree), _leaves(last)):
        assert got.dtype == want.dtype and got.shape == np.shape(want), key
        if ("scale" in key or "step" in key or got.size < 4096):
            np.testing.assert_array_equal(got, want, err_msg=key)
            continue
        lossy += 1
        rel = np.abs(got - want) / np.abs(want)
        # |recon - x| <= E |prev recon| elementwise, so relative to x the
        # bound is E / (1 + r) for the step's ratio r (1 % drift here)
        assert rel.max() <= E * 1.1, key
        assert rel.mean() <= E, key
    assert lossy == 5
    assert mgr.last_restore_report == []


def test_delta_compression_beats_lossless(tmp_path):
    mgr = CheckpointManager(str(tmp_path), NumarckParams(
        error_bound=E, block_bytes=8192), anchor_every=100, keep=100,
        device="cpu")
    rng = np.random.default_rng(3)
    state = {"w": rng.standard_normal((256, 256)).astype(np.float32)}
    s0 = mgr.save(0, state)
    s1 = mgr.save(1, _evolve(state, rng))
    assert s1["comp_bytes"] < s0["comp_bytes"] * 0.6


def test_retention_keeps_chain(tmp_path):
    mgr = CheckpointManager(str(tmp_path), anchor_every=3, keep=2,
                            device="cpu")
    _save_series(mgr, 8, seed=4)
    m = json.loads((tmp_path / "MANIFEST.json").read_text())
    step, _ = CheckpointManager(str(tmp_path), device="cpu").restore_latest()
    assert step == 7
    assert m["steps"] == [6, 7] and m["anchors"] == [6]
    assert all((tmp_path / f"step_{s:08d}.nck").exists() for s in m["steps"])
    assert not (tmp_path / "step_00000005.nck").exists()


def test_async_save_double_buffered(tmp_path):
    """Overlapping async saves land in order and all restore; the save
    spans ride the ckpt-save worker."""
    mgr = CheckpointManager(str(tmp_path), async_save=True, anchor_every=2,
                            keep=10, device="cpu")
    with telemetry.capture() as reg:
        futs = _save_series(mgr, 5, seed=6)
    assert all(f.done() for f in futs)
    assert [f.result()["anchor"] for f in futs] == [True, False, True, False,
                                                    True]
    step, _ = mgr.restore_latest()
    assert step == 4
    m = json.loads((tmp_path / "MANIFEST.json").read_text())
    assert m["steps"] == [0, 1, 2, 3, 4]
    spans = report.rollup(reg)["spans"]
    for name in ("ckpt.save", "ckpt.encode", "ckpt.write", "ckpt.manifest",
                 "nck.write", "nck.fsync", "nck.rename", "ckpt-save.task"):
        assert name in spans, name
    assert spans["ckpt.save"]["count"] == 5
    lanes = {r.tname for r in reg.spans if r.name == "ckpt.save"}
    assert all(t.startswith("ckpt-save") for t in lanes), lanes
    mgr.close()


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_async_save_mutation_after_submit_is_safe(tmp_path, kind):
    """The caller may mutate its state right after save() returns: numpy
    arrays and CPU tensors (whose .numpy() shares memory) alike."""
    mgr = CheckpointManager(str(tmp_path), async_save=True, device="cpu")
    arr = np.random.default_rng(7).normal(size=(64, 64)).astype(np.float32)
    want = arr.copy()
    leaf = arr if kind == "numpy" else torch.from_numpy(arr)
    mgr.save(0, {"w": leaf})
    leaf[:] = -1.0                        # the next optimizer step
    mgr.wait()
    _, tree = mgr.restore_latest()
    np.testing.assert_array_equal(tree["w"], want)


def test_corruption_walks_back_and_reports(tmp_path):
    mgr = CheckpointManager(str(tmp_path), anchor_every=2, keep=10,
                            device="cpu")
    _save_series(mgr, 4, seed=2)
    newest = tmp_path / "step_00000003.nck"
    raw = bytearray(newest.read_bytes())
    raw[len(raw) // 2] ^= 0x40
    newest.write_bytes(bytes(raw))
    mgr2 = CheckpointManager(str(tmp_path), device="cpu")
    step, _ = mgr2.restore_latest()
    assert step == 2                      # walked back past the corruption
    assert len(mgr2.last_restore_report) == 1
    assert mgr2.last_restore_report[0]["step"] == 3
    assert "Corrupt" in mgr2.last_restore_report[0]["error"]


def test_crashed_save_never_committed_to_manifest(tmp_path, monkeypatch):
    """A save that dies mid-write leaves the manifest and the delta chains
    untouched: the next save encodes against the last persisted step."""
    mgr = CheckpointManager(str(tmp_path), async_save=True, device="cpu")
    state = _state(8)
    mgr.save(0, state)
    mgr.wait()
    real_write = container.NCKWriter.write

    def dying_write(self, path):
        with open(path, "wb") as f:
            f.write(b"NCK1\x00torn")
        raise RuntimeError("simulated crash during checkpoint write")

    monkeypatch.setattr(container.NCKWriter, "write", dying_write)
    fut = mgr.save(1, state)
    with pytest.raises(RuntimeError, match="simulated crash"):
        fut.result()
    monkeypatch.setattr(container.NCKWriter, "write", real_write)
    m = json.loads((tmp_path / "MANIFEST.json").read_text())
    assert m["steps"] == [0]
    step, _ = CheckpointManager(str(tmp_path), device="cpu").restore_latest()
    assert step == 0
    state2 = _evolve(state, np.random.default_rng(9))
    with pytest.raises(RuntimeError, match="simulated crash"):
        mgr.save(1, state2)               # the failed save surfaces again
    mgr.save(1, state2).result()
    step, tree = mgr.restore_latest()
    assert step == 1
    want = state2["params"]["w1"]
    rel = np.abs(tree["params"]["w1"] - want) / np.abs(want)
    assert rel.max() <= E * 1.1           # chained off step 0


def test_restore_with_template(tmp_path):
    """Leaves take the template's structure, shape, dtype and device: a
    "meta" tensor lands on the manager's device, a Python int stays one."""
    mgr = CheckpointManager(str(tmp_path), anchor_every=2, device="cpu")
    state = _state(1)
    mgr.save(0, state)
    tmpl = _to_torch(state)
    tmpl["params"]["w1"] = torch.empty(64, 128, device="meta")
    tmpl["params"]["blocks"] = tuple(tmpl["params"]["blocks"])
    tmpl["opt"]["step"] = 0
    step, tree = mgr.restore_latest(template=tmpl)
    assert step == 0
    assert isinstance(tree["params"]["blocks"], tuple)
    w1 = tree["params"]["w1"]
    assert w1.device.type == "cpu" and w1.dtype == torch.float32
    np.testing.assert_array_equal(w1.numpy(), state["params"]["w1"])
    b1 = tree["params"]["blocks"][1]
    assert b1.dtype == torch.float64 and tuple(b1.shape) == (4100,)
    assert tree["opt"]["step"] == 7 and isinstance(tree["opt"]["step"], int)
    _, plain = mgr.restore_latest()
    assert plain["params"]["blocks"].keys() == {"0", "1"}


def test_bfloat16_leaf_matches_jax_and_restores_as_bfloat16(tmp_path):
    """A bfloat16 leaf is a lossless anchor on every save, as in the
    reference: three saves of a tree with one (a torch tensor here, an
    ml_dtypes array there) give byte-identical step files and
    MANIFEST.json, and restore_latest(template=) returns it as
    torch.bfloat16, bit for bit; without a template too."""
    ml_dtypes = pytest.importorskip("ml_dtypes")
    rng = np.random.default_rng(3)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jm = JManager(str(jdir), JParams(**KW), anchor_every=2, keep=10)
    tm = CheckpointManager(str(tdir), NumarckParams(**KW), anchor_every=2,
                           keep=10, device="cpu")
    state = _state(4)
    for step in range(3):
        w = rng.standard_normal((40, 130)).astype(ml_dtypes.bfloat16)
        jm.save(step, dict(state, w=w))
        tm.save(step, dict(_to_torch(state),
                           w=torch.from_numpy(w.view(np.int16)).view(
                               torch.bfloat16)))
        state = _evolve(state, rng)
    jm.wait()
    want, got = _files(jdir), _files(tdir)
    assert sorted(got) == sorted(want) and len(want) == 4
    for name in want:
        assert got[name] == want[name], name
    tmpl = dict(_to_torch(state), w=torch.zeros((40, 130),
                                                dtype=torch.bfloat16))
    step, tree = tm.restore_latest(template=tmpl)
    assert step == 2 and tree["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tree["w"].view(torch.int16).numpy(),
                                  w.view(np.int16))
    _, plain = tm.restore_latest()
    assert plain["w"].dtype == torch.bfloat16
    assert torch.equal(plain["w"].view(torch.int16), tree["w"].view(
        torch.int16))


@pytest.mark.parametrize("residency", ["host", "device"])
def test_chain_fork_is_a_handle_copy(residency):
    """Advancing a fork leaves the original's state as it was: every
    advance builds a new state, so fork() may be a shallow copy."""
    rng = np.random.default_rng(5)
    prev = rng.standard_normal(8192).astype(np.float32)
    curr = prev * (1 + 0.01 * rng.standard_normal(8192)).astype(np.float32)
    c = chainmod.make_reference_chain(residency, np.float32,
                                      torch.device("cpu"))
    c.seed(prev)
    dev = tcompress.encode_device(c.peek(), curr, NumarckParams(**KW),
                                  device="cpu")
    f = c.fork()
    state = c.peek()
    f.advance(dev, curr)
    assert c.peek() is state
    np.testing.assert_array_equal(c.to_host(), prev)
    assert not np.array_equal(f.to_host(), prev)
    f.reset()
    assert f.empty and not c.empty



class _Moments(NamedTuple):
    step: object
    m: object
    v: object


class _Resid(NamedTuple):
    residual: object


def _nt_state(scale: float = 1.0, jax_types: bool = False) -> dict:
    """A train-state-shaped numpy tree: NamedTuples (the reference's own
    AdamState and GradCompState, or the port's look-alikes) beside
    dicts, lossy leaves in each."""
    from repro.train.gradcomp import GradCompState
    from repro.train.optim import AdamState
    moments, resid = ((AdamState, GradCompState) if jax_types
                      else (_Moments, _Resid))
    s = _state(3, scale)
    return {"params": s["params"],
            "opt_state": moments(np.int32(3), s["big"],
                                 {"w": s["opt"]["m"]}),
            "gc_state": resid({"w": s["params"]["w1"] * np.float32(0.5)})}


def _to_torch_nt(tree):
    """_to_torch through NamedTuples."""
    from repro_torch.core.tree import map_with_keys
    return map_with_keys(lambda _, x: torch.from_numpy(np.array(x)), tree)


def test_namedtuple_keys_match_jax():
    """A NamedTuple's fields key as jax's GetAttrKey does (``.name``),
    in field order; map_with_keys rebuilds the NamedTuple."""
    import jax

    from repro_torch.core import tree as T
    want = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path) for path, _ in
            jax.tree_util.tree_flatten_with_path(_nt_state(jax_types=True))[0]]
    got = [k for k, _ in T.leaves_with_keys(_nt_state())]
    assert got == want
    assert "opt_state/.step" in got and "opt_state/.v/w" in got
    mapped = T.map_with_keys(lambda k, x: k, _nt_state())
    assert isinstance(mapped["opt_state"], _Moments)
    assert mapped["opt_state"].m == "opt_state/.m"
    assert mapped["gc_state"].residual["w"] == "gc_state/.residual/w"


@pytest.mark.parametrize("chain", ["host", "device"])
def test_namedtuple_tree_matches_jax_and_restores(tmp_path, chain):
    """A tree of NamedTuples through both managers (an anchor, then a
    delta at 1 % drift): identical files; the port's restore onto a
    NamedTuple template gives NamedTuples back, and without one the
    reference's nested dicts with ``.name`` keys, leaf for leaf."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jm = JManager(str(jdir), JParams(**KW), anchor_every=2, keep=10)
    tm = CheckpointManager(str(tdir), NumarckParams(**KW), anchor_every=2,
                           keep=10, chain=chain, device="cpu")
    for step, scale in enumerate((1.0, 1.01)):
        jm.save(step, _nt_state(scale, jax_types=True))
        tm.save(step, _to_torch_nt(_nt_state(scale)))
    want, got = _files(jdir), _files(tdir)
    assert sorted(got) == sorted(want) and len(want) == 3
    for name in want:
        assert got[name] == want[name], name
    step, tree = tm.restore_latest(template=_to_torch_nt(_nt_state()))
    assert step == 1
    assert isinstance(tree["opt_state"], _Moments)
    assert isinstance(tree["gc_state"], _Resid)
    assert tree["opt_state"].step.dtype == torch.int32
    assert int(tree["opt_state"].step) == 3
    _, jplain = jm.restore_latest()
    _, plain = tm.restore_latest()
    assert set(plain["opt_state"]) == {".step", ".m", ".v"}
    assert [k for k, _ in _leaves(plain)] == [k for k, _ in _leaves(jplain)]
    for (k, a), (_, b) in zip(_leaves(plain), _leaves(jplain)):
        np.testing.assert_array_equal(a, b, err_msg=k)
    from repro_torch.core.tree import leaves_with_keys
    restored = dict(leaves_with_keys(tree))
    for k, a in _leaves(plain):
        np.testing.assert_array_equal(a, restored[k].numpy(), err_msg=k)
