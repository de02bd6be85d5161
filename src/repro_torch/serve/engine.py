"""Batched serving engine: prefill + streaming decode with KV caches (the
port of the reference's ``serve/engine.py``).

Requests are padded into a fixed batch; the engine runs one prefill and
then one decode step a token on its device (CUDA unless the caller
passes ``device="cpu"``; without a GPU a CUDA engine raises).  PyTorch
runs eagerly, so there is nothing to trace: the reference's "one jitted
executable per (batch, s_max)" becomes a session template (each leaf's
shape, dtype and device) that a restored session must match exactly.

Session persistence: `snapshot_cache` / `load_cache` store a decode
cache in an NCK container through the compression pipeline's lossless
anchors (the entropy codec registry), byte-identical to the reference's
files; bfloat16 leaves record ``dtype="bfloat16"`` over their 2-byte
values.  A restore decodes each leaf straight onto the device
(``decode_anchor_device``: with ``codec="rans"`` the rANS decode kernel
inflates every leaf of at least ``rans.DEVICE_MIN_BYTES``).

Sessions are held as ``core.chain.SessionChain`` handles: the cache,
resume token and position stay on the device between requests and only
cross to the host through ``.to_host()`` at the durable-write boundary
(``save_session``).  Each decode step writes the cache in place.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.chain import SessionChain, resolve_device
from repro_torch.core.compress import decode_anchor_device, make_anchor
from repro_torch.core.container import NCKReader, NCKWriter
from repro_torch.core.tree import leaves_with_paths, map_with_keys, nest
from repro_torch.core.types import NumarckParams, host_storage, step_dtype
from repro_torch.faults.errors import IntegrityError
from repro_torch.models.model import Model
from repro_torch.obs import telemetry


@dataclass(frozen=True)
class LeafSpec:
    """Shape, dtype and device of one session leaf."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: torch.device


def _tree_keys(tree) -> List[Tuple[str, Any]]:
    flat = []
    for parts, leaf in leaves_with_paths(tree):
        if any("/" in p for p in parts):
            raise ValueError(
                f"cache key component contains '/': {list(parts)}; rename "
                "the key or restore with load_cache(path, template=...)")
        flat.append(("/".join(parts), leaf))
    return flat


def snapshot_cache(cache: Any, path: str, codec: str = "zlib",
                   level: int = 6) -> Dict[str, int]:
    """Persist a decode-cache tree (tensors or ndarrays) losslessly
    (entropy-coded anchors), in the reference's file layout."""
    params = NumarckParams(codec=codec, zlib_level=level)
    w = NCKWriter()
    names = {}
    orig = comp = 0
    for i, (key, leaf) in enumerate(sorted(_tree_keys(cache),
                                           key=lambda kv: kv[0])):
        var = f"c{i:04d}"
        names[var] = key
        arr, dtype_name = host_storage(leaf)
        st = make_anchor(arr, params, dtype_name)
        orig += st.n * step_dtype(st.dtype).itemsize
        comp += st.nbytes
        w.add_step(var, st)
    w.add_array("__names__",
                np.frombuffer(json.dumps(names).encode(), np.uint8))
    w.write(path)
    return {"orig_bytes": orig, "comp_bytes": comp}


def load_cache(path: str, template: Any = None, device=None) -> Any:
    """Inverse of snapshot_cache: every leaf decoded onto `device` (CUDA
    unless the caller asks for another) through ``decode_anchor_device``,
    bfloat16 included.  Without `template`, nested dicts of tensors by
    key; with one, the template's structure, and each leaf must match
    its template leaf's shape, dtype and (unless "meta") device exactly,
    else ValueError: nothing is reshaped or cast."""
    dev = resolve_device(device)
    r = NCKReader(path)
    names = json.loads(bytes(r.read_array("__names__")).decode())
    flat = {key: decode_anchor_device(r.read_step(var), dev)
            for var, key in names.items()}
    if template is None:
        return nest(flat)
    want = dict(_tree_keys(template))
    if set(want) != set(flat):
        raise ValueError(
            f"{path}: leaves {sorted(flat)} do not match the template's "
            f"{sorted(want)}")

    def place(key: str, spec) -> torch.Tensor:
        t = flat[key]
        spec_dev = getattr(spec, "device", None)
        if (tuple(t.shape) != tuple(spec.shape) or t.dtype != spec.dtype
                or (spec_dev is not None and spec_dev.type != "meta"
                    and t.device != spec_dev)):
            raise ValueError(
                f"{path}: leaf {key!r} is {tuple(t.shape)} {t.dtype} on "
                f"{t.device}; the template wants {tuple(spec.shape)} "
                f"{spec.dtype} on {spec_dev}")
        return t

    return map_with_keys(place, template)


@dataclass
class ServeStats:
    prefill_s: float = 0.0
    decode_s: float = 0.0
    tokens_out: int = 0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_out / self.decode_s if self.decode_s else 0.0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sample(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """A categorical draw per row of `logits` (B, V) by the Gumbel-max
    trick, as ``jax.random.categorical`` draws (other random bits)."""
    u = torch.rand(logits.shape, generator=generator, dtype=torch.float32,
                   device=logits.device)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


class Engine:
    def __init__(self, model: Model, params, batch_size: int, s_max: int,
                 keep_session: bool = False, device=None):
        """`params` is the model's ``LM`` module, already on `device`
        (CUDA unless the caller asks for another; it is never moved).
        `keep_session=True` retains each generate()'s final decode state
        (cache + next token + position) on the engine for
        save_session/resume (costs one cache of device memory between
        requests; off by default)."""
        dev = resolve_device(device)
        where = {p.device for p in params.parameters()}
        if len(where) != 1 or next(iter(where)).type != dev.type:
            raise ValueError(f"the parameters live on {sorted(map(str, where))}"
                             f"; the engine runs on {dev}")
        self.device = next(iter(where))
        self.model = model
        self.params = params
        self.B = batch_size
        self.s_max = s_max
        self.keep_session = keep_session
        self.stats = ServeStats()
        # Device-resident session handle (cache + next token + position);
        # host copies happen only through its .to_host() in save_session.
        self._session: Optional[SessionChain] = None
        # LeafSpec tree of the session, recorded on the first decode loop:
        # load_session restores exactly these shapes, dtypes and device.
        self._sess_template = None

    # Views of the session handle.
    @property
    def last_cache(self):
        """Decode cache of the last retained generate (device-resident)."""
        return self._session["cache"] if self._session is not None else None

    @property
    def last_tok(self):
        """Next (not yet emitted) token of the retained session."""
        return self._session["tok"] if self._session is not None else None

    @property
    def last_pos(self):
        """Absolute position of last_tok."""
        return self._session["pos"] if self._session is not None else None

    def save_session(self, path: str, codec: str = "zlib") -> Dict[str, int]:
        """Snapshot the last request batch's decode state to disk (cache +
        resume token/position, so the session restarts mid-stream).

        This is the durable-write boundary: the one place the
        device-resident session handle crosses to host (`.to_host()`)."""
        if self._session is None:
            raise RuntimeError(
                "no session cache retained: construct the Engine with "
                "keep_session=True and call generate() first")
        with telemetry.span("serve.save_session", path=path, codec=codec):
            return snapshot_cache(self._session.to_host(), path,
                                  codec=codec)

    def load_session(self, path: str):
        """Reload a snapshotted decode state onto the engine's device.

        Leaves decode straight onto the device (``load_cache(...,
        device=)``: with rANS blobs the decode kernel inflates them
        there, no host reconstruction + re-upload round trip) and must
        match the recorded session template's shapes, dtypes and device
        exactly; a mismatch raises ValueError.  Requires one prior
        `generate()` on this engine (any keep_session setting) to have
        recorded the template.
        """
        names = json.loads(bytes(
            NCKReader(path).read_array("__names__")).decode())
        if not any(k == "pos" or k.split("/", 1)[0] == "cache"
                   for k in names.values()):
            raise ValueError(
                f"{path}: not an Engine session file (no cache/tok/pos "
                "record -- bare snapshot_cache() files predate the resume "
                "format; re-save with Engine.save_session)")
        if self._sess_template is None:
            raise RuntimeError(
                "load_session needs the session template: call generate() "
                "once on this engine first (any keep_session setting)")
        with telemetry.span("serve.load_session", path=path):
            try:
                sess = load_cache(path, template=self._sess_template,
                                  device=self.device)
            except IntegrityError as e:
                # A flipped bit in a cold session must never resurrect as
                # wrong KV state; surface it with session context so the
                # caller can evict/refetch the snapshot.
                raise IntegrityError(
                    f"session snapshot {path} failed integrity "
                    f"verification and was not restored: {e}") from e
            self._session = SessionChain(sess)
        return self.last_cache

    def _decode_loop(self, cache, tok, pos, max_new: int, greedy: bool,
                     generator, keep: bool) -> np.ndarray:
        """Shared streaming loop of generate/resume.  Tokens collect on
        the device and cross to the host once, at the end."""
        out = torch.empty((self.B, max_new), dtype=torch.int32,
                          device=self.device)
        t0 = time.perf_counter()
        with telemetry.span("serve.decode_loop",
                            max_new=max_new, batch=self.B):
            for i in range(max_new):
                out[:, i] = tok[:, 0]
                logits, cache = self.model.decode(self.params, cache, tok,
                                                  pos)
                if greedy or generator is None:
                    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
                else:
                    tok = sample(logits[:, -1], generator)[:, None]
                tok = tok.to(torch.int32)
                pos = pos + 1
            _sync(self.device)
        self.stats.decode_s += time.perf_counter() - t0
        self.stats.tokens_out += max_new * self.B
        sess = {"cache": cache, "tok": tok, "pos": pos}
        if self._sess_template is None:
            self._sess_template = map_with_keys(
                lambda _, x: LeafSpec(tuple(x.shape), x.dtype, x.device),
                sess)
        if keep:
            self._session = SessionChain(sess)
        return out.cpu().numpy()

    def generate(self, prompts: np.ndarray, max_new: int = 16,
                 greedy: bool = True,
                 generator: Optional[torch.Generator] = None) -> np.ndarray:
        """prompts (B, S0) int -> (B, max_new) int32 generated tokens.
        Sampling (greedy=False) draws from `generator`, a torch.Generator
        on the engine's device."""
        prompts = np.asarray(prompts)
        if prompts.shape[0] != self.B:
            raise ValueError(f"{prompts.shape[0]} prompts for a batch of "
                             f"{self.B}")
        t0 = time.perf_counter()
        with telemetry.span("serve.prefill",
                            batch=self.B, s0=int(prompts.shape[1])):
            tokens = torch.from_numpy(prompts.astype(np.int64)).to(
                self.device)
            logits, cache, pos = self.model.prefill(
                self.params, {"tokens": tokens}, s_max=self.s_max)
            _sync(self.device)
        self.stats.prefill_s += time.perf_counter() - t0
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        return self._decode_loop(cache, tok, pos, max_new, greedy, generator,
                                 keep=self.keep_session)

    def resume(self, max_new: int = 16, greedy: bool = True,
               generator: Optional[torch.Generator] = None) -> np.ndarray:
        """Continue a retained or load_session()-restored stream: no
        prefill.  Always advances the session state, so consecutive
        resume() calls stream onward (keep_session only governs whether
        generate() retains its cache between requests)."""
        if self._session is None:
            raise RuntimeError(
                "no session to resume: generate() with keep_session=True "
                "or load_session() first")
        return self._decode_loop(self._session["cache"],
                                 self._session["tok"],
                                 self._session["pos"], max_new, greedy,
                                 generator, keep=True)


__all__ = ["Engine", "ServeStats", "LeafSpec", "snapshot_cache",
           "load_cache", "sample"]
