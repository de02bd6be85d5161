#!/usr/bin/env python3
"""Time the rANS encode and decode kernels against earlier versions of
their source on one CUDA card.

    python3 scripts/rans_bench.py [--source NAME=PATH ...] [--profile]
                                  [--out build/rans_bench.json]

It builds src/repro_torch/csrc/rans.cu ("current") and every ``--source``
(another rans.cu beside its common.cuh: the parent commit's from a ``git
archive`` into .tmp-oldsrc/, or an earlier revision) with the flags of
kernels/_build.py, every nvcc at once.  A library without ``rans_divide``
is taken to be the parent's, whose encode runs one CTA per block and
takes no lanes-per-CTA argument.  The current encode also runs at 64, 128
and 256 lanes per CTA beside the planner's choice
(``encode_lanes_per_cta``).

The shapes: the CMIP step's blocks (v1: packed bytes with a table per
block; v2: the indices with one table), the same at the 2^26-element pair
of chip_smoke.py, and two synthetic 1 MB-class v1 blocks at each lane
count of the format (L = 32, 128, 512, 1,024).  Every build is held to
the plain versions exactly on every shape, then timed as chip_smoke.py
times a kernel (CUDA events behind a spin kernel, the outputs' allocation
included as in each wrapper), in turns: the builds in order, then in
reverse.  Times are printed in ms and in ns a step (ms / m, the measure a
latency-bound chain of m steps is bound by).  ``--profile`` adds each
build's device time per call of each kernel it runs, from torch.profiler.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LANES_PER_CTA = (64, 128, 256)
# v1 bytes per block that make the format use L lanes (lanes_for).
SYNTH_BYTES = {32: 4096, 128: 16384, 512: 131072, 1024: 1 << 20}


def build_all(build_dir: Path, sources: dict) -> dict:
    """name -> rans.cu path  ->  name -> loaded library."""
    from repro_torch.kernels import _build

    build_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, src in sources.items():
        so = build_dir / f"librans_{name}.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT))
    libs = {}
    for name, (so, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n"
                               + out.decode(errors="replace"))
        libs[name] = ctypes.CDLL(str(so))
    return libs


def encoders(torch, libs: dict) -> dict:
    """label -> fn(syms, fc, L) returning (states, vals, masks)."""
    from repro_torch.kernels import rans

    out = {}
    stream = torch.cuda.current_stream().cuda_stream
    for name, lib in libs.items():
        with_lc = hasattr(lib, "rans_divide")
        fns = {}
        for sym in ("rans_encode_u8", "rans_encode_i32"):
            fn = getattr(lib, sym)
            fn.argtypes = [_P, _LL, _I, _P, _I, _I, _I] + (
                [_I] if with_lc else []) + [_P, _P, _P, _P]
            fn.restype = ctypes.c_int
            fns[sym] = fn

        def call(syms, fc, L, lc=None, fns=fns, name=name, with_lc=with_lc):
            nb, n = syms.shape
            m = -(-n // L)
            dev = syms.device
            states = torch.empty((nb, L), dtype=torch.int32, device=dev)
            vals = torch.empty((nb, m * L), dtype=torch.int16, device=dev)
            masks = torch.empty((nb, m * L), dtype=torch.bool, device=dev)
            A = fc.shape[1]
            extra = ((lc or rans.encode_lanes_per_cta(nb, L),)
                     if with_lc else ())
            fn = fns["rans_encode_u8" if syms.dtype == torch.uint8
                     else "rans_encode_i32"]
            rc = fn(syms.data_ptr(), n, nb, fc.data_ptr(), A,
                    A if fc.shape[0] == nb else 0, L, *extra,
                    states.data_ptr(), vals.data_ptr(), masks.data_ptr(),
                    stream)
            if rc:
                raise RuntimeError(f"{name}: rans_encode: CUDA error {rc}")
            return states, vals, masks

        out[name] = call
        if with_lc and name == "current":
            for lc in LANES_PER_CTA:
                out[f"current Lc={lc}"] = (
                    lambda s, f, L, lc=lc, call=call: call(s, f, L, lc))
    return out


def decoders(torch, libs: dict) -> dict:
    """label -> fn(mode, dec, sym, states, stream, n_emit, m, L, n, n_sym,
    b_bits) returning (out, final states, final pointers)."""
    out = {}
    stream = torch.cuda.current_stream().cuda_stream
    for name, lib in libs.items():
        fn = lib.rans_decode
        fn.argtypes = [_P, _P, _P, _P, _LL, _P, _I, _I, _I, _P, _LL, _I, _I,
                       _I, _P, _P, _P]
        fn.restype = ctypes.c_int

        def call(mode, dec, sym, states, words, n_emit, m, L, n, n_sym,
                 b_bits, fn=fn, name=name):
            nb = dec.shape[0]
            dev = dec.device
            res = (torch.empty((nb, m * L), dtype=torch.uint8, device=dev)
                   if mode == 0 else
                   torch.empty((nb, n), dtype=torch.int32, device=dev))
            xf = torch.empty((nb, L), dtype=torch.int32, device=dev)
            ptrf = torch.empty(nb, dtype=torch.int64, device=dev)
            rc = fn(dec.data_ptr(), None if sym is None else sym.data_ptr(),
                    states.data_ptr(), words.data_ptr(), words.shape[1],
                    n_emit.data_ptr(), nb, m, L, res.data_ptr(),
                    m * L if mode == 0 else n, n_sym, (1 << b_bits) - 1,
                    mode, xf.data_ptr(), ptrf.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"{name}: rans_decode: CUDA error {rc}")
            return res, xf, ptrf

        out[name] = call
    return out


def synthetic_v1(np, torch, dev, L: int, nb: int = 2, seed: int = 0):
    """nb v1 blocks of B = 4 indices packed into SYNTH_BYTES[L] bytes,
    geometric ranks as in a step's index table."""
    from repro_torch.core import packing
    from repro_torch.kernels import rans

    n = SYNTH_BYTES[L]
    be = n * 2
    rng = np.random.default_rng(seed + L)
    idx = np.minimum(rng.geometric(0.35, (nb, be)) - 1, 15).astype(np.int32)
    byts = np.stack([packing.pack_indices_np(r, 4) for r in idx])
    _, fcs = rans.tables_from_samples(byts[:, ::rans.sample_stride(n)])
    blobs = [rans.compress(r.tobytes()) for r in byts]
    return dict(syms=torch.from_numpy(byts).to(dev),
                fc=torch.from_numpy(fcs.view(np.int32)).to(dev), blobs=blobs,
                ver="v1", b=4, be=be)


def shapes(np, torch, dev) -> dict:
    """label -> encode input and blobs of the same blocks."""
    import chip_smoke as cs
    from repro_torch.core.types import NumarckParams
    from repro_torch.data.temporal import generate_series

    params = NumarckParams(error_bound=cs.E, codec="rans")
    cmip = [a.reshape(-1) for a in generate_series("cmip", 2, seed=0)]
    out = {}
    for label, (p_np, c_np) in (("cmip", tuple(cmip)),
                                ("2^26", cs.big_pair(np, cs.N_BIG))):
        x = cs.rans_inputs(torch, np, dev, p_np, c_np, params)
        out[f"{label} v1"] = dict(syms=x["byts"], fc=x["fc1"], blobs=x["v1"],
                                  ver="v1", b=x["b"], be=x["be"])
        out[f"{label} v2"] = dict(syms=x["idx2d"], fc=x["fc2"],
                                  blobs=x["v2"], ver="v2", b=x["b"],
                                  be=x["be"], n_sym=x["k_eff"] + 1)
    for L in SYNTH_BYTES:
        out[f"L={L} v1"] = synthetic_v1(np, torch, dev, L)
    return out


def decode_args(np, torch, dev, s: dict):
    """(mode, dec, sym, states, stream, n_emit, m, L, n, n_sym, b_bits) of
    the coded (non-v0) blocks of shape ``s``, and their n_emit on the
    host; None when every block fell back to v0."""
    from repro_torch.kernels import rans

    coded = [o for o in s["blobs"] if rans.blob_version(o) != 0]
    if not coded:
        return None
    v1 = s["ver"] == "v1"
    parse, skip = (rans._parse_v1, 2) if v1 else (rans._parse_v2, 3)
    parsed = [dict(zip(("freq", "states", "stream"), parse(o)[skip:]))
              for o in coded]
    dec, sym, st, words, ne, ne_np = rans._upload_group(parsed, dev)
    L = parsed[0]["states"].size
    n = s["be"] * s["b"] // 8 if v1 else s["be"]
    return ((0 if v1 else 1, dec, sym, st, words, ne, -(-n // L), L,
             s["be"], s.get("n_sym", 0), s["b"]), ne_np)


def plain_decode(args):
    from repro_torch.kernels import rans

    mode, dec, sym, st, words, ne, m, L, n, n_sym, b = args
    if mode == 0:
        return rans.decode_bytes_plain(dec, st, words, ne, m=m, L=L)
    return rans.decode_syms_plain(dec, sym, st, words, ne, m=m, L=L, n=n,
                                  n_sym=n_sym, b_bits=b)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH", help="another rans.cu to time")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "rans_bench.json")
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from hist_bench import profile_us
    from repro_torch.kernels import rans

    if not torch.cuda.is_available():
        print("rans_bench: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)

    others = dict(s.split("=", 1) for s in args.source)
    sources = {"current": ROOT / "src" / "repro_torch" / "csrc" / "rans.cu"}
    sources.update({k: Path(v).resolve() for k, v in others.items()})
    libs = build_all(ROOT / "build" / "rans_bench", sources)
    enc, dec = encoders(torch, libs), decoders(torch, libs)

    rows = []
    for label, s in shapes(np, torch, dev).items():
        syms, fc = s["syms"], s["fc"]
        nb, n = syms.shape
        L = rans.lanes_for(n)
        m = -(-n // L)
        want = rans.encode_plain(syms, fc, L=L)
        # The lanes-per-CTA variants that divide this L.
        names = [k for k in enc if not k.startswith("current Lc=")
                 or L % int(k.split("=")[1]) == 0]
        for name in names:
            fn = enc[name]
            got = fn(syms, fc, L)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"encode {name} differs from "
                                     f"encode_plain on {label}")
        row = dict(shape=label, blocks=nb, lanes=L, steps=m, card=card,
                   lanes_per_cta=rans.encode_lanes_per_cta(nb, L))
        order = [*names, *reversed(names)]
        times = {}
        for name in order:
            times.setdefault(name, []).append(cs.time_ms(
                torch, lambda: enc[name](syms, fc, L)))
        row["encode_ms"] = times
        if args.profile:
            row["encode_profile_us"] = {
                name: profile_us(torch, lambda: enc[name](syms, fc, L))
                for name in names}
        d = decode_args(np, torch, dev, s)
        if d is not None:
            dargs, ne_np = d
            dwant = plain_decode(dargs)
            for name, fn in dec.items():
                got = fn(*dargs)
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(got, dwant)):
                    raise AssertionError(f"decode {name} differs from the "
                                         f"plain version on {label}")
                rans._checked(got[1], got[2], ne_np)
            dm = dargs[6]
            times = {}
            for name in [*dec, *reversed(dec)]:
                times.setdefault(name, []).append(cs.time_ms(
                    torch, lambda: dec[name](*dargs)))
            row.update(decode_ms=times, decode_blocks=dargs[1].shape[0],
                       decode_steps=dm, stream_words=int(ne_np.sum()))
            if args.profile:
                row["decode_profile_us"] = {
                    name: profile_us(torch, lambda: dec[name](*dargs))
                    for name in dec}
        rows.append(row)
        line = [f"{label}: {nb} blocks x {L} lanes, m = {m}, all exact"]
        for kind in ("encode", "decode"):
            if f"{kind}_ms" not in row:
                continue
            steps = m if kind == "encode" else row["decode_steps"]
            line.append(f"{kind} ms (ns/step): " + ", ".join(
                f"{k} " + "/".join(f"{t:.4f}" for t in v)
                + f" ({min(v) * 1e6 / steps:.0f})"
                for k, v in row[f"{kind}_ms"].items()))
            if args.profile:
                line.append(f"{kind} torch.profiler device us per call: "
                            + json.dumps(row[f"{kind}_profile_us"]))
        print("\n  ".join(line), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "shapes": rows}, indent=1))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
