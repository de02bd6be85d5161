#!/usr/bin/env python3
"""Time the bit-pack and unpack kernels against earlier versions of their
sources on one CUDA card.

    python3 scripts/pack_bench.py [--source NAME=DIR ...] [--profile]
                                  [--out build/pack_bench.json]

It builds src/repro_torch/csrc/bitpack.cu and rans.cu ("current") and the
same two files of every ``--source`` directory (a csrc/ directory holding
them beside their headers: the parent commit's from a ``git archive``
into .tmp-oldsrc/, or a variant under test) with the flags of
kernels/_build.py, every nvcc at once.  Both entry points
(``pack_bits_i32``, ``rans_unpack``) keep one signature across versions.

The shapes are chip_smoke.py's: at every B = 1..24, random B-bit indices
of the CMIP step padded to whole blocks (n = 3,628,800 before padding)
and of n = 2^26, and the whole blocks of their packed words for the
unpack.  Every build is held exactly to ``pack_bits_plain`` and
``unpack_plain`` (and the unpack to the indices it came from) on every
shape, then timed as chip_smoke.py times a kernel (CUDA events behind a
spin kernel, the output's allocation included as in each wrapper), in
turns: the builds in order, then in reverse.  Each time is printed with
its share of the bytes bound (each input byte read once, each output
byte written once, over 3.35 TB/s).  ``--profile`` adds each build's
device time per call from torch.profiler at the CMIP step's B and at
B = 24.
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
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT / "src"))

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNELS = ("bitpack", "rans")        # the two sources of each build


def build_all(build_dir: Path, dirs: dict) -> dict:
    """name -> csrc directory  ->  name -> {source: loaded library}."""
    from repro_torch.kernels import _build

    build_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, d in dirs.items():
        for src in KERNELS:
            so = build_dir / f"lib{src}_{name}.so"
            cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                   str(d / f"{src}.cu")]
            jobs[(name, src)] = (so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs: dict = {}
    for (name, src), (so, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name} {src}.cu:\n"
                               + out.decode(errors="replace"))
        libs.setdefault(name, {})[src] = ctypes.CDLL(str(so))
    return libs


def entry_points(torch, libs: dict) -> dict:
    """name -> (pack(idx, b), unpack(byts, b, be)), each allocating its
    output as the wrappers do."""
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for name, lib in libs.items():
        pack_fn = lib["bitpack"].pack_bits_i32
        pack_fn.argtypes = [_P, _LL, _P, _I, _P]
        pack_fn.restype = ctypes.c_int
        unpack_fn = lib["rans"].rans_unpack
        unpack_fn.argtypes = [_P, _I, _LL, _I, _LL, _P, _P]
        unpack_fn.restype = ctypes.c_int

        def pack(idx, b, fn=pack_fn, name=name):
            words = torch.empty(idx.numel() // 32 * b, dtype=torch.uint32,
                                device=idx.device)
            rc = fn(idx.data_ptr(), idx.numel(), words.data_ptr(), b, stream)
            if rc:
                raise RuntimeError(f"{name}: pack_bits_i32: CUDA error {rc}")
            return words

        def unpack(byts, b, be, fn=unpack_fn, name=name):
            nb, row = byts.shape
            res = torch.empty((nb, be), dtype=torch.int32, device=byts.device)
            rc = fn(byts.data_ptr(), nb, row, b, be, res.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"{name}: rans_unpack: CUDA error {rc}")
            return res

        out[name] = (pack, unpack)
    return out


def bench(torch, dev, fns: dict, shapes, card: str, profile: bool) -> list:
    """Check every build on every shape (label, n, whether n is padded to
    whole blocks) and B, time them in turns; one row a (shape, B)."""
    import chip_smoke as cs
    from hist_bench import profile_us
    from repro_torch.core.types import NumarckParams
    from repro_torch.kernels import bitpack, rans

    names = list(fns)
    order = [*names, *reversed(names)]
    params = NumarckParams(error_bound=cs.E)
    rows = []
    for label, n, main in shapes:
        gen = torch.Generator(device=dev).manual_seed(n)
        for b in range(1, 25):
            idx, be = cs.pack_input(torch, dev, gen, n, b, params, main)
            n_pad = idx.numel()
            want = bitpack.pack_bits_plain(idx, b_bits=b)
            byts = cs.unpack_rows(torch, want, n_pad, be, b)
            nb = byts.shape[0]
            want_idx = rans.unpack_plain(byts, b_bits=b, be=be)
            if not torch.equal(want_idx.view(-1), idx[:nb * be]):
                raise AssertionError(f"{label} B={b}: unpack_plain is not "
                                     "the inverse of pack_bits_plain")
            for name, (pack, unpack) in fns.items():
                got_w, got_i = pack(idx, b), unpack(byts, b, be)
                torch.cuda.synchronize()
                if not torch.equal(got_w, want):
                    raise AssertionError(f"pack {name} differs from "
                                         f"pack_bits_plain, {label} B={b}")
                if not torch.equal(got_i, want_idx):
                    raise AssertionError(f"unpack {name} differs from "
                                         f"unpack_plain, {label} B={b}")
            row = dict(shape=label, b=b, n=n_pad, blocks=nb, be=be,
                       card=card)
            calls = {"pack": (lambda name: lambda: fns[name][0](idx, b),
                              cs.pack_bytes(n_pad, b)),
                     "unpack": (lambda name: lambda: fns[name][1](byts, b, be),
                                cs.unpack_bytes(nb, be, b))}
            line = [f"{label} B={b}: n={n_pad}, {nb} blocks x {be}, "
                    "all exact"]
            for kind, (call, nbytes) in calls.items():
                bound = nbytes / cs.HBM_BYTES_PER_S * 1e3
                times: dict = {}
                for name in order:
                    times.setdefault(name, []).append(
                        cs.time_ms(torch, call(name)))
                share = {k: bound / min(v) for k, v in times.items()}
                row.update({f"{kind}_ms": times, f"{kind}_bound_ms": bound,
                            f"{kind}_share": share})
                line.append(f"{kind} ms (share of the bound {bound:.4f}): "
                            + ", ".join(
                                f"{k} " + "/".join(f"{t:.4f}" for t in v)
                                + f" ({share[k]:.0%})"
                                for k, v in times.items()))
                if profile and (b == 24 or (main and b == 4)):
                    us = {name: profile_us(torch, call(name))
                          for name in names}
                    row[f"{kind}_profile_us"] = us
                    line.append(f"{kind} torch.profiler device us per call: "
                                + json.dumps(us))
            rows.append(row)
            print("\n  ".join(line), flush=True)
            del idx, want, byts, want_idx
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=DIR",
                    help="a csrc directory with another bitpack.cu and "
                    "rans.cu to time")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "pack_bench.json")
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.data.temporal import SPECS

    if not torch.cuda.is_available():
        print("pack_bench: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)

    dirs = {"current": ROOT / "src" / "repro_torch" / "csrc"}
    dirs.update({k: Path(v).resolve() for k, v in
                 (s.split("=", 1) for s in args.source)})
    fns = entry_points(torch, build_all(ROOT / "build" / "pack_bench", dirs))
    # The CMIP step's n (padded to whole blocks, as the main path packs
    # it) and chip_smoke.py's 2^26 elements.
    shapes = (("cmip", int(np.prod(SPECS["cmip"].shape)), True),
              ("2^26", cs.N_BIG, False))
    rows = bench(torch, torch.device("cuda"), fns, shapes, card,
                 args.profile)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
