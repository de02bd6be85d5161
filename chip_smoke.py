#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py        # from the root of a checkout

Phases, each fatal on failure (exit code 1, no result line):

  1. build    nvcc builds the four kernels from src/repro_torch/csrc.
  2. main     compress_series on the card: CMIP (f32, 42x360x240, six
              steps) and Sedov (f64, 165x32x32, four steps) at the
              default NumarckParams(error_bound=1e-3), chain "device".
              Every kernel's launch count is set to 0 just before each
              series and read just after; each kernel must have launched
              once per delta step of that series.  The steps must equal
              the same call with device="cpu" (the plain versions) byte for
              byte, and decompress to within E at every step.
              Then one warm CMIP step, stage by stage (host clock).
  3. kernels  each kernel against its plain version on the card, exactly,
              at n = 42*360*240 (the CMIP step) and n = 2^26, with timings
              (median of 20 launches, CUDA events, after warm-up) beside
              the bound the card's memory and arithmetic rates set.  The
              histogram runs on the id sets of `hist_id_sets` (the CMIP
              step's ids with the main path's id bound, the 2^26 pair, a
              wide-domain 2^26 pair, one-bin and uniform ids) and logs its
              launch shape for each.

It prints the card's name and power limit, one JSON line of per-kernel
numbers, and last {"ok": true, "device": {...}}.  It needs the repo's
src/ beside it and a CUDA device, and exits non-zero without either.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12             # H100 SXM, float32 outside tensor cores
FP64_OPS_PER_S = 34e12             # H100 SXM, float64 outside tensor cores
ITERS = 20
E = 1e-3
N_BIG = 1 << 26                    # one card's share of a large variable
MAIN_RUNS = {"cmip": 6, "sedov": 4}  # series -> steps on the main path
SCALE = 1                          # generate_series scale (1 = paper size)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, iters: int = ITERS, warmup: int = 3) -> float:
    """Median device time of one call of ``fn`` (CUDA events per call).

    A ~1 ms spin kernel goes ahead of each timed call, so the host has
    queued the events and the call before the device reaches them: the
    interval is device time, not the host's launch overhead (which is
    larger than a kernel's run at the CMIP size).
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound_ms(nbytes: float, ops: float, ops_rate: float):
    """Least time for the work: the larger of bytes over the memory rate
    and operations over the arithmetic rate, in ms, and which one binds."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(torch, a, b) -> float:
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"kernel gave {a.dtype}{tuple(a.shape)}, plain "
                             f"version {b.dtype}{tuple(b.shape)}")
    if a.dtype == torch.uint32:
        a, b = a.to(torch.int64), b.to(torch.int64)
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def big_pair(np, n: int, seed: int = 0):
    """A synthetic temporal pair of n f32 values: ratios ~ N(0, 1e-3) and
    1 % jumps ~ N(0, 1), about 4,000 live bins at E = 1e-3."""
    rng = np.random.default_rng(seed)
    prev = rng.normal(2.0, 0.7, n).astype(np.float32)
    curr = prev * (1 + 1e-3 * rng.standard_normal(n)).astype(np.float32)
    jumps = rng.random(n) < 0.01
    curr[jumps] *= (1 + rng.standard_normal(jumps.sum())).astype(np.float32)
    return prev, curr


def wide_pair(np, prev, curr, seed: int = 1):
    """The same pair with 0.1 % of prev scaled by 1e-5: those ratios reach
    ~1e5, the range exceeds 2E * max_bins, and the domain is centred on
    zero (id bound = max_bins)."""
    rng = np.random.default_rng(seed)
    prev = prev.copy()
    hit = rng.random(prev.size) < 1e-3
    prev[hit] *= np.float32(1e-5)
    return prev, curr


def hist_id_sets(torch, np, dev, pairs: dict, error_bound: float,
                 max_bins: int) -> dict:
    """label -> (bin ids on the card, id bound) for the histogram phase.

    For each (prev, curr) pair, the ids come from the change-ratio kernel
    and the bound from core.ratios.histogram_domain, as on the main path.  Two
    synthetic sets of the size of the last pair follow: every id in one
    bin (bound: that bin + 1) and uniform ids over all max_bins bins (no
    bound)."""
    from repro_torch.core import ratios
    from repro_torch.kernels import change_ratio

    sets = {}
    for label, (p_np, c_np) in pairs.items():
        p = torch.from_numpy(p_np).to(dev)
        c = torch.from_numpy(c_np).to(dev)
        r, valid = ratios.change_ratios(p, c)
        lo, hi = ratios.ratio_range(r, valid)
        del r, valid
        d_lo, width, bound = ratios.histogram_domain(lo, hi, error_bound,
                                                     max_bins)
        _, ids = change_ratio.change_ratio_bins_cuda(p, c, d_lo, width,
                                                     max_bins=max_bins)
        sets[label] = (ids, bound)
        del p, c
    n = ids.numel()
    gen = torch.Generator(device=dev).manual_seed(n)
    sets["one-bin"] = (torch.full((n,), 2047, dtype=torch.int32, device=dev),
                       2048)
    sets["uniform"] = (torch.randint(0, max_bins, (n,), generator=gen,
                                     device=dev, dtype=torch.int32), None)
    return sets


def run(torch, np) -> dict:
    from repro_torch import compress_series, decompress_series, interop
    from repro_torch.core import chain as chainmod
    from repro_torch.core import compress, packing, pipeline, ratios
    from repro_torch.core.types import NumarckParams, mean_error_rate
    from repro_torch.data.temporal import generate_series
    from repro_torch.kernels import _build, bitpack, change_ratio, dequant
    from repro_torch.kernels import hist, ops

    dev = torch.device("cuda")

    # -- 1. build ----------------------------------------------------------
    log(f"build: {_build.build():.1f} s for {len(_build.SOURCES)} sources "
        f"({' '.join(_build.NVCC_FLAGS)})")
    for k in ops.KERNELS:
        _build.library(k.name)

    # -- 2. the main path on the card --------------------------------------
    params = NumarckParams(error_bound=E)
    data = {name: list(generate_series(name, steps, seed=0, scale=SCALE))
            for name, steps in MAIN_RUNS.items()}
    results, wall, launches = {}, {}, {}
    for name, arrays in data.items():
        # Each series is its own run of the path: counts are set to 0 just
        # before it and read just after.  Every delta step launches each
        # kernel once; the anchor launches none.
        torch.cuda.synchronize()
        for k in ops.KERNELS:
            k.launches = 0
        t0 = time.perf_counter()
        results[name] = compress_series(arrays, params, chain="device",
                                        device="cuda")
        wall[name] = time.perf_counter() - t0
        launches[name] = {k.name: k.launches for k in ops.KERNELS}
        log(f"main path {name} launches: {json.dumps(launches[name])}")
        wrong = {kn: c for kn, c in launches[name].items()
                 if c != len(arrays) - 1}
        if wrong:
            raise AssertionError(f"{name}: kernels launched {wrong} times, "
                                 f"expected {len(arrays) - 1} each")
    main_b = {}
    for name, arrays in data.items():
        steps = results[name]
        want = compress_series(arrays, params, chain="device", device="cpu")
        for i, (g, w) in enumerate(zip(steps, want)):
            fg, fw = interop.step_to_fields(g), interop.step_to_fields(w)
            for key in fg:
                same = (np.array_equal(fg[key], fw[key])
                        if isinstance(fw[key], np.ndarray)
                        else fg[key] == fw[key])
                if not same:
                    raise AssertionError(f"{name} step {i}: field {key!r} "
                                         "differs between cuda and cpu")
        recon = decompress_series(steps)
        errs = [mean_error_rate(a, r) for a, r in zip(arrays, recon)]
        if max(errs) > E * 1.01 or not all(
                np.isfinite(r).all() and r.shape == a.shape
                for a, r in zip(arrays, recon)):
            raise AssertionError(f"{name}: mean error rates {errs} > E")
        main_b[name] = [s.b_bits for s in steps[1:]]
        nbytes = sum(s.nbytes for s in steps)
        raw = sum(a.nbytes for a in arrays)
        log(f"main path {name}: {len(steps)} steps of "
            f"{arrays[0].shape} {arrays[0].dtype}, "
            f"{wall[name] / len(steps) * 1e3:.1f} ms/step wall "
            f"(first call, incl. upload and host finalize), B={main_b[name]}, "
            f"CR={raw / nbytes:.2f}, max mean error {max(errs):.3e}, "
            "byte-identical to device=cpu")

    # Where the time of one warm CMIP delta step goes: the compressor's
    # stages one by one, host clock, each ended by a synchronize.
    ref_chain = chainmod.DeviceReferenceChain(dev)
    ref_chain.seed(data["cmip"][0])
    step_in = data["cmip"][1]
    stages = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t0) * 1e3
        return out

    curr_dev = stage("upload", lambda: torch.tensor(step_in, device=dev))
    enc = stage("encode", lambda: compress.encode_device(
        ref_chain.peek(), curr_dev, params, need_host_idx=False))
    stage("chain_advance", lambda: ref_chain.advance(enc, step_in))
    stage("finalize", lambda: pipeline.finalize_step(
        step_in, enc.enc, enc.centers, enc.domain_lo, enc.width, params,
        enc.meta))
    log("one warm CMIP step, ms: " + ", ".join(
        f"{k} {v:.2f}" for k, v in stages.items())
        + " (encode = range pass, kernels 1-3, sort, auto-B, copies to host)")

    # -- 3. each kernel against its plain version, timed -------------------
    prev_big, curr_big = big_pair(np, N_BIG)
    pairs = {"cmip": (data["cmip"][0].reshape(-1), data["cmip"][1].reshape(-1)),
             "2^26": (prev_big, curr_big)}
    n_main = data["cmip"][0].size
    b_main = main_b["cmip"][0]
    # ``launches`` is the CMIP run's count (the f32 path whose shapes are
    # timed below); ``launches_by_path`` gives each run's own count.
    table = {k.name: dict(name=k.name, route=k.route, source=k.source,
                          replaces=k.replaces,
                          launches=launches["cmip"][k.name],
                          launches_by_path={p: c[k.name]
                                            for p, c in launches.items()},
                          max_abs_err=0.0)
             for k in ops.KERNELS}

    def check(kname, got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        err = max(max_abs_err(torch, g, w) for g, w in zip(got, want))
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        table[kname]["max_abs_err"] = max(table[kname]["max_abs_err"], err)
        if not same:
            raise AssertionError(f"{kname}: kernel differs from its plain "
                                 f"version (max abs err {err})")

    def record(kname, ms, plain_ms, nbytes, ops_count, rate, lib_ms=None):
        b, by = bound_ms(nbytes, ops_count, rate)
        table[kname].update(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                            library_ms=lib_ms)

    for label, (p_np, c_np) in pairs.items():
        n = p_np.size
        main = n == n_main
        for dtype in (torch.float32, torch.float64):
            p = torch.from_numpy(p_np).to(dev, dtype)
            c = torch.from_numpy(c_np).to(dev, dtype)
            r, valid = ratios.change_ratios(p, c)
            lo, hi = ratios.ratio_range(r, valid)
            del r, valid
            d_lo, width, _ = ratios.histogram_domain(lo, hi, E,
                                                     params.max_bins)
            args = (p, c, d_lo, width)
            kw = dict(max_bins=params.max_bins)
            got = change_ratio.change_ratio_bins_cuda(*args, **kw)
            check("change_ratio", got,
                  change_ratio.change_ratio_bins_plain(*args, **kw))
            ms = time_ms(torch, lambda: change_ratio.change_ratio_bins_cuda(
                *args, **kw))
            esz = p.element_size()
            log(f"change_ratio {label} n={n} {dtype}: {ms:.4f} ms, bound "
                f"{bound_ms(n * (2 * esz + 8), 5 * n, FP32_OPS_PER_S)[0]:.4f}"
                " ms, exact")
            if main and dtype == torch.float32:
                plain_ms = time_ms(
                    torch, lambda: change_ratio.change_ratio_bins_plain(
                        *args, **kw))
                record("change_ratio", ms, plain_ms, n * (2 * esz + 8), 5 * n,
                       FP32_OPS_PER_S)
            del got, p, c

        gen = torch.Generator(device=dev).manual_seed(n)
        line = []
        for b in range(1, 25):
            be = params.block_elems(b)
            n_pad = -(-n // be) * be if main else n
            idx = torch.randint(0, 1 << b, (n_pad,), generator=gen,
                                device=dev, dtype=torch.int32)
            got = bitpack.pack_bits_cuda(idx, b_bits=b)
            check("bitpack", got, bitpack.pack_bits_plain(idx, b_bits=b))
            if main and b in (b_main, 8, 24):
                host = got.cpu().numpy().astype("<u4").tobytes()
                if host != packing.pack_indices_np(idx.cpu().numpy(),
                                                   b).tobytes():
                    raise AssertionError(f"bitpack B={b}: bytes differ from "
                                         "pack_indices_np")
            ms = time_ms(torch, lambda: bitpack.pack_bits_cuda(idx, b_bits=b))
            line.append(f"B{b}={ms:.4f}")
            nbytes = 4 * n_pad + 4 * n_pad * b // 32
            if main and b == b_main:
                plain_ms = time_ms(torch, lambda: bitpack.pack_bits_plain(
                    idx, b_bits=b))
                record("bitpack", ms, plain_ms, nbytes, 3 * n_pad,
                       FP32_OPS_PER_S)
            del idx, got
        log(f"bitpack {label} n={n}{' (block-padded)' if main else ''} ms: "
            + " ".join(line) + ", all exact")

        for dtype in (torch.float32, torch.float64):
            rate = FP32_OPS_PER_S if dtype == torch.float32 else FP64_OPS_PER_S
            line = []
            for b in sorted({4, 8, 13, 16, b_main}):
                k = min((1 << b) - 1, params.max_bins)
                idx = torch.randint(0, 1 << b, (n,), generator=gen,
                                    device=dev, dtype=torch.int32)
                prev = torch.from_numpy(p_np).to(dev, dtype)
                curr = torch.from_numpy(c_np).to(dev, dtype)
                cen = ((torch.rand(k, generator=gen, device=dev,
                                   dtype=torch.float64) - 0.5) * 0.2
                       ).to(dtype)
                check("dequant", dequant.dequantize_cuda(idx, prev, cen,
                                                         b_bits=b),
                      dequant.dequantize_plain(idx, prev, cen, b_bits=b))
                args = (idx, prev, curr, cen)
                check("dequant",
                      dequant.chain_advance_cuda(*args, b_bits=b),
                      dequant.chain_advance_plain(*args, b_bits=b))
                ms = time_ms(torch, lambda: dequant.chain_advance_cuda(
                    *args, b_bits=b))
                line.append(f"B{b}={ms:.4f}")
                # curr is read on marker lanes only: count what this
                # run's data needs.
                esz = prev.element_size()
                n_marker = int((idx == (1 << b) - 1).sum())
                nbytes = n * (4 + 2 * esz) + (n_marker + k) * esz
                if main and b == b_main and dtype == torch.float32:
                    plain_ms = time_ms(
                        torch, lambda: dequant.chain_advance_plain(
                            *args, b_bits=b))
                    record("dequant", ms, plain_ms, nbytes, 2 * n, rate)
                del idx, prev, curr, cen, args
            log(f"dequant (chain advance) {label} n={n} {dtype} ms: "
                + " ".join(line) + ", dequantize and chain advance exact")

    # The histogram on each id set: exact against its plain version, with
    # the launch shape the id bound gives.
    m = params.max_bins
    pairs["wide 2^26"] = wide_pair(np, prev_big, curr_big)
    sets = hist_id_sets(torch, np, dev, pairs, E, m)
    del prev_big, curr_big, pairs
    for label, (ids, bound) in sets.items():
        n = ids.numel()
        plan = hist.launch_plan(ids, max_bins=m, id_bound=bound)
        check("hist", hist.histogram_cuda(ids, max_bins=m, id_bound=bound),
              hist.histogram_plain(ids, max_bins=m))
        ms = time_ms(torch, lambda: hist.histogram_cuda(ids, max_bins=m,
                                                        id_bound=bound))
        valid_ids = ids[ids >= 0]
        lib_ms = time_ms(torch, lambda: torch.bincount(valid_ids,
                                                       minlength=m))
        b = bound_ms(4 * n + 4 * m, n, FP32_OPS_PER_S)[0]
        log(f"hist {label} n={n} max_bins={m} id_bound={bound}: {ms:.4f} ms "
            f"({b / ms:.0%} of the bound {b:.4f} ms), torch.bincount over "
            f"the {valid_ids.numel()} valid ids {lib_ms:.4f} ms, exact; "
            f"launch {json.dumps(plan)}")
        if label == "cmip":
            plain_ms = time_ms(torch, lambda: hist.histogram_plain(
                ids, max_bins=m))
            record("hist", ms, plain_ms, 4 * n + 4 * m, n, FP32_OPS_PER_S,
                   lib_ms)
            table["hist"]["id_bound"] = bound
            table["hist"]["launch"] = plan
        del ids, valid_ids
    return table


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run from a "
              "checkout of the repo", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
            f"{torch.cuda.get_device_name(0)}")
        table = run(torch, np)
    except Exception:
        traceback.print_exc()
        return 1
    print(json.dumps({"kernels": list(table.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
