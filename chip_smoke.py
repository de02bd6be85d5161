#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py        # from the root of a checkout

Phases, each fatal on failure (exit code 1, no result line):

  1. build    nvcc builds every kernel source in src/repro_torch/csrc.
  2. main     compress_series on the card: CMIP (f32, 42x360x240, six
              steps) and Sedov (f64, 165x32x32, four steps) at the
              default NumarckParams(error_bound=1e-3), chain "device".
              Every kernel's launch count is set to 0 just before each
              run of a path and read just after; each kernel of the path
              must have launched once per delta step, and no other.  The
              steps must equal the same call with device="cpu" (the plain
              versions) byte for byte, and decompress to within E.
  3. rans     the same with codec="rans" (the rANS encode kernel, v1
              blobs) and with symbol_rans=True (v2 blobs, no bit-pack):
              CMIP, and Sedov with DEVICE_MIN_BYTES = 0 so that the f64
              route runs through the kernels too, Sedov's read included;
              a step's v1 blobs must equal the host coder's
              (rans.compress) of its packed bytes.
  4. archive  the zlib, v1 and v2 CMIP series through TemporalArchive.write
              (NCK4; NCK3 for v2 without checksums) and NCKReader, then
              decompress_series on the card: the rANS decode kernel, the
              unpack (v1) and the dequantize kernel once per delta step,
              bit-identical to device="cpu", within E; read_range windows
              across block edges and around exceptions equal the full
              decode; a flipped byte in a block raises CorruptBlockError.
  5. strategies  equal-width, k-means and log-scale CMIP and Sedov series
              (equal also with rans), byte-identical to device="cpu".
  6. sharded  ShardedCompressor / ShardedDecompressor over 4 shards on the
              card, and a two-rank MultiProcessCompressor over gloo.
  7. warm     one warm CMIP step, stage by stage (host clock), with zlib
              and with rans, and one warm read step of each.  Then the
              rANS route on both sides of DEVICE_MIN_BYTES: one warm
              step and its read through the host coder and through the
              kernels, at Sedov's step and at CMIP steps cut to
              ROUTE_SIZES elements; the routes must agree bit for bit.
  8. telemetry  the warm CMIP series with zlib and rans v1 under
              telemetry.capture(): NCK bytes equal to telemetry off, the
              reference's per-step and per-read key sets and spans, the
              rollup in ms per stage, Chrome traces under chiprun_out/,
              the device idle share of one warm series from a
              torch.profiler trace; 4 shards under telemetry; the
              entropy process pool forked after CUDA started.
  9. checkpoint  CheckpointManager: five async saves of one full-width
              Llama-3.2-1B layer with its Adam moments (device chain;
              kernels 1-4 once per lossy tensor per delta save), step
              files equal to a host chain's, restore onto a "meta"
              template; then a byte of the newest file flipped.
      elastic  the walk-back past that byte, through restore_elastic onto
              the (1, 1) ("data", "model") CUDA mesh of this one process
              with the full Llama-3.2-1B config's sharding rules (the
              tree under Model.shape_params() keys, so that some leaves
              are Shard): one step back, one report entry, no kernel
              (zlib decodes on the host); every tensor leaf a DTensor on
              the card with named_shardings' placements, its
              full_tensor() bit-equal to restore_latest's tree, lossless
              leaves exact and lossy ones within the bound.  One
              process: NCCL refuses two ranks on one card, and meshes of
              several gloo ranks are held on the CPU.
      pipeline  the GPipe schedule (pipeline_apply) over 2 gloo ranks
              spawned on the card, activations staged through the host:
              Llama-3.2-1B's 16 decoder layers at full width in float32,
              8 a stage, 8 microbatches of (1, 256, 2048) seeded hidden
              states; outputs within 1e-4 and each stage's gradient
              within 1e-3 (relative, Frobenius) of the 16 layers run in
              sequence on rank 0; forward and backward ms of both.
  10. serve   the dense GQA model and the serving engine at Llama-3.2-1B's
              full width (bf16, seeded random weights made on the card): 4
              requests of 256 prompt tokens, 32 new and 32 resumed.  Greedy
              tokens equal across generate + save_session + load_session +
              resume (zlib, rans) and an uninterrupted run; restored leaves
              bit-exact, also loaded on the CPU; load_session launches the
              rANS decode kernel once per v1 group of each leaf on the
              device route (rans) and no kernel with zlib; bf16 logits
              against f32 and decode_step against prefill at cosine >= 0.99.
              The same for serve_mla (minicpm3-4b at full width, 31 of 62
              layers for the run's time limit, MLA,
              the latent ckv/krope cache through the decode kernel; the
              absorbed decode against mla_decode_naive at cosine >= 0.99)
              and serve_moe (mixtral-8x7b at full width, depth cut to 16
              of 32 layers to fit the card; the prefill's share of
              dropped routed choices at capacity factor 1.25), serve_ssm
              (mamba2-780m uncut, 1,000 prompt tokens: the SSD's chunked
              dual form over four chunks of 256, the float32 state h and
              conv tail through the decode kernel) and serve_hybrid
              (hymba-1.5b uncut, 1,300 prompt tokens past its 1,024-token
              window: attention and SSD side by side, per-layer caches),
              serve_vlm (paligemma-3b uncut: 512-token prompts whose
              first 256 fall under the prefix-LM mask; through the Model
              API 256 seeded patch embeds + 256 text tokens, 32 greedy
              tokens through decode_step(token=), the port's scaled token
              path; the prefix mask at 2 layers, card against the CPU)
              and serve_audio (musicgen-medium uncut: 48 MHA layers;
              through the Model API 256 seeded frame embeds, 32 steps of
              decode_step(embed=)).  Every rANS session round trip runs
              on one request (zlib on all four).
  11. train   Trainer.fit on the card: Llama-3.2-1B at full width and depth
              (bf16, seeded on the card), 4 x 256 TokenPipeline tokens a
              step, 8 steps with gradient compression off and 8 at B = 6
              (the histogram kernel once per compressed leaf per step, no
              other kernel), losses finite and falling by LOSS_DROP; step
              ms, tokens/s, peak memory, the device idle share of 3 more
              steps under torch.profiler.  quantize_dequantize on real
              gradients, card against CPU, bit for bit; one step of the
              reduced f32 config, card against CPU.  A restart at full
              width cut to 1 layer: an anchor at step 2, a delta at 4
              (kernels 1-4 once per lossy leaf), a new Trainer restores
              step 4 and trains to 6, matching the uninterrupted run.
              Then minicpm3-4b (16 of 62 layers), mixtral-8x7b (1 of
              32), mamba2-780m, hymba-1.5b, paligemma-3b (4 x 512:
              patches and text) and musicgen-medium (4 x 256 frames,
              remat="block") uncut at full width: 4 steps at B = 6 (the
              histogram kernel once per leaf per step), finite losses
              and gradients, the MoE aux > 0, and quantize_dequantize of
              a real wkv_a / we_down / in_proj / A_log / embed / w_up
              gradient card against CPU, bit for bit.
  12. baselines  the paper's comparison compressors (repro_torch.baselines)
              on a CMIP (f32) and a Sedov (f64) delta step at E = 1e-3:
              ISABELA (window 1,024, 32 knots; the bit-pack kernel once
              per compress, on the permutations), ZFP (tol = mean |x| *
              E) and zlib; payloads byte-equal to device="cpu",
              decompressed arrays equal and within their bounds; each
              compression ratio beside NUMARCK's, ms on the card.
  13. kernels each kernel against its plain version on the card, exactly,
              at n = 42*360*240 (the CMIP step) and n = 2^26, with timings
              (median of 20 launches, CUDA events, after warm-up) beside
              the bound the card's memory and arithmetic rates set.  The
              histogram runs on the id sets of `hist_id_sets` (the CMIP
              step's ids with the main path's id bound, the 2^26 pair, a
              wide-domain 2^26 pair, one-bin and uniform ids) and logs its
              launch shape for each.  The bit-pack kernel runs at every
              B = 1..24 at both sizes, and the unpack kernel on the whole
              blocks of its words (exact, and a round trip); the kernels
              line gives both kernels' ms and share of the bound at each B
              under ``by_b``.  The rANS encode, decode and unpack
              kernels run on the CMIP step's blocks and on a 2^26-element
              step's, v1 and v2, with the format's parallelism beside
              their bound, and ns a step (the measure a chain of m
              dependent steps is bound by).  The CMIP anchor's byte blocks
              go through the rANS encode kernel as a measurement only (the
              full blocks in one launch, the ragged last block in its own),
              byte-identical to the host coder, both timed.  The card's
              clocks and temperature are logged before and after.

It prints the card's name and power limit, one JSON line of per-kernel
numbers, and last {"ok": true, "device": {...}}.  It needs the repo's
src/ beside it and a CUDA device, and exits non-zero without either.
"""
from __future__ import annotations

import dataclasses
import gzip
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12             # H100 SXM, float32 outside tensor cores
FP64_OPS_PER_S = 34e12             # H100 SXM, float64 outside tensor cores
# The rANS kernels do 32-bit integer work; the data sheet gives no int32
# rate, so their operation bound uses the float32 rate (it never binds).
INT_OPS_PER_S = FP32_OPS_PER_S
SM_THREAD_SLOTS = 132 * 2048       # H100 SXM: SMs x resident threads
ITERS = 20
PLAIN_ITERS = 5                    # plain rANS lane loops are slow
E = 1e-3
N_BIG = 1 << 26                    # one card's share of a large variable
MAIN_RUNS = {"cmip": 6, "sedov": 4}  # series -> steps on the main path
# rANS paths: label -> (series, codec params)
RANS_RUNS = {"cmip v1": ("cmip", dict(codec="rans")),
             "cmip v2": ("cmip", dict(codec="rans", symbol_rans=True)),
             "sedov v1": ("sedov", dict(codec="rans")),
             "sedov v2": ("sedov", dict(codec="rans", symbol_rans=True))}
SCALE = 1                          # generate_series scale (1 = paper size)
STRATEGIES = ("equal", "kmeans", "log")
SHARDS = 4                         # ShardedCompressor shards on the one card
SHARD_BLOCK_BYTES = 64 << 10       # block_elems(B) <= a CMIP shard at every B
MP_STEPS = 3                       # CMIP steps of the two-rank save_series
# CMIP steps cut to these element counts for the rANS route timing.
ROUTE_SIZES = (1 << 15, 1 << 17, 1 << 19, 1 << 21)


def log(msg: str) -> None:
    print(msg, flush=True)


def log_clocks(label: str) -> None:
    """The card's clocks and temperature, as nvidia-smi reads them."""
    q = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,"
         "clocks.mem,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    log(f"clocks {label}: {q.stdout.strip() or q.stderr.strip()}")


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


def counted(torch, kernels, fn):
    """Run ``fn`` with every kernel's launch count set to 0 just before it;
    return its result and the counts read just after."""
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k.name: k.launches for k in kernels}


def check_counts(label, got: dict, want: dict) -> None:
    wrong = {k: (c, want.get(k, 0)) for k, c in got.items()
             if c != want.get(k, 0)}
    if wrong:
        raise AssertionError(f"{label}: launches (got, expected) {wrong}")


def compress_launches(n_steps: int, params) -> dict:
    """Launches of a compress run: the four compress kernels once per
    delta step (no bit-pack for v2 blobs), the rANS encode once per delta
    step when the device entropy stage runs."""
    d = n_steps - 1
    rans_on = params.codec == "rans"
    return dict(change_ratio=d, hist=d, dequant=d,
                bitpack=0 if rans_on and params.symbol_rans else d,
                rans_encode=d if rans_on else 0)


def read_launches(steps) -> dict:
    """Launches of decompress_series on the device route: per delta step
    one rANS decode per (version, lanes) group of v1/v2 blobs, one unpack
    per v0 or v1 group, one dequantize; per anchor one decode per
    (length, lanes) group of v1 blobs."""
    from repro_torch.core import compress
    from repro_torch.kernels import rans
    n = dict(rans_decode=0, rans_unpack=0, dequant=0)
    for s in steps:
        if not compress.device_decode_route(s):
            continue
        keys = set()
        for b in s.index_blocks:
            v = rans.blob_version(b)
            if v == 1:
                keys.add((1,) + tuple(rans._parse_v1(b)[:2]))
            elif v == 2:
                keys.add((2, rans._parse_v2(b)[2]))
            elif not s.is_anchor:
                keys.add((0,))
        if s.is_anchor:
            n["rans_decode"] += len(keys)
            continue
        n["rans_decode"] += sum(k[0] != 0 for k in keys)
        n["rans_unpack"] += sum(k[0] != 2 for k in keys)
        n["dequant"] += 1
    return n


def same_steps(np, interop, label, got, want, skip=()) -> None:
    for i, (g, w) in enumerate(zip(got, want)):
        fg, fw = interop.step_to_fields(g), interop.step_to_fields(w)
        for key in set(fg) - set(skip):
            same = (np.array_equal(fg[key], fw[key])
                    if isinstance(fw[key], np.ndarray)
                    else fg[key] == fw[key])
            if not same:
                raise AssertionError(f"{label} step {i}: field {key!r} "
                                     "differs between cuda and cpu")


def check_recon(np, label, arrays, recon) -> list:
    from repro_torch.core.types import mean_error_rate
    errs = [mean_error_rate(a, r) for a, r in zip(arrays, recon)]
    if max(errs) > E * 1.01 or not all(
            np.isfinite(r).all() and r.shape == a.shape
            for a, r in zip(arrays, recon)):
        raise AssertionError(f"{label}: mean error rates {errs} > E")
    return errs


def stage_times(torch, params, dev, first, step_in) -> tuple:
    """One warm delta step of the compressor, stage by stage (host clock,
    each stage ended by a synchronize); returns the ms per stage and the
    step."""
    from repro_torch.core import chain as chainmod
    from repro_torch.core import compress, pipeline

    ref_chain = chainmod.DeviceReferenceChain(dev)
    ref_chain.seed(first)
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
    step = stage("finalize", lambda: pipeline.finalize_step(
        step_in, enc.enc, enc.centers, enc.domain_lo, enc.width, params,
        enc.meta))
    return stages, step


def route_times(torch, np, dev, data: dict) -> None:
    """The rANS route at payloads around DEVICE_MIN_BYTES: one warm delta
    step (encode + finalize, host clock) and its read, through the host
    coder (threshold above the payload) and through the kernels
    (threshold 0), median of three after a warm-up.  Sedov's step and
    CMIP steps cut to ROUTE_SIZES elements.  The two routes must give the
    same blobs and the same reconstruction, and only the kernel route may
    launch the rANS kernels."""
    from repro_torch.core import compress
    from repro_torch.core.types import NumarckParams
    from repro_torch.kernels import rans

    p = NumarckParams(error_bound=E, codec="rans")
    cases = {"sedov": (data["sedov"][0], data["sedov"][1])}
    for n in ROUTE_SIZES:
        cases[f"cmip[:{n}]"] = tuple(
            np.ascontiguousarray(a.reshape(-1)[:n]) for a in data["cmip"][:2])
    min_bytes = rans.DEVICE_MIN_BYTES
    try:
        for label, (first, step_in) in cases.items():
            res = {}
            for route, threshold in (("host", 1 << 62), ("kernels", 0)):
                rans.DEVICE_MIN_BYTES = threshold
                enc, read = [], []
                for _ in range(4):
                    (stages, step), got = counted(
                        torch, [rans.ENCODE], lambda: stage_times(
                            torch, p, dev, first, step_in))
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    recon, got_r = counted(
                        torch, [rans.DECODE], lambda: compress.decompress_step(
                            step, first, device=dev))
                    read.append((time.perf_counter() - t0) * 1e3)
                    enc.append(stages["encode"] + stages["finalize"])
                if (got["rans_encode"] > 0) != (route == "kernels") or \
                        (got_r["rans_decode"] > 0) != (route == "kernels"):
                    raise AssertionError(f"route {label} {route}: launches "
                                         f"{got} {got_r}")
                res[route] = (statistics.median(enc[1:]),
                              statistics.median(read[1:]), step, recon)
            (he, hr, hs, hx), (ke, kr, ks, kx) = res["host"], res["kernels"]
            if list(hs.index_blocks) != list(ks.index_blocks) or \
                    not np.array_equal(hx, kx):
                raise AssertionError(f"route {label}: the host coder and the "
                                     "kernels disagree")
            log(f"rans route {label}: n={first.size} {first.dtype} "
                f"B={hs.b_bits}, payload {first.size * hs.b_bits // 8} bytes"
                f" (what the threshold reads), coded as {len(hs.index_blocks)}"
                f" marker-padded block(s) of {p.block_bytes} bytes; warm step "
                "encode+finalize"
                f" ms: host coder {he:.2f}, kernels {ke:.2f}; read ms: host "
                f"coder {hr:.2f}, kernels {kr:.2f}; identical")
    finally:
        rans.DEVICE_MIN_BYTES = min_bytes
    # The host coder (NumPy) against the encode's plain PyTorch version on
    # CPU tensors, on one 1 MB block of the last case's bytes: the host
    # route keeps the NumPy coder because it is the faster of the two.
    raw = rans.decompress(hs.index_blocks[0])
    arr = np.frombuffer(raw, np.uint8)
    freq = rans.freq_table(arr)
    fc = torch.from_numpy(rans.pack_fc(freq).view(np.int32)[None, :])
    syms = torch.from_numpy(arr.copy()).view(1, -1)
    L = rans.lanes_for(arr.size)
    t_np, t_pt = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        want = rans.encode_np(arr, freq)
        t_np.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        st, vals, masks = rans.encode_plain(syms, fc, L=L)
        got = (st[0].numpy().view(np.uint32),
               vals[masks].numpy().view(np.uint16))
        t_pt.append((time.perf_counter() - t0) * 1e3)
        if not all(np.array_equal(g, w) for g, w in zip(got, want)):
            raise AssertionError("encode_plain on the CPU differs from "
                                 "encode_np")
    log(f"host rANS encode of one {arr.size}-byte block on the host CPU, ms "
        f"(median of 3): NumPy coder {statistics.median(t_np):.1f}, plain "
        f"PyTorch version on CPU tensors {statistics.median(t_pt):.1f}; "
        "identical")


def archive_phase(torch, np, dev, series: dict) -> dict:
    """Write each (arrays, steps) series with TemporalArchive.write, read
    it back through NCKReader and decompress it on the card; partial
    reads and a corrupt block.  Returns each read run's launch counts."""
    from repro_torch import NCKReader, TemporalArchive, decompress_series
    from repro_torch.core import compress
    from repro_torch.faults.errors import CorruptBlockError
    from repro_torch.kernels import ops

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, (arrays, steps) in series.items():
            path = os.path.join(tmp, label.replace(" ", "_") + ".nck")
            TemporalArchive.write(path, "v", steps)
            with open(path, "rb") as f:
                if f.read(4) != b"NCK4":
                    raise AssertionError(f"{label}: not stamped NCK4")
            if label.endswith("v2"):
                TemporalArchive.write(path + ".v3", "v", steps,
                                      checksums=False)
                with open(path + ".v3", "rb") as f:
                    if f.read(4) != b"NCK3":
                        raise AssertionError(f"{label}: v2 blobs without "
                                             "checksums not stamped NCK3")
            r = NCKReader(path)
            read = [r.read_step(n) for n in r.step_names()]
            recon, got = counted(torch, ops.KERNELS, lambda: decompress_series(
                read, device=dev))
            want = read_launches(read)
            log(f"archive {label}: read path launches {json.dumps(got)}")
            check_counts(f"archive {label}", got, want)
            if label != "cmip zlib" and (
                    got["dequant"] != len(steps) - 1
                    or got["rans_decode"] < len(steps) - 1):
                raise AssertionError(f"{label}: the read path did not run "
                                     "the decode and dequantize kernels "
                                     "once per delta step")
            launches[label] = got
            cpu = decompress_series(read, device="cpu")
            for i, (a, b) in enumerate(zip(recon, cpu)):
                if a.dtype != b.dtype or not np.array_equal(a, b):
                    raise AssertionError(f"{label} step {i}: cuda read "
                                         "differs from the cpu read")
            errs = check_recon(np, f"archive {label}", arrays, recon)
            ar = TemporalArchive(path)
            n_win = 0
            for it in (1, len(steps) - 1):
                st = read[it]
                n, be = st.n, st.block_elems
                idx = compress._decode_index_host(st)
                pos = np.flatnonzero(idx == (1 << st.b_bits) - 1)
                wins = [(0, 64), (n - 100, n)]
                if be + 7 <= n:
                    wins.append((be - 5, be + 7))
                wins += [(max(p - 3, 0), min(p + 4, n))
                         for p in pos[[0, -1]]] if pos.size else []
                for lo, hi in wins:
                    part = ar.read_range("v", it, lo, hi)
                    if not np.array_equal(part,
                                          recon[it].reshape(-1)[lo:hi]):
                        raise AssertionError(f"{label}: read_range({it}, "
                                             f"{lo}, {hi}) differs")
                    n_win += 1
            raw = bytearray(open(path, "rb").read())
            var = r.variables["v_it00003_index_table"]
            raw[r._data_start + var["offset"] + var["nbytes"] // 2] ^= 0x40
            bad = path + ".bad"
            open(bad, "wb").write(bytes(raw))
            for read_bad in (lambda: NCKReader(bad).read_step("v_it00003"),
                             lambda: TemporalArchive(bad).read_full("v", 3)):
                try:
                    read_bad()
                except CorruptBlockError:
                    continue
                raise AssertionError(f"{label}: a flipped byte in a block "
                                     "did not raise CorruptBlockError")
            log(f"archive {label}: {os.path.getsize(path)} bytes, "
                f"{len(steps)} steps read back bit-identical to "
                f"device=cpu, max mean error {max(errs):.3e}, {n_win} "
                "read_range windows exact, corrupt block raised")
    return launches


def strategies_phase(torch, np, dev, data: dict, launches: dict) -> None:
    """The equal-width, k-means and log-scale strategies through
    compress_series on the card (CMIP and Sedov; equal also with the rANS
    encode kernel): kernels 1-4 once per delta step, steps byte-identical
    to device="cpu", every step decompressed within E."""
    from repro_torch import compress_series, decompress_series, interop
    from repro_torch.core.types import NumarckParams
    from repro_torch.kernels import ops

    runs = [(s, name, {}) for s in STRATEGIES for name in ("cmip", "sedov")]
    runs.append(("equal", "cmip", {"codec": "rans"}))
    for strategy, name, kw in runs:
        arrays = data[name]
        p = NumarckParams(error_bound=E, strategy=strategy, **kw)
        label = f"{strategy} {name}" + (" rans" if kw else "")
        t0 = time.perf_counter()
        steps, got = counted(torch, ops.KERNELS, lambda: compress_series(
            arrays, p, chain="device", device=dev))
        first_s = time.perf_counter() - t0
        check_counts(label, got, compress_launches(len(arrays), p))
        launches[label] = got
        t0 = time.perf_counter()
        compress_series(arrays, p, chain="device", device=dev)
        warm_s = time.perf_counter() - t0
        same_steps(np, interop, label, steps, compress_series(
            arrays, p, chain="device", device="cpu"))
        errs = check_recon(np, label, arrays,
                           decompress_series(steps, device=dev))
        raw = sum(a.nbytes for a in arrays)
        log(f"strategy {label}: launches {json.dumps(got)}, CR="
            f"{raw / sum(s.nbytes for s in steps):.2f}, compress_series "
            f"{warm_s * 1e3:.1f} ms warm ({first_s * 1e3:.1f} first call) "
            f"for {len(steps)} steps, B={[s.b_bits for s in steps[1:]]}, "
            f"max mean error {max(errs):.3e}, byte-identical to device=cpu")


_MP_WORKER = """
import json, os, sys, time
import torch
from repro_torch.data.temporal import generate_series
from repro_torch.launch import distributed as ld
from repro_torch.core.types import NumarckParams
from repro_torch.distributed.pipeline import MultiProcessCompressor
from repro_torch.kernels import ops
ld.initialize()
arrays = list(generate_series("cmip", {steps}, seed=0, scale={scale}))
mp = MultiProcessCompressor(["cuda"], NumarckParams(error_bound={e}))
torch.cuda.synchronize()
for k in ops.KERNELS:
    k.launches = 0
t0 = time.perf_counter()
mp.save_series(os.environ["MP_PATH"], arrays)
torch.cuda.synchronize()
wall = time.perf_counter() - t0
counts = {{k.name: k.launches for k in ops.KERNELS}}
mp.close()
ld.shutdown()
print("MP_RESULT " + json.dumps({{"launches": counts, "wall_s": wall}}))
"""


def shard_launches(n_steps: int, params, shards: int) -> dict:
    """Launches of a sharded compress run: each compress kernel once per
    shard and delta step."""
    return {k: v * shards
            for k, v in compress_launches(n_steps, params).items()}


def shard_read_launches(steps, shards: int) -> dict:
    """Launches of ShardedDecompressor.decompress_series: the anchor as
    ``read_launches`` counts it (one device); per delta step and shard one
    dequantize, and on the device decode route each shard's run of blocks
    counted as ``read_launches`` counts a step."""
    from repro_torch.core import compress

    n = dict(rans_decode=0, rans_unpack=0, dequant=0)
    for s in steps:
        if s.is_anchor:
            for k, v in read_launches([s]).items():
                n[k] += v
            continue
        if not compress.device_decode_route(s):
            n["dequant"] += min(shards, s.n)
            continue
        nb = len(s.index_blocks)
        per = -(-nb // shards)
        for j in range(shards):
            blobs = s.index_blocks[j * per:(j + 1) * per]
            if not blobs:
                continue
            part = read_launches([dataclasses.replace(
                s, index_blocks=blobs)])
            for k, v in part.items():
                n[k] += v
    return n


def sharded_phase(torch, np, dev, data: dict, launches: dict) -> None:
    """ShardedCompressor over SHARDS shards on the one card (CMIP: zlib,
    rans v1, fixed_domain), byte-identical to the same driver on the CPU
    and, at SHARD_BLOCK_BYTES, to the single-device compress_series on
    the card; ShardedDecompressor reads back bit-identically; a two-rank
    MultiProcessCompressor.save_series over gloo on the same card merges
    to the single-process sharded steps.  Exact per-shard launch counts."""
    from repro_torch import NCKReader, NCKWriter, compress_series, interop
    from repro_torch import decompress_series
    from repro_torch.core.types import NumarckParams
    from repro_torch.distributed.pipeline import (ShardedCompressor,
                                                  ShardedDecompressor)
    from repro_torch.kernels import ops
    from repro_torch.launch.distributed import check_spawned, spawn_emulated

    K = ops.KERNELS
    arrays = data["cmip"]
    runs = {"zlib 1MB": {}, "zlib": {"block_bytes": SHARD_BLOCK_BYTES},
            "rans v1": {"block_bytes": SHARD_BLOCK_BYTES, "codec": "rans"},
            "fixed_domain": {"block_bytes": SHARD_BLOCK_BYTES,
                             "fixed_domain": True}}
    for label, kw in runs.items():
        p = NumarckParams(error_bound=E, **kw)
        sc = ShardedCompressor([dev] * SHARDS, p)
        steps, got = counted(torch, K, lambda: sc.compress_series(arrays))
        check_counts(f"sharded {label}", got,
                     shard_launches(len(arrays), p, SHARDS))
        launches[f"sharded {label}"] = got
        t0 = time.perf_counter()
        sc.compress_series(arrays)
        torch.cuda.synchronize()
        t_shard = time.perf_counter() - t0
        sc.close()
        cpu = ShardedCompressor(["cpu"] * SHARDS, p)
        same_steps(np, interop, f"sharded {label}", steps,
                   cpu.compress_series(arrays))
        cpu.close()
        compress_series(arrays, p, chain="device", device=dev)
        t0 = time.perf_counter()
        single = compress_series(arrays, p, chain="device", device=dev)
        t_single = time.perf_counter() - t0
        note = "blocks shrink to a shard" if label == "zlib 1MB" else (
            "fixed_domain: the single-device driver ignores it"
            if p.fixed_domain else "byte-identical to single-device")
        if not (label == "zlib 1MB" or p.fixed_domain):
            # meta names the pipeline, so it differs by design.
            same_steps(np, interop, f"sharded {label} vs single", steps,
                       single, skip=("meta",))
        dec = ShardedDecompressor([dev] * SHARDS)
        recon, got = counted(torch, K, lambda: dec.decompress_series(steps))
        check_counts(f"sharded read {label}", got,
                     shard_read_launches(steps, SHARDS))
        launches[f"sharded read {label}"] = got
        for i, (a, b) in enumerate(zip(recon, decompress_series(
                steps, device="cpu"))):
            if not np.array_equal(a, b):
                raise AssertionError(f"sharded read {label} step {i}: "
                                     "differs from the cpu read")
        errs = check_recon(np, f"sharded {label}", arrays, recon)
        t0 = time.perf_counter()
        dec.decompress_series(steps)
        t_read = time.perf_counter() - t0
        decompress_series(steps, device=dev)
        t0 = time.perf_counter()
        decompress_series(steps, device=dev)
        t_read1 = time.perf_counter() - t0
        log(f"sharded {label}: {SHARDS} shards, launches "
            f"{json.dumps(launches[f'sharded {label}'])}, warm "
            f"compress_series {t_shard * 1e3:.1f} ms against single-device "
            f"{t_single * 1e3:.1f} ms, decompress_series {t_read * 1e3:.1f} "
            f"ms against {t_read1 * 1e3:.1f} ms ({len(steps)} steps, block "
            f"{steps[1].block_elems} elements; {note}), identical to the "
            f"cpu shards, read back bit-identical, max mean error "
            f"{max(errs):.3e}")

    # Two ranks on the one card over gloo, against one process's two
    # shards, through the files both write.
    p = NumarckParams(error_bound=E)
    sub = arrays[:MP_STEPS]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mp.nck")
        env = dict(os.environ, MP_PATH=path, PYTHONPATH=str(SRC))
        t0 = time.perf_counter()
        res = spawn_emulated(2, ["-c", _MP_WORKER.format(
            steps=MP_STEPS, scale=SCALE, e=E)], base_env=env, timeout=300)
        spawn_s = time.perf_counter() - t0
        check_spawned(res)
        outs = [json.loads(r.stdout.split("MP_RESULT ")[1]) for r in res]
        for rank, o in enumerate(outs):
            check_counts(f"multi-process rank {rank}", o["launches"],
                         compress_launches(MP_STEPS, p))
            launches[f"multi-process rank {rank}"] = o["launches"]
        sc = ShardedCompressor([dev] * 2, p)
        want = sc.compress_series(sub)
        sc.close()
        w = NCKWriter()
        for i, s in enumerate(want):
            w.add_step(f"step{i:04d}", s)
        w.write(os.path.join(tmp, "ref.nck"))
        got_r, want_r = NCKReader(path), NCKReader(os.path.join(tmp,
                                                                "ref.nck"))
        if got_r.step_names() != want_r.step_names():
            raise AssertionError("multi-process: step names differ")
        same_steps(np, interop, "multi-process",
                   [got_r.read_step(n) for n in got_r.step_names()],
                   [want_r.read_step(n) for n in want_r.step_names()])
    log(f"multi-process: 2 ranks (gloo) on one card, {MP_STEPS} CMIP steps, "
        f"save_series {max(o['wall_s'] for o in outs) * 1e3:.1f} ms per "
        f"rank, {spawn_s:.1f} s with process start, launches per rank "
        f"{json.dumps(outs[0]['launches'])}; the NCKM merge equals the "
        "single-process two-shard steps")


def rans_inputs(torch, np, dev, prev, curr, params):
    """The rANS kernels' inputs at one step: encode_device's marker-padded
    indices, the v1 input (packed bytes and per-block tables) and the v2
    input (indices and one table), the v1 and v2 blobs, B and L."""
    from repro_torch.core import compress
    from repro_torch.kernels import bitpack, rans

    enc = compress.encode_device(torch.from_numpy(prev).to(dev),
                                 torch.from_numpy(curr).to(dev), params,
                                 need_host_idx=False)
    b, be, n = enc.enc.b_bits, enc.enc.block_elems, enc.enc.n
    nb = -(-n // be)
    marker = (1 << b) - 1
    idx = torch.full((nb * be,), marker, dtype=torch.int32, device=dev)
    idx[:n] = enc.idx_dev
    nbytes = be * b // 8
    byts = bitpack.pack_bits_cuda(idx, b_bits=b).view(torch.uint8).view(
        nb, nbytes)
    freqs, fcs = rans.tables_from_samples(
        byts[:, ::rans.sample_stride(nbytes)].cpu().numpy())
    k_eff = min(marker, params.max_bins)
    counts = np.bincount(idx.cpu().numpy(), minlength=k_eff + 1)[:k_eff]
    freq2 = rans.symbol_freq(counts, k_eff, nb * be)
    v1 = rans.compress_blocks_device(idx, b, nb, be)
    v2 = rans.compress_blocks_device_symbols(idx, b, k_eff, nb, be, counts)
    return dict(b=b, be=be, nb=nb, nbytes=nbytes, k_eff=k_eff, byts=byts,
                idx2d=idx.view(nb, be),
                fc1=torch.from_numpy(fcs.view(np.int32)).to(dev),
                fc2=torch.from_numpy(rans.pack_fc(freq2).view(np.int32)
                                     [None, :]).to(dev),
                v1=v1, v2=v2)


def rans_kernel_phase(torch, np, dev, pairs: dict, table: dict) -> None:
    """The rANS encode, decode and unpack kernels against their plain
    versions on the card, exactly, at each pair's step (v1 and v2),
    timed, with the bound and the format's parallelism."""
    from repro_torch.core.types import NumarckParams
    from repro_torch.kernels import rans

    params = NumarckParams(error_bound=E, codec="rans")
    for label, (p_np, c_np) in pairs.items():
        x = rans_inputs(torch, np, dev, p_np, c_np, params)
        b, be, nb, nbytes = x["b"], x["be"], x["nb"], x["nbytes"]
        for ver, blobs in (("v1", x["v1"]), ("v2", x["v2"])):
            versions = sorted({rans.blob_version(o) for o in blobs})
            if label == "cmip" and ver == "v1":
                host = [rans.compress(x["byts"][k].cpu().numpy().tobytes())
                        for k in range(nb)]
                if host != blobs:
                    raise AssertionError("cmip v1 blobs differ from the "
                                         "host coder's")
            syms, fc = ((x["byts"], x["fc1"]) if ver == "v1"
                        else (x["idx2d"], x["fc2"]))
            n_sym = syms.shape[1]
            L = rans.lanes_for(n_sym)
            m = -(-n_sym // L)
            got = rans.encode_cuda(syms, fc, L=L)
            rec = dict(blocks=nb, lanes=L, steps=m,
                       thread_share=nb * L / SM_THREAD_SLOTS,
                       blob_versions=versions)
            check_rans(torch, table, "rans_encode", got,
                       rans.encode_plain(syms, fc, L=L))
            ms = time_ms(torch, lambda: rans.encode_cuda(syms, fc, L=L))
            plain_ms = time_ms(torch, lambda: rans.encode_plain(
                syms, fc, L=L), PLAIN_ITERS, 1)
            nbytes_io = (syms.numel() * syms.element_size() + fc.numel() * 4
                         + nb * m * L * 3 + nb * L * 4)
            put_rans(table, "rans_encode", f"{label} {ver}", rec, ms,
                     plain_ms, nbytes_io, 12 * nb * m * L)
            # decode the same blocks (v0 blocks decode through the unpack)
            coded = [o for o in blobs if rans.blob_version(o) != 0]
            if not coded:
                continue
            parse = rans._parse_v1 if ver == "v1" else rans._parse_v2
            skip = 2 if ver == "v1" else 3
            parsed = [dict(zip(("freq", "states", "stream"), parse(o)[skip:]))
                      for o in coded]
            dec, sym, st, stream, ne, ne_np = rans._upload_group(parsed, dev)
            g = len(coded)
            if ver == "v1":
                args = (dec, st, stream, ne)
                kw = dict(m=m, L=L)
                fn_c, fn_p = rans.decode_bytes_cuda, rans.decode_bytes_plain
                out_bytes = g * m * L
            else:
                args = (dec, sym, st, stream, ne)
                kw = dict(m=m, L=L, n=be, n_sym=x["k_eff"] + 1, b_bits=b)
                fn_c, fn_p = rans.decode_syms_cuda, rans.decode_syms_plain
                out_bytes = 4 * g * be
            got = fn_c(*args, **kw)
            check_rans(torch, table, "rans_decode", got, fn_p(*args, **kw))
            rans._checked(got[1], got[2], ne_np)
            ms = time_ms(torch, lambda: fn_c(*args, **kw))
            plain_ms = time_ms(torch, lambda: fn_p(*args, **kw), PLAIN_ITERS,
                               1)
            nbytes_io = (g * rans.M * 4 * (2 if sym is not None else 1)
                         + 8 * g * L + 2 * int(ne_np.sum()) + 8 * g
                         + out_bytes + 8 * g)
            put_rans(table, "rans_decode", f"{label} {ver}",
                     dict(rec, blocks=g), ms, plain_ms, nbytes_io,
                     15 * g * m * L)
            if ver == "v1":
                byts = got[0]
                out = rans.unpack_cuda(byts, b_bits=b, be=be)
                check_rans(torch, table, "rans_unpack", out,
                           rans.unpack_plain(byts, b_bits=b, be=be))
                if not torch.equal(out, x["idx2d"][[i for i, o in
                                                    enumerate(blobs)
                                                    if rans.blob_version(o)]]):
                    raise AssertionError(f"{label}: decoded v1 indices "
                                         "differ from the encoded ones")
                ms = time_ms(torch, lambda: rans.unpack_cuda(
                    byts, b_bits=b, be=be))
                plain_ms = time_ms(torch, lambda: rans.unpack_plain(
                    byts, b_bits=b, be=be), PLAIN_ITERS, 1)
                put_rans(table, "rans_unpack", f"{label} B={b}",
                         dict(blocks=g, elements=g * be), ms, plain_ms,
                         g * nbytes + 4 * g * be, 6 * g * be)
            elif not torch.equal(got[0], x["idx2d"][[
                    i for i, o in enumerate(blobs) if rans.blob_version(o)]]):
                raise AssertionError(f"{label}: decoded v2 indices differ "
                                     "from the encoded ones")
        del x


def check_rans(torch, table, kname, got, want) -> None:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    err = max(max_abs_err(torch, g, w) for g, w in zip(got, want))
    table[kname]["max_abs_err"] = max(table[kname]["max_abs_err"], err)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{kname}: kernel differs from its plain "
                             f"version (max abs err {err})")


def put_rans(table, kname, shape, rec, ms, plain_ms, nbytes, ops) -> None:
    """Log one rANS timing; the first shape (the CMIP step's v1 blocks)
    fills the row's numbers, every shape goes under ``shapes``."""
    b, by = bound_ms(nbytes, ops, INT_OPS_PER_S)
    rec = dict(rec, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by)
    if "steps" in rec:
        rec["ns_per_step"] = ms * 1e6 / rec["steps"]
    row = table[kname]
    row.setdefault("shapes", {})[shape] = rec
    if "ms" not in row:
        row.update(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                   library_ms=None)
        if "ns_per_step" in rec:
            row["ns_per_step"] = rec["ns_per_step"]
    log(f"{kname} {shape}: {ms:.4f} ms ({b / ms:.1%} of the bound "
        f"{b:.4f} ms, {by}), plain {plain_ms:.2f} ms, exact; "
        f"{json.dumps({k: v for k, v in rec.items() if k not in ('ms', 'plain_ms', 'bound_ms', 'bound_by')})}")


def pack_input(torch, dev, gen, n: int, b: int, params, main: bool):
    """Random B-bit indices for the bit-pack kernel at one size, and the
    block length be of B: the CMIP step padded to whole blocks as the
    main path packs it (``main``), else exactly n."""
    be = params.block_elems(b)
    n_pad = -(-n // be) * be if main else n
    idx = torch.randint(0, 1 << b, (n_pad,), generator=gen, device=dev,
                        dtype=torch.int32)
    return idx, be


def unpack_rows(torch, words, n: int, be: int, b: int):
    """The packed words of the whole blocks among n indices, as the
    (blocks, be * B / 8) byte rows the unpack kernel takes."""
    nb = n // be
    return words[:nb * be * b // 32].view(torch.uint8).view(nb, be * b // 8)


def pack_bytes(n: int, b: int) -> int:
    """Bytes the bit-pack kernel must move: n int32 in, n * B / 8 out."""
    return 4 * n + n * b // 8


def unpack_bytes(nb: int, be: int, b: int) -> int:
    """Bytes the unpack kernel must move: nb rows of be * B / 8 in,
    nb * be int32 out."""
    return nb * be * b // 8 + 4 * nb * be


def put_by_b(table, kname, label, b, ms, nbytes, ops) -> None:
    """One kernel's time at one B under ``by_b``, beside its bound."""
    bound, by = bound_ms(nbytes, ops, INT_OPS_PER_S)
    table[kname].setdefault("by_b", {}).setdefault(label, {})[b] = dict(
        ms=ms, bound_ms=bound, bound_by=by, share=bound / ms)


def anchor_encode(torch, np, dev, first, params, table) -> None:
    """The CMIP anchor's byte blocks through the rANS encode kernel, as a
    measurement only (anchors are coded by the host coder on the main
    path): the full blocks in one launch, the ragged last block in its
    own, each group's tables from its sampled bytes as in
    ``rans.compress``.  The blobs must equal the host coder's; both routes
    are timed on the host clock, the two launches with CUDA events."""
    from repro_torch.kernels import rans

    flat = first.reshape(-1)
    be = params.block_bytes // flat.dtype.itemsize
    raws = [flat[i:i + be].tobytes() for i in range(0, flat.size, be)]
    groups = ([raws] if len(raws[-1]) == len(raws[0])
              else [raws[:-1], raws[-1:]])
    inputs = [(g, np.frombuffer(b"".join(g), np.uint8).reshape(len(g), -1)
               .copy()) for g in groups]

    def tables(arr):
        return rans.tables_from_samples(
            arr[:, ::rans.sample_stride(arr.shape[1])])

    def kernel_route():
        blobs = []
        for g, arr in inputs:
            freqs, fcs = tables(arr)
            byts = torch.from_numpy(arr).to(dev)
            fc = torch.from_numpy(fcs.view(np.int32)).to(dev)
            states, streams = rans._run_encode(byts, fc)
            blobs += [rans.assemble_blob(arr.shape[1], freqs[k], states[k],
                                         streams[k],
                                         raw_bytes=lambda r=g[k]: r)
                      for k in range(len(g))]
        return blobs

    t0 = time.perf_counter()
    host = [rans.compress(r) for r in raws]
    host_ms = (time.perf_counter() - t0) * 1e3
    kernel_route()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = kernel_route()
    torch.cuda.synchronize()
    route_ms = (time.perf_counter() - t0) * 1e3
    if got != host:
        raise AssertionError("anchor blocks: the encode kernel's blobs differ "
                             "from the host coder's")
    dev_in = [(torch.from_numpy(arr).to(dev),
               torch.from_numpy(tables(arr)[1].view(np.int32)).to(dev),
               rans.lanes_for(arr.shape[1])) for _, arr in inputs]
    ms = time_ms(torch, lambda: [rans.encode_cuda(b, f, L=L)
                                 for b, f, L in dev_in])
    versions = sorted({rans.blob_version(o) for o in host})
    rec = dict(blocks=len(raws), launches=len(dev_in),
               block_bytes=[a.shape[1] for _, a in inputs],
               blob_versions=versions, host_coder_ms=host_ms,
               kernel_route_ms=route_ms, kernels_ms=ms)
    table["rans_encode"].setdefault("shapes", {})["cmip anchor"] = rec
    log(f"anchor rans_encode (measurement only): {len(raws)} blocks of the "
        f"CMIP anchor in {len(dev_in)} launches, blob versions {versions}, "
        f"byte-identical to the host coder; host coder {host_ms:.1f} ms, "
        f"kernel route (tables, upload, launches, compaction, copies, "
        f"assembly) {route_ms:.1f} ms, the launches alone {ms:.4f} ms")


# Spans the reference's single-device driver records on the telemetry
# phase's path (compress_series, TemporalArchive.write, decompress_series);
# the port adds encode.pack_fetch (its bit-pack runs on the card).
REF_SPANS = {
    "zlib": {"encode.analyze", "encode.index", "encode.exceptions",
             "encode.device_entropy", "encode.idx_fetch", "finalize",
             "finalize.exceptions", "finalize.entropy", "finalize.anchor",
             "finalize.task", "entropy.compress", "entropy.batch",
             "nck.write", "nck.fsync", "nck.rename", "decode.entropy",
             "decode.dequant", "decode.patch"},
}
REF_SPANS["rans"] = REF_SPANS["zlib"] | {"decode.fetch"}
# Llama-3.2-1B (src/repro/configs/llama3_2_1b.py): a decoder layer's
# weights, float32, at full width, under the keys and shapes of
# Model.shape_params() (each leaf gets a leading layer dim), so that the
# parameter rules shard them.
LLAMA_LAYER = {"attn": {"wq": (2048, 32, 64), "wk": (2048, 8, 64),
                        "wv": (2048, 8, 64), "wo": (32, 64, 2048)},
               "mlp": {"w_gate": (2048, 8192), "w_up": (2048, 8192),
                       "w_down": (8192, 2048)},
               "ln_attn": {"scale": (2048,)},
               "ln_mlp": {"scale": (2048,)}}
CKPT_LAYERS = 1                    # of the model's 16 decoder layers (the
                                   # run's 1,200 s: PERF.md section 4)
CKPT_SAVES = 5
OUT = ROOT / "chiprun_out"


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def idle_share(trace_path: str, window: str) -> dict:
    """The part of the profiled window in which no kernel ran on the card,
    from a torch.profiler Chrome trace: the union of the kernel intervals
    against the host span ``window`` (a record_function around the run,
    which ends in a synchronize).  Also with copies and memsets counted as
    busy, and the kernels' total time by name."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    win = [e for e in events if e.get("name") == window
           and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise AssertionError(f"profiler trace holds {len(win)} '{window}' "
                             "windows")
    t0, t1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]

    def busy(cats):
        spans = sorted((max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                       for e in events if e.get("cat") in cats
                       and e.get("ph") == "X")
        total, end = 0.0, t0
        for a, b in spans:
            a = max(a, end)
            if b > a:
                total += b - a
                end = b
        return total

    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        raise AssertionError("the profiler recorded no kernel on the card")
    by_name: dict = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    span = t1 - t0
    k_busy = busy({"kernel"})
    all_busy = busy({"kernel", "gpu_memcpy", "gpu_memset"})
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(window_ms=span / 1e3, kernel_busy_ms=k_busy / 1e3,
                idle_share=1 - k_busy / span,
                idle_share_with_copies=1 - all_busy / span,
                kernels=len(kernels),
                top_kernels_ms={n[:60]: round(t / 1e3, 4) for n, t in top})


class _GilXorCodec:
    """A pure-Python codec that holds the GIL, registered for the entropy
    process-pool check (forked workers inherit it)."""

    name = "_smoke_gil_xor"
    holds_gil = True
    device = False

    def compress(self, raw: bytes, level: int) -> bytes:
        return bytes(b ^ 0x5A for b in raw)

    def decompress(self, blob: bytes) -> bytes:
        return bytes(b ^ 0x5A for b in blob)


def telemetry_phase(torch, np, dev, data: dict, launches: dict) -> None:
    """The warm CMIP series with zlib and with rans v1 under
    telemetry.capture(): NCK bytes equal to the run with telemetry off,
    the canonical per-step and per-read key sets, every span the
    reference's driver records on that path, the rollup in ms per stage,
    a Chrome trace under chiprun_out/, and the device idle share of one
    warm series under torch.profiler; then 4 shards at 64 KB blocks under
    telemetry (the single-device key set), and a GIL-holding codec
    through the forked entropy process pool after CUDA is initialised."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch import TemporalArchive, compress_series
    from repro_torch import decompress_series
    from repro_torch.core import entropy
    from repro_torch.core.types import NumarckParams
    from repro_torch.distributed.pipeline import (ShardedCompressor,
                                                  ShardedDecompressor)
    from repro_torch.kernels import ops
    from repro_torch.obs import report, telemetry, trace
    from repro_torch.obs.report import (READ_TELEMETRY_KEYS,
                                        STEP_TELEMETRY_KEYS)

    OUT.mkdir(exist_ok=True)
    card = card_line()
    arrays = data["cmip"]

    def check_keys(label, steps):
        for i, st in enumerate(steps):
            if tuple(st.meta["telemetry"]) != STEP_TELEMETRY_KEYS:
                raise AssertionError(f"{label} step {i}: telemetry keys "
                                     f"{tuple(st.meta['telemetry'])}")
            if tuple(st.meta["telemetry_read"]) != READ_TELEMETRY_KEYS:
                raise AssertionError(f"{label} step {i}: read telemetry "
                                     "keys "
                                     f"{tuple(st.meta['telemetry_read'])}")

    with tempfile.TemporaryDirectory() as tmp:
        for codec in ("zlib", "rans"):
            p = NumarckParams(error_bound=E, codec=codec)
            off = compress_series(arrays, p, chain="device", device=dev)
            TemporalArchive.write(os.path.join(tmp, "off.nck"), "v", off)
            with telemetry.capture() as reg:
                on, got = counted(torch, ops.KERNELS, lambda: compress_series(
                    arrays, p, chain="device", device=dev))
                TemporalArchive.write(os.path.join(tmp, "on.nck"), "v", on)
                recon = decompress_series(on, device=dev)
            launches[f"telemetry {codec}"] = got
            check_counts(f"telemetry {codec}", got,
                         compress_launches(len(arrays), p))
            if open(os.path.join(tmp, "on.nck"), "rb").read() != open(
                    os.path.join(tmp, "off.nck"), "rb").read():
                raise AssertionError(f"telemetry {codec}: NCK bytes differ "
                                     "from the run with telemetry off")
            check_recon(np, f"telemetry {codec}", arrays, recon)
            check_keys(f"telemetry {codec}", on)
            missing = REF_SPANS[codec] - set(reg.span_names())
            if missing:
                raise AssertionError(f"telemetry {codec}: spans missing "
                                     f"{sorted(missing)}")
            roll = report.rollup(reg)
            log(f"telemetry {codec} rollup, ms per stage (count x mean = "
                "total): " + ", ".join(
                    f"{k} {v['count']}x{v['mean_s'] * 1e3:.2f}="
                    f"{v['total_s'] * 1e3:.1f}"
                    for k, v in sorted(roll["spans"].items())))
            ser = report.series_rollup(on)
            log(f"telemetry {codec} per-step record, series totals ms: "
                + json.dumps({k: round(v * 1e3, 2)
                              for k, v in ser["totals"].items()})
                + f"; bytes in {ser['bytes_in']}, out {ser['bytes_out']}, "
                f"entropy ratio mean {ser['entropy_ratio_mean']:.3f}; "
                f"NCK bytes identical to telemetry off; {card}")
            path = trace.write_chrome_trace(
                str(OUT / f"telemetry_{codec}.json"), reg)
            log(f"telemetry {codec}: Chrome trace {os.path.relpath(path, ROOT)}"
                f" ({len(reg.spans)} spans)")

            # The device idle share of one warm series (telemetry off: the
            # path users run), and with telemetry on (its stage syncs).
            for tele in (False, True):
                tag = f"{codec}{'_telemetry' if tele else ''}"
                acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
                torch.cuda.synchronize()
                reg = telemetry.start() if tele else None
                try:
                    with profile(activities=acts) as prof:
                        with record_function("chip_smoke.series"):
                            compress_series(arrays, p, chain="device",
                                            device=dev)
                            torch.cuda.synchronize()
                finally:
                    if tele:
                        telemetry.stop()
                tpath = str(OUT / f"profile_{tag}.json")
                prof.export_chrome_trace(tpath)
                share = idle_share(tpath, "chip_smoke.series")
                with open(tpath, "rb") as f, gzip.open(tpath + ".gz",
                                                       "wb") as g:
                    shutil.copyfileobj(f, g)
                os.remove(tpath)
                tpath += ".gz"
                log(f"device idle share, warm CMIP series, {tag}: "
                    f"{share['idle_share']:.4f} of a "
                    f"{share['window_ms']:.1f} ms window (kernels busy "
                    f"{share['kernel_busy_ms']:.2f} ms in "
                    f"{share['kernels']} kernels; idle counting copies as "
                    f"busy {share['idle_share_with_copies']:.4f}); top "
                    f"kernels ms {json.dumps(share['top_kernels_ms'])}; "
                    f"trace {os.path.relpath(tpath, ROOT)}; {card}")

    # Four shards at 64 KB blocks: the single-device key set.
    p = NumarckParams(error_bound=E, block_bytes=SHARD_BLOCK_BYTES)
    sc = ShardedCompressor([dev] * SHARDS, p)
    off = sc.compress_series(arrays)
    with telemetry.capture() as reg:
        on, got = counted(torch, ops.KERNELS,
                          lambda: sc.compress_series(arrays))
        ShardedDecompressor([dev] * SHARDS).decompress_series(on)
    sc.close()
    launches["telemetry sharded"] = got
    check_counts("telemetry sharded", got,
                 shard_launches(len(arrays), p, SHARDS))
    if [s.index_blocks for s in on] != [s.index_blocks for s in off]:
        raise AssertionError("telemetry sharded: blobs differ from the run "
                             "with telemetry off")
    check_keys("telemetry sharded", on)
    roll = report.rollup(reg)
    log(f"telemetry sharded x{SHARDS}, 64 KB blocks: per-step and per-read "
        "keys equal the single-device driver's; rollup ms: " + ", ".join(
            f"{k} {v['total_s'] * 1e3:.1f}"
            for k, v in sorted(roll["spans"].items())))

    # The entropy process pool, forked after CUDA has started: workers
    # run the codec's Python code only.
    entropy.register_codec(_GilXorCodec())
    raws = [np.random.default_rng(i).integers(0, 256, 1 << 19)
            .astype(np.uint8).tobytes() for i in range(8)]
    serial = entropy.compress_blocks(raws, codec=_GilXorCodec.name,
                                     parallel=False)
    t0 = time.perf_counter()
    pooled = entropy.compress_blocks(raws, codec=_GilXorCodec.name)
    pool_s = time.perf_counter() - t0
    if pooled != serial or entropy._proc_pool is None:
        raise AssertionError("entropy process pool: output differs from the "
                             "serial loop, or the pool was retired")
    entropy._proc_pool.shutdown(wait=True)
    entropy._proc_pool = None
    log(f"entropy process pool after CUDA init: {len(raws)} blocks of a "
        f"GIL-holding codec in {pool_s * 1e3:.1f} ms, identical to the "
        "serial loop")


def llama_tree(torch, dev, gen) -> dict:
    """Parameters and Adam moments of CKPT_LAYERS Llama-3.2-1B decoder
    layers at full width (float32, on the card, stacked on a leading
    layer dim), and an int step."""
    def layers(make):
        return {k: {n: make((CKPT_LAYERS,) + shape)
                    for n, shape in sub.items()}
                for k, sub in LLAMA_LAYER.items()}

    def normal(scale):
        return lambda shape: torch.randn(shape, generator=gen, device=dev) \
            * scale

    def second_moment(shape):
        g = torch.randn(shape, generator=gen, device=dev) * 1e-3
        return g * g + 1e-12

    return {"params": {"layers": layers(normal(0.02))},
            "opt": {"m": {"layers": layers(normal(1e-3))},
                    "v": {"layers": layers(second_moment)},
                    "step": 0}}


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_items(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_items(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def leaves_of(tree) -> dict:
    return dict(tree_items(tree))


def checkpoint_phase(torch, np, dev, launches: dict, tmp: str) -> dict:
    """CheckpointManager on the card: five async saves (anchor_every=4,
    device chain) of the parameters and Adam moments of CKPT_LAYERS
    full-width Llama-3.2-1B layers, each float leaf drifting by 1 % between saves.
    Kernels 1-4 once per lossy tensor per delta save; step files and
    manifest identical to the same saves with a host chain; restore_latest
    onto a "meta" template exact; then a byte of the newest file flipped.
    The files go under `tmp`; returns their directory, the parameters,
    the tree the walk-back must give (save 3's), the lossy keys and the
    newest restore's ms, for the elastic phase's walk-back."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.types import NumarckParams
    from repro_torch.kernels import ops
    from repro_torch.obs import report, telemetry

    card = card_line()
    exempt = ("scale", "step", "pos_map")
    gen = torch.Generator(device=dev).manual_seed(0)
    drift = torch.Generator(device=dev).manual_seed(1)
    first = llama_tree(torch, dev, gen)
    leaves = leaves_of(first)
    lossy = [k for k, v in leaves.items()
             if torch.is_tensor(v) and v.numel() >= 4096
             and not any(s in k for s in exempt)]
    n_vals = sum(v.numel() for v in leaves.values() if torch.is_tensor(v))

    def evolve(tree):
        def f(x):
            if torch.is_tensor(x):
                return x * (1 + 0.01 * torch.randn(
                    x.shape, generator=drift, device=dev))
            return x + 1
        return tree_map(f, tree)

    states = [first]
    for _ in range(CKPT_SAVES - 1):
        states.append(evolve(states[-1]))
    torch.cuda.synchronize()
    params = NumarckParams(error_bound=E)
    res = {}
    for chain in ("device", "host"):
        d = os.path.join(tmp, chain)
        mgr = CheckpointManager(d, params, anchor_every=4,
                                keep=CKPT_SAVES, async_save=True,
                                chain=chain, device=dev)
        call_ms = []

        def saves():
            futs = []
            for i, st in enumerate(states):
                t0 = time.perf_counter()
                futs.append(mgr.save(i, st))
                call_ms.append((time.perf_counter() - t0) * 1e3)
            mgr.wait()
            return [f.result() for f in futs]

        reg = telemetry.start()
        t0 = time.perf_counter()
        try:
            stats, got = counted(torch, ops.KERNELS, saves)
        finally:
            telemetry.stop()
        wall = time.perf_counter() - t0
        mgr.close()
        res[chain] = dict(dir=d, stats=stats, wall=wall, call_ms=call_ms,
                          reg=reg)
        # Kernels 1-3 per lossy tensor per delta save; the device
        # chain advances through kernel 4 too.
        deltas = sum(not s["anchor"] for s in stats)
        want = {k: deltas * len(lossy) for k in
                ("change_ratio", "hist", "bitpack", "dequant")}
        if chain == "host":
            want["dequant"] = 0
        check_counts(f"checkpoint {chain}", got, want)
        launches[f"checkpoint {chain}"] = got
    files = {c: {f: open(os.path.join(r["dir"], f), "rb").read()
                 for f in sorted(os.listdir(r["dir"]))}
             for c, r in res.items()}
    if files["device"] != files["host"]:
        raise AssertionError("checkpoint: step files differ between the "
                             "device and the host chain")
    r = res["device"]
    spans = report.rollup(r["reg"])["spans"]
    saves_ms = [s.duration * 1e3 for s in r["reg"].spans
                if s.name == "ckpt.save"]
    orig = sum(s["orig_bytes"] for s in r["stats"])
    comp = sum(s["comp_bytes"] for s in r["stats"])
    log(f"checkpoint: {CKPT_LAYERS} Llama-3.2-1B layers + Adam m, v "
        f"({len(leaves)} leaves, {n_vals} values, "
        f"{orig / CKPT_SAVES / 1e9:.3f} GB a save, {len(lossy)} lossy), "
        f"{CKPT_SAVES} async saves, anchor_every=4, chain device: launches"
        f" {json.dumps(launches['checkpoint device'])}; ms per save "
        f"(ckpt.save, worker) "
        + json.dumps([round(x, 1) for x in saves_ms])
        + ", save() call on the caller "
        + json.dumps([round(x, 1) for x in r["call_ms"]])
        + f", all {r['wall'] * 1e3:.1f} (host chain "
        f"{res['host']['wall'] * 1e3:.1f}; both under telemetry); CR "
        "per save "
        + json.dumps([round(s["ratio"], 3) for s in r["stats"]])
        + f", all {orig / comp:.3f}; ckpt.encode "
        f"{spans['ckpt.encode']['total_s'] * 1e3:.1f} ms, ckpt.write "
        f"{spans['ckpt.write']['total_s'] * 1e3:.1f} ms in all; step "
        f"files identical to the host chain's; {card}")

    # Restore the newest step (an anchor) onto a "meta" template.
    mgr = CheckpointManager(r["dir"], params, device=dev)
    template = tree_map(lambda x: torch.empty(x.shape, device="meta")
                        if torch.is_tensor(x) else x, states[-1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step, tree = mgr.restore_latest(template=template)
    torch.cuda.synchronize()
    t_latest = time.perf_counter() - t0
    if step != CKPT_SAVES - 1 or mgr.last_restore_report:
        raise AssertionError(f"checkpoint restore: step {step}, report "
                             f"{mgr.last_restore_report}")
    want_leaves = leaves_of(states[-1])
    for k, v in tree_items(tree):
        want = want_leaves[k]
        if torch.is_tensor(want):
            if v.device != want.device or not torch.equal(v, want):
                raise AssertionError(f"checkpoint restore: leaf {k} "
                                     "differs from the anchor's")
        elif v != want:
            raise AssertionError(f"checkpoint restore: {k} = {v}")
    del tree

    # A flipped byte in the newest file: the elastic phase's restore
    # walks back to the delta step.
    newest = os.path.join(r["dir"], f"step_{CKPT_SAVES - 1:08d}.nck")
    raw = bytearray(open(newest, "rb").read())
    raw[len(raw) // 2] ^= 0x40
    open(newest, "wb").write(bytes(raw))
    log(f"checkpoint restore ms: newest (anchor, onto a meta template) "
        f"{t_latest * 1e3:.1f}, exact; a byte of it flipped for the "
        f"walk-back; {card}")
    return dict(dir=r["dir"], params=params, want=states[-2], lossy=lossy,
                latest_ms=t_latest * 1e3)


ELASTIC_ARCH = "llama3.2-1b"        # the parameter rules' config


def elastic_phase(torch, np, dev, ck: dict, launches: dict) -> None:
    """The checkpoint phase's walk-back, through restore_elastic onto the
    (1, 1) ("data", "model") CUDA mesh of this one process with the full
    Llama-3.2-1B config's rules: the newest file's flipped byte walks the
    restore back one step (one report entry); no kernel (zlib decodes on
    the host); every tensor leaf a DTensor on the card with
    named_shardings' placements (some of them Shard), its full_tensor()
    bit-equal to the tree restore_elastic's own restore_latest gave,
    lossless leaves exact and lossy ones within the bound; the scalar
    leaf as it was.  One process: NCCL refuses two ranks on one card, and
    gloo takes CUDA tensors only for broadcast and all_reduce, so meshes
    of several ranks are held by the CPU tests over gloo."""
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.elastic import restore_elastic
    from repro_torch.configs import get_config
    from repro_torch.core.tree import leaves_with_keys
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.launch import distributed as ld
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.obs import report, telemetry

    cfg = get_config(ELASTIC_ARCH)
    want_leaves, lossy = leaves_of(ck["want"]), ck["lossy"]
    t0 = time.perf_counter()
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    mesh_ms = (time.perf_counter() - t0) * 1e3
    try:
        log("elastic: declared configuration: one process, the (1, 1) "
            "(data, model) cuda mesh over a one-rank gloo group")
        mgr = CheckpointManager(ck["dir"], ck["params"], device=dev)
        template = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                                  device="meta")
                            if torch.is_tensor(x) else x, ck["want"])
        inner = {}
        restore = mgr.restore_latest

        def timed(**kw):
            # restore_elastic's own restore_latest: its ms and its tree
            t1 = time.perf_counter()
            out = restore(**kw)
            torch.cuda.synchronize()
            inner.update(ms=(time.perf_counter() - t1) * 1e3, tree=out[1])
            return out
        mgr.restore_latest = timed
        with telemetry.capture() as reg:
            t0 = time.perf_counter()
            (step, tree), got = counted(torch, ops.KERNELS, lambda:
                                        restore_elastic(mgr, template, cfg,
                                                        mesh))
            ms = (time.perf_counter() - t0) * 1e3
        read_ms = {k: round(v["total_s"] * 1e3, 1) for k, v in
                   sorted(report.rollup(reg)["spans"].items())}
        if step != CKPT_SAVES - 2 or len(mgr.last_restore_report) != 1:
            raise AssertionError(f"elastic walk-back: step {step}, report "
                                 f"{mgr.last_restore_report}")
        check_counts("elastic", got, {})
        launches["elastic"] = got
        plain = leaves_of(inner.pop("tree"))
        ns = dict(leaves_with_keys(shd.named_shardings(ck["want"], cfg,
                                                       mesh)))
        kinds, sharded, worst, above = {}, 0, 0.0, 0
        for k, v in tree_items(tree):
            want = want_leaves[k]
            if not torch.is_tensor(want):
                if v != want or type(v) is not type(want):
                    raise AssertionError(f"elastic: scalar {k} = {v!r}")
                continue
            if not isinstance(v, DTensor):
                raise AssertionError(f"elastic: {k} is {type(v).__name__}")
            if (v.to_local().device.type != dev.type
                    or tuple(v.placements) != ns[k].placements):
                raise AssertionError(f"elastic: {k} on "
                                     f"{v.to_local().device}, placements "
                                     f"{v.placements}")
            sharded += any(p.is_shard() for p in v.placements)
            spec = str(ns[k].spec)
            kinds[spec] = kinds.get(spec, 0) + 1
            full = v.full_tensor()
            if not same_bits(torch, full, plain[k]):
                raise AssertionError(f"elastic: {k} differs from "
                                     "restore_latest's")
            if k not in lossy:
                if not torch.equal(full, want):
                    raise AssertionError(f"elastic walk-back: lossless "
                                         f"leaf {k} differs")
                continue
            rel = (full - want).abs() / want.abs()
            worst = max(worst, float(rel.max()))
            above += int((rel > E).sum())
        if not sharded:
            raise AssertionError("elastic: no leaf has a Shard placement")
        # Elementwise |recon - x| <= E |previous recon|: relative to x the
        # bound is E / (1 + r), under 1.1 E for 1 % drift (r > -9 %).
        if worst > 1.1 * E:
            raise AssertionError(f"elastic walk-back: max relative error "
                                 f"{worst:.3e} > 1.1 E")
    finally:
        ld.shutdown()
    log(f"elastic: a flipped byte walked restore_elastic back to step "
        f"{step} (anchor + {step} deltas) onto the (1, 1) cuda mesh "
        f"({mesh_ms:.1f} ms to make it) in {ms:.1f} ms, its restore_latest "
        f"{inner['ms']:.1f} ms (the newest anchor's {ck['latest_ms']:.1f}),"
        f" under telemetry, its spans ms {json.dumps(read_ms)}; report "
        f"{json.dumps(mgr.last_restore_report)[:160]}; launches "
        f"{json.dumps(got)}; {len(want_leaves)} leaves, {sharded} with a "
        f"Shard placement, specs {json.dumps(kinds)}; every full_tensor() "
        f"bit-equal to restore_latest's; lossless leaves exact, lossy max "
        f"relative error {worst:.3e} ({above} of "
        f"{sum(want_leaves[k].numel() for k in lossy)} values above E, "
        f"within E / (1 + r)); {card_line()}")


# The GPipe schedule (distributed/pipeline_parallel.py) on PIPE_STAGES gloo
# ranks of the one card: each stage PIPE_ARCH's decoder layers
# n_layers / PIPE_STAGES at full width in float32, PIPE_MICRO microbatches
# of (1, PIPE_SEQ, d_model) seeded hidden states.
PIPE_ARCH = "llama3.2-1b"
PIPE_STAGES, PIPE_MICRO, PIPE_SEQ = 2, 8, 256
PIPE_OUT_RTOL = 1e-4               # outputs against the sequential layers
PIPE_GRAD_RTOL = 1e-3              # a stage's gradient against its slice

_PIPE_WORKER = """
import dataclasses, json, time
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Shard
from torch.func import functional_call
from repro_torch.configs import get_config
from repro_torch.core.tree import leaves_with_keys, map_with_keys
from repro_torch.distributed.pipeline_parallel import pipeline_apply
from repro_torch.launch import distributed as ld
from repro_torch.models import layers as L, lm

t_start = time.perf_counter()
ld.initialize()
rank, P = dist.get_rank(), dist.get_world_size()
mesh = ld.global_mesh("pipe", device_type="cuda")
dev = torch.device("cuda")
cfg = dataclasses.replace(get_config("{arch}"), dtype="float32")
per = cfg.n_layers // P
M, T = {micro}, {seq}
positions = torch.arange(T, dtype=torch.int32, device=dev)


def layer_tree(i):
    # decoder layer i's weights, seeded by i, in the reference's layout
    layer = lm.Layer(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(1000 + i)
    with torch.no_grad():
        L.gqa_init(layer.attn, gen)
        L.ffn_init(layer.mlp, gen)
    one = lm.stack_layers((f"layers.0.{{n}}", p)
                          for n, p in layer.named_parameters())["layers"]
    return map_with_keys(lambda _, t: t[0], one)


def stacked(trees):
    return map_with_keys(lambda k, _: torch.stack(
        [dict(leaves_with_keys(t))[k] for t in trees]), trees[0])


class Stack(nn.Module):
    def __init__(self, n):
        super().__init__()
        self.layers = nn.ModuleList(lm.Layer(cfg, "meta") for _ in range(n))

    def forward(self, x):
        with L.matmul_numerics():
            for lp in self.layers:
                x, _ = lm.layer_apply(lp, x, cfg=cfg, positions=positions,
                                      window=0)
        return x


def run_layers(module, p, x):
    n = len(module.layers)
    return functional_call(module, {{
        f"layers.{{i}}.{{k.replace('/', '.')}}": v[i]
        for k, v in leaves_with_keys(p) for i in range(n)}}, (x,))


stage = Stack(per)
mine = stacked([layer_tree(i) for i in range(rank * per, (rank + 1) * per)])
params = map_with_keys(lambda _, t: DTensor.from_local(
    t[None], mesh, [Shard(0)], run_check=False).requires_grad_(), mine)
gen = torch.Generator(device=dev).manual_seed(7)
x = torch.randn((M, 1, T, cfg.d_model), generator=gen, device=dev)
leaves = [v for _, v in leaves_with_keys(params)]


def pipe_step():
    out = pipeline_apply(mesh, "pipe", lambda p, h: run_layers(stage, p, h),
                         params, x)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    grads = torch.autograd.grad((out * out).mean(), leaves)
    torch.cuda.synchronize()
    return out, grads, t1


t_setup = time.perf_counter() - t_start
pipe_step()                            # warm-up
dist.barrier()
t0 = time.perf_counter()
out, grads, t1 = pipe_step()
t2 = time.perf_counter()
res = dict(rank=rank, fwd_ms=(t1 - t0) * 1e3, bwd_ms=(t2 - t1) * 1e3,
           peak_gb=torch.cuda.max_memory_allocated() / 1e9, setup_s=t_setup)
keys = [k for k, _ in leaves_with_keys(params)]
if rank == 0:
    trees = [layer_tree(i) for i in range(cfg.n_layers)]
    full = map_with_keys(lambda _, t: t.requires_grad_(), stacked(trees))
    del trees
    seq = Stack(cfg.n_layers)
    fl = [v for _, v in leaves_with_keys(full)]

    def seq_step():
        y = run_layers(seq, full, x.reshape(M, T, cfg.d_model))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        g = torch.autograd.grad((y * y).mean(), fl)
        torch.cuda.synchronize()
        return y, g, t1

    seq_step()
    t0 = time.perf_counter()
    y, g_seq, t1 = seq_step()
    t2 = time.perf_counter()
    res.update(seq_fwd_ms=(t1 - t0) * 1e3, seq_bwd_ms=(t2 - t1) * 1e3,
               peak_gb_seq=torch.cuda.max_memory_allocated() / 1e9)
    res["out_rel"] = float((out.detach().reshape(y.shape) - y.detach())
                           .norm() / y.detach().norm())
    for r in range(1, P):
        for gs in g_seq:
            dist.send(gs[r * per:(r + 1) * per].detach().cpu().contiguous(),
                      r)
    want = [gs[:per] for gs in g_seq]
else:
    want = []
    for g in grads:
        buf = torch.empty(g.to_local().shape[1:], dtype=g.dtype)
        dist.recv(buf, 0)
        want.append(buf.to(dev))
num = sum(float((g.to_local()[0] - w).norm() ** 2)
          for g, w in zip(grads, want))
den = sum(float(w.norm() ** 2) for w in want)
res["grad_rel"] = (num / den) ** 0.5
res["grad_rel_worst"] = max(
    (float((g.to_local()[0] - w).norm() / w.norm()), k)
    for g, w, k in zip(grads, want, keys) if float(w.norm()) > 0)
res["n_params"] = sum(v.to_local().numel() for v in leaves)
res["worker_s"] = time.perf_counter() - t_start
ld.shutdown()
print("PIPE_RESULT " + json.dumps(res))
"""


def pipeline_phase(torch, np, dev) -> None:
    """pipeline_apply over PIPE_STAGES gloo ranks spawned on the one card
    (as the multi-process phase runs them): the GPipe schedule over
    Llama-3.2-1B's decoder layers at full width in float32, its forward
    within PIPE_OUT_RTOL of the same layers run in sequence on rank 0 and
    each stage's gradient within PIPE_GRAD_RTOL of the sequential
    gradient of its slice; ms of the pipelined forward and backward
    against the sequential ones."""
    from repro_torch.launch.distributed import check_spawned, spawn_emulated
    from repro_torch.launch.runtime_env import find_tcmalloc

    lib = find_tcmalloc()
    log(f"pipeline: declared configuration: {PIPE_STAGES} gloo ranks on "
        f"one card (NCCL refuses two ranks on one device), activations "
        f"and gradients staged through the host; the runtime preset "
        + (f"preloads {lib} into each rank" if lib else
           "finds no tcmalloc, so nothing is preloaded"))
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    res = spawn_emulated(PIPE_STAGES, ["-c", _PIPE_WORKER.format(
        arch=PIPE_ARCH, micro=PIPE_MICRO, seq=PIPE_SEQ)], base_env=env,
        timeout=300)
    spawn_s = time.perf_counter() - t0
    check_spawned(res)
    outs = [json.loads(r.stdout.split("PIPE_RESULT ")[1]) for r in res]
    head = outs[0]
    if not head["out_rel"] <= PIPE_OUT_RTOL:
        raise AssertionError(f"pipeline: outputs {head['out_rel']:.3e} from "
                             "the sequential layers")
    for o in outs:
        if not o["grad_rel"] <= PIPE_GRAD_RTOL:
            raise AssertionError(f"pipeline: stage {o['rank']}'s gradient "
                                 f"{o['grad_rel']:.3e} from the sequential "
                                 "one")
    log(f"pipeline: {PIPE_STAGES} stages of "
        f"{[o['n_params'] for o in outs]} float32 parameters, "
        f"{PIPE_MICRO} microbatches of (1, {PIPE_SEQ}, d): forward "
        f"{max(o['fwd_ms'] for o in outs):.1f} ms and backward "
        f"{max(o['bwd_ms'] for o in outs):.1f} ms (slowest rank) against "
        f"the sequential {head['seq_fwd_ms']:.1f} and "
        f"{head['seq_bwd_ms']:.1f} ms on rank 0; outputs "
        f"{head['out_rel']:.3e} relative, stage gradients "
        f"{[round(o['grad_rel'], 9) for o in outs]} (worst leaf "
        f"{[o['grad_rel_worst'] for o in outs]}); peak GB a rank after "
        f"the pipelined steps {[round(o['peak_gb'], 2) for o in outs]}, "
        f"on rank 0 after the sequential run too "
        f"{head['peak_gb_seq']:.2f}; {spawn_s:.1f} s with "
        f"process start (in the workers: setup "
        f"{[round(o['setup_s'], 1) for o in outs]} s, all "
        f"{[round(o['worker_s'], 1) for o in outs]} s); {card_line()}")


# Llama-3.2-1B (src/repro_torch/configs/llama3_2_1b.py) served at full width:
# SERVE_BATCH requests of SERVE_PROMPT tokens, SERVE_NEW new tokens, then
# SERVE_NEW resumed ones.
SERVE_ARCH = "llama3.2-1b"
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 256, 32
COS_MIN = 0.99                     # logits' cosine similarity, every position
F32_LAYERS = 2                     # layers in the bf16-vs-f32 check where the
                                   # whole model's f32 copy does not fit
# The MLA, MoE, SSM, hybrid and frontend families served the same way
# (label, arch, decoder layers kept, why the depth is cut, prompt tokens,
# requests in the rANS session round trip).  Mixtral's 32 layers are 93.4 GB of bf16
# weights: 16 of them (47.0 GB) fit one 80 GB card beside the caches.
# minicpm3-4b runs 31 of its 62 layers so that the whole run stays well
# inside its 1,200 s (a host-bound 1,029 s with all 62, PERF.md section 4).
# mamba2's 1,000 prompt tokens make three full SSD chunks of 256 and a
# padded fourth; hymba's 1,300 run past its 1,024-token window (the ring
# wraps on its 29 SWA layers) and pad its sixth chunk.  Every serve
# phase's rANS session round trip runs on one request (zlib on all
# four) for the run's time: the host rANS coder saves at 3-4 MB/s, and
# four requests' state is 42 MB (Llama) to 378 MB (musicgen).
RANS_CUT = ("rANS session round trip on 1 of 4 requests: the host rANS "
            "coder saves at ~4 MB/s (PERF.md)")
RANS_REQUESTS = 1
FAMILIES = (("serve_mla", "minicpm3-4b", 31,
             "31 of 62 layers: chip_smoke's time limit (PERF.md section 4)",
             SERVE_PROMPT, RANS_REQUESTS),
            ("serve_moe", "mixtral-8x7b", 16,
             "16 of 32 layers: 93.4 GB of bf16 weights do not fit one 80 GB "
             "card", SERVE_PROMPT, RANS_REQUESTS),
            ("serve_ssm", "mamba2-780m", None, None, 1000, RANS_REQUESTS),
            ("serve_hybrid", "hymba-1.5b", None, None, 1300, RANS_REQUESTS),
            ("serve_vlm", "paligemma-3b", None, None, 512, RANS_REQUESTS),
            ("serve_audio", "musicgen-medium", None, None, 256,
             RANS_REQUESTS))
# paligemma's Model-API requests: its n_prefix (256) patch embeds, then
# FRONT_TEXT text tokens; musicgen's: SERVE_PROMPT frame embeds.  The
# prefix-LM mask is held card against CPU on PREFIX_LAYERS layers in
# float32, at cosine >= PREFIX_COS_MIN at every position.
FRONT_TEXT = 256
PREFIX_LAYERS = 2
PREFIX_COS_MIN = 1 - 1e-5


def serve_config(arch: str = SERVE_ARCH, n_layers=None):
    """`arch`'s full config, its depth cut to `n_layers` where given."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg if n_layers is None else dataclasses.replace(
        cfg, n_layers=n_layers)


def same_bits(torch, a, b) -> bool:
    """Bit equality of two tensors (bf16 through an int16 view)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a.cpu(), b.cpu())


def cosines(torch, a, b):
    """Cosine similarity of two logits tensors at every position."""
    a = a.reshape(-1, a.shape[-1]).double()
    b = b.reshape(-1, b.shape[-1]).double()
    return (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))


def sdpa_yardstick(torch, dev, cfg, L, num: dict) -> dict:
    """The port's chunked_sdpa against torch's SDPA on the prefill's
    shapes (a yardstick; the port never calls SDPA): their ms, and the
    largest difference into `num`."""
    B, T = SERVE_BATCH, SERVE_PROMPT
    gen = torch.Generator(device=dev).manual_seed(2)
    dt = L.cdtype(cfg)
    q = torch.randn((B, T, cfg.n_heads, cfg.head_dim), generator=gen,
                    device=dev).to(dt)
    k = torch.randn((B, T, cfg.n_kv_heads, cfg.head_dim), generator=gen,
                    device=dev).to(dt)
    v = torch.randn(k.shape, generator=gen, device=dev).to(dt)
    positions = torch.arange(T, dtype=torch.int32, device=dev)
    rep = cfg.n_heads // cfg.n_kv_heads

    def ours():
        return L.chunked_sdpa(q, k, v, q_pos=positions, kv_pos=positions,
                              n_rep=rep, block_skip=True)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True).transpose(1, 2)

    with L.matmul_numerics():
        times = {"chunked_sdpa_ms": time_ms(torch, ours),
                 "sdpa_ms": time_ms(torch, sdpa)}
        num["max_abs_diff_chunked_vs_sdpa"] = float(
            (ours().float() - sdpa().float()).abs().max())
    return times


def moe_drops(torch, lm, L, params, cfg, tokens, s_max, label) -> dict:
    """The share of routed (token, slot) choices one prefill drops at the
    config's capacity factor (``moe_route``'s keep), and for each layer:
    its drop share, the busiest expert's share of the choices (1/E when
    balanced), the load-balance loss (top-k when balanced) and the
    coherence of the router's input, |mean_t x_t| / mean_t |x_t| per
    sequence (1 when every token's hidden state points one way)."""
    rows, kept = [], []
    route = L.moe_route
    E, k = cfg.n_experts, cfg.moe_top_k

    def recording(p, x, c):
        out = route(p, x, c)
        probs, top_e, keep = out[0], out[1], out[5]
        onehot = torch.nn.functional.one_hot(top_e, E)
        load = onehot.sum(2).float().mean(1) / k               # (B, E)
        xf = x.float()
        coh = xf.mean(1).norm(dim=-1) / xf.norm(dim=-1).mean(1)
        kept.append((int(keep.sum()), keep.numel()))
        rows.append({"drop_share": 1 - kept[-1][0] / kept[-1][1],
                     "busiest_expert_share": float(load.amax(-1).mean()),
                     "aux": float(L._load_balance_loss(probs, onehot, E)),
                     "coherence": float(coh.mean())})
        return out
    L.moe_route = recording
    try:
        lm.prefill(params, cfg, tokens, s_max=s_max)
    finally:
        L.moe_route = route
    n = sum(c for _, c in kept)
    out = {"moe_drop_share": 1 - sum(k for k, _ in kept) / n,
           "moe_cap": max(1, int(tokens.shape[1] * cfg.moe_top_k
                                 * cfg.capacity_factor / cfg.n_experts)),
           "moe_aux_mean": sum(r["aux"] for r in rows) / len(rows),
           "moe_layers": rows}
    log(f"{label}: the prefill drops {out['moe_drop_share']:.5f} of {n} "
        f"routed choices over {len(kept)} layers (capacity {out['moe_cap']} "
        f"a slot, factor {cfg.capacity_factor}); the seeded model's mean "
        f"aux {out['moe_aux_mean']:.5f}; by layer (drop share, busiest "
        f"expert's share, aux, coherence): "
        + json.dumps([[r["drop_share"], r["busiest_expert_share"], r["aux"],
                       r["coherence"]] for r in rows]))
    return out


def bf16_vs_f32(torch, lm, L, params, cfg, tokens, n_layers: int) -> dict:
    """bf16 forward logits against the same weights in f32, the first
    `n_layers` layers of both (embedding and head kept).  A MoE's f32
    run takes the bf16 run's routes at the config's capacity (experts,
    slot positions, kept choices; the f32 router's weights of those
    experts): under capacity drops a bf16 tie of the priority weights
    that f32 breaks otherwise keeps another choice, which is routing,
    not arithmetic.  The share of routed choices whose own f32 route
    (slot or keep) differs is reported."""
    cut = dataclasses.replace(cfg, n_layers=n_layers)

    def sub(c, cast):
        p = lm.LM(c, device="meta")
        p.load_state_dict({
            k: cast(v) for k, v in params.state_dict().items()
            if not k.startswith("layers.")
            or int(k.split(".")[1]) < n_layers}, assign=True)
        return p
    routes, differ = [], []
    route = L.moe_route

    def record(p, x, c):
        out = route(p, x, c)
        routes.append((out[1], out[2], out[4], out[5]))
        return out

    def replay(p, x, c):
        probs, _, slot_e, _, pos, keep, cap = route(p, x, c)
        r_top, r_slot, r_pos, r_keep = routes[len(differ)]
        differ.append(((slot_e != r_slot) | (keep != r_keep)).float().mean())
        top_p = torch.gather(probs, -1, r_top)
        top_p = (top_p / torch.sum(top_p, -1, keepdim=True)).to(x.dtype)
        slot_p = torch.repeat_interleave(top_p, c.moe_ep_split, dim=-1)
        return probs, r_top, r_slot, slot_p, r_pos, r_keep, cap
    try:
        L.moe_route = record
        logits16, _ = lm.forward(sub(cut, lambda v: v), cut, tokens)
        cut32 = dataclasses.replace(cut, dtype="float32")
        p32 = sub(cut32, lambda v: v.to(torch.float32))
        L.moe_route = replay
        logits32, _ = lm.forward(p32, cut32, tokens)
    finally:
        L.moe_route = route
    cos = cosines(torch, logits16, logits32)
    out = {"bf16_vs_f32_layers": n_layers,
           "cos_min_bf16_vs_f32": float(cos.min()),
           "max_abs_diff_bf16_vs_f32": float(
               (logits16 - logits32).abs().max())}
    if differ:
        out["moe_f32_route_differ_share"] = float(sum(differ) / len(differ))
    return out


def serve_phase(torch, np, dev, launches: dict, label: str = "serve",
                arch: str = SERVE_ARCH, n_layers=None, cut=None,
                prompt: int = SERVE_PROMPT,
                rans_batch: int = RANS_REQUESTS) -> dict:
    """A model and the serving engine at the arch's full width (bf16,
    seeded random weights made on the card; the depth cut to `n_layers`
    where `cut` says why): Llama-3.2-1B (dense GQA, 16 layers, the
    128,256 x 2048 tied embedding), and the FAMILIES, SERVE_BATCH
    requests of `prompt` tokens.  Greedy tokens of an uninterrupted
    generate equal generate + save_session + load_session (a new engine)
    + resume, with zlib and with rANS (rANS on the first `rans_batch`
    requests, against their own uninterrupted stream); every restored
    leaf equals the saved one bit for bit; the leaves on the rANS
    decode kernel's route are exactly those of at least
    rans.DEVICE_MIN_BYTES (the attention cache's k and v, MLA's latent
    ckv and krope, the SSD's state h and conv tail where they are that
    large), and load_session launches rans_decode once per (length,
    lanes) group of v1 blobs of each and no other kernel (none with
    zlib); the card's file loads on the CPU to the same bytes;
    decode_step at T against prefill of T + 1 at cosine >= COS_MIN at
    every position (a MoE with a drop-free capacity for this check).
    bf16 forward logits against the same weights in f32 at cosine >=
    COS_MIN (the whole model where its f32 copy fits, else the first
    F32_LAYERS layers; a MoE at the config's capacity, its f32 run on the
    bf16 routes).  MLA: the absorbed decode against the expanded
    mla_decode_naive on a step's logits.  MoE: the share of routed
    choices the prefill drops at the config's capacity factor, and each
    layer's drop share, expert load, aux and router-input coherence.  Times
    prefill, decode, save and load; for the dense model also the port's
    chunked_sdpa against torch's SDPA on the prefill's shapes (a
    yardstick; the port never calls SDPA)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.core import compress
    from repro_torch.core.container import NCKReader
    from repro_torch.kernels import ops, rans
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import Engine, load_cache

    card = card_line()
    cfg = serve_config(arch, n_layers)
    model = Model(cfg)
    B, T, NEW = SERVE_BATCH, prompt, SERVE_NEW
    s_max = T + 2 * NEW
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    params = model.init(0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)
    kv_bytes = sum(v.numel() * v.element_size() for _, v in tree_items(
        lm.empty_cache(cfg, B, s_max, device="meta")))
    shape = (f"MLA ranks q {cfg.q_lora_rank} kv {cfg.kv_lora_rank}, qk "
             f"{cfg.qk_nope_dim}+{cfg.qk_rope_dim}, v {cfg.v_head_dim}"
             if cfg.attn_kind == "mla" else f"heads of {cfg.head_dim}")
    moe = (f", {cfg.n_experts} experts top-{cfg.moe_top_k} split "
           f"{cfg.moe_ep_split}, capacity factor {cfg.capacity_factor}"
           if cfg.n_experts else "")
    if cfg.ssm_state:
        moe += (f", SSD {cfg.ssm_heads} heads of {cfg.ssm_head_dim}, state "
                f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}, conv "
                f"{cfg.conv_width}")
    if cfg.sliding_window:
        moe += (f", window {cfg.sliding_window} (global layers "
                f"{list(cfg.global_attn_layers)})")
    log(f"{label}: {cfg.name}, {cfg.n_layers} layers"
        f"{' (' + cut + ')' if cut else ''}, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, {shape}, d_ff {cfg.d_ff}"
        f"{moe}, vocab {cfg.vocab_size}, {cfg.dtype}: {n_params} "
        f"parameters, {w_bytes / 1e9:.3f} GB, made on the card in "
        f"{init_s:.1f} s; {B} requests x {T} prompt tokens, s_max {s_max}, "
        f"cache {kv_bytes / 1e6:.1f} MB")

    # Uninterrupted: 2 * NEW tokens (the reference stream), then the
    # timed warm prefill and decode, then one prefill and 8 decode steps
    # under torch.profiler for the device idle share.
    eng = Engine(model, params, B, s_max, keep_session=True, device=dev)
    full = eng.generate(prompts, max_new=2 * NEW)
    eng.stats = type(eng.stats)()
    warm = eng.generate(prompts, max_new=NEW)
    if not np.array_equal(warm, full[:, :NEW]):
        raise AssertionError(f"{label}: a second generate gave other "
                             "tokens")
    st = eng.stats
    times = {"prefill_ms": st.prefill_s * 1e3,
             "decode_ms_per_token": st.decode_s / NEW * 1e3,
             "tokens_per_s": st.tokens_per_s, "save_ms": {}, "load_ms": {}}
    OUT.mkdir(exist_ok=True)
    times["idle_share"] = {}
    for w, fn in (("prefill", lambda: eng.generate(prompts, max_new=0)),
                  ("decode", lambda: eng.resume(max_new=8))):
        tpath = str(OUT / f"profile_{label}_{w}.json")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(f"chip_smoke.{w}"):
                fn()
        prof.export_chrome_trace(tpath)
        share = idle_share(tpath, f"chip_smoke.{w}")
        with open(tpath, "rb") as f, gzip.open(tpath + ".gz", "wb") as g:
            shutil.copyfileobj(f, g)
        os.remove(tpath)
        times["idle_share"][w] = share["idle_share"]
        log(f"device idle share, {label} {w}: {share['idle_share']:.4f} of a "
            f"{share['window_ms']:.1f} ms window (kernels busy "
            f"{share['kernel_busy_ms']:.2f} ms in {share['kernels']} "
            f"kernels); top kernels ms {json.dumps(share['top_kernels_ms'])}"
            f"; trace {tpath}.gz; {card}")
    del eng

    tmp = tempfile.mkdtemp()
    for codec in ("zlib", "rans"):
        nb = rans_batch if codec == "rans" else B
        reqs, want_full = prompts[:nb], full
        if nb != B:
            # the requests' own uninterrupted stream at this batch size
            want_full = Engine(model, params, nb, s_max, device=dev
                               ).generate(reqs, max_new=2 * NEW)
        saver = Engine(model, params, nb, s_max, keep_session=True,
                       device=dev)
        first = saver.generate(reqs, max_new=NEW)
        path = os.path.join(tmp, f"session_{codec}.nck")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats, got = counted(torch, ops.KERNELS,
                             lambda: saver.save_session(path, codec=codec))
        times["save_ms"][codec] = (time.perf_counter() - t0) * 1e3
        check_counts(f"{label} save {codec}", got, {})
        saved = saver._session.to_host()
        del saver
        eng = Engine(model, params, nb, s_max, device=dev)
        eng.generate(reqs, max_new=1)               # records the template
        r = NCKReader(path)
        steps = [r.read_step(v) for v in r.step_names()]
        names = json.loads(bytes(r.read_array("__names__")).decode())
        routed = sorted(names[v] for v, st in zip(r.step_names(), steps)
                        if compress.device_decode_route(st))
        t0 = time.perf_counter()
        _, got = counted(torch, ops.KERNELS, lambda: eng.load_session(path))
        times["load_ms"][codec] = (time.perf_counter() - t0) * 1e3
        want = read_launches(steps)
        check_counts(f"{label} load {codec}", got, want)
        big = sorted(k for k, leaf in tree_items(saved)
                     if leaf.numel() * leaf.element_size()
                     >= rans.DEVICE_MIN_BYTES)
        if codec == "rans" and (routed != big or not any(
                k.startswith("cache/") for k in big)):
            raise AssertionError(f"{label} rans: the decode kernel's route "
                                 f"took {routed}, not the leaves of at "
                                 f"least {rans.DEVICE_MIN_BYTES} bytes "
                                 f"{big}")
        launches[f"{label} load {codec}"] = got
        restored = dict(tree_items(eng._session.tree))
        for key, leaf in tree_items(saved):
            if not same_bits(torch, restored[key], leaf):
                raise AssertionError(f"{label} {codec}: restored leaf {key} "
                                     "differs from the saved one")
            if restored[key].device != params.embed.device:
                raise AssertionError(f"{label} {codec}: {key} restored on "
                                     f"{restored[key].device}")
        cpu = dict(tree_items(load_cache(path, device="cpu")))
        for key, leaf in tree_items(saved):
            if not same_bits(torch, cpu[key], leaf):
                raise AssertionError(f"{label} {codec}: the CPU load of "
                                     f"{key} differs")
        rest = eng.resume(max_new=NEW)
        if not np.array_equal(np.concatenate([first, rest], axis=1),
                              want_full):
            raise AssertionError(f"{label} {codec}: generate + save + load "
                                 "+ resume differs from the uninterrupted "
                                 "stream")
        times.setdefault("session_bytes", {})[codec] = dict(
            orig=stats["orig_bytes"], comp=stats["comp_bytes"],
            requests=nb, device_route=routed)
        log(f"{label} {codec}, {nb} requests: {stats['orig_bytes']} bytes -> "
            f"{stats['comp_bytes']} ({stats['orig_bytes'] / stats['comp_bytes']:.3f}"
            f"x), save_session {times['save_ms'][codec]:.1f} ms, "
            f"load_session {times['load_ms'][codec]:.1f} ms, launches "
            f"{json.dumps(got)} (device route: {routed}); restored "
            f"bit-exact, the CPU load too; resume equal to the "
            f"uninterrupted {2 * NEW} tokens")
        del eng
    shutil.rmtree(tmp)

    tokens = torch.from_numpy(prompts.astype(np.int64)).to(dev)
    num = {}
    # bf16 against the same weights in f32: the whole model where its f32
    # copy fits beside it, else the first F32_LAYERS layers.
    fits = 2 * w_bytes < 0.3 * torch.cuda.get_device_properties(
        dev).total_memory
    num = bf16_vs_f32(torch, lm, L, params, cfg, tokens,
                      cfg.n_layers if fits else F32_LAYERS)
    torch.cuda.empty_cache()
    if num["cos_min_bf16_vs_f32"] < COS_MIN:
        raise AssertionError(f"{label} numerics: bf16 against f32 logits "
                             f"({num['bf16_vs_f32_layers']} layers), "
                             f"cosine {num['cos_min_bf16_vs_f32']:.5f}")
    # Teacher forcing: decode_step at T after a prefill of T tokens
    # against the last position of a prefill of T + 1 (a MoE at a
    # drop-free capacity: the prefill would drop choices decode keeps).
    chk = (dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                               / cfg.moe_top_k) if cfg.n_experts else cfg)
    nxt = torch.from_numpy(full[:, :1].astype(np.int64)).to(dev)
    _, cache, pos = lm.prefill(params, chk, tokens, s_max=s_max)
    if cfg.attn_kind == "mla":
        # the expanded decode from a copy of the same cache
        naive_cache = {"attn": {k: v.clone()
                                for k, v in cache["attn"].items()}}
        absorbed = L.mla_decode
        L.mla_decode = L.mla_decode_naive
        try:
            naive_logits, _ = lm.decode_step(params, chk, naive_cache, nxt,
                                             pos)
        finally:
            L.mla_decode = absorbed
        del naive_cache
    step_logits, _ = lm.decode_step(params, chk, cache, nxt, pos)
    pre_logits, _, _ = lm.prefill(params, chk,
                                  torch.cat([tokens, nxt], dim=1),
                                  s_max=s_max)
    cos = cosines(torch, step_logits, pre_logits)
    num["cos_min_decode_vs_prefill"] = float(cos.min())
    num["max_abs_diff_decode_vs_prefill"] = float(
        (step_logits - pre_logits).abs().max())
    if num["cos_min_decode_vs_prefill"] < COS_MIN:
        raise AssertionError(f"{label} numerics: decode_step against "
                             f"prefill, cosine "
                             f"{num['cos_min_decode_vs_prefill']:.5f}")
    if cfg.attn_kind == "mla":
        cos = cosines(torch, step_logits, naive_logits)
        num["cos_min_absorbed_vs_naive"] = float(cos.min())
        num["max_abs_diff_absorbed_vs_naive"] = float(
            (step_logits - naive_logits).abs().max())
        del naive_logits
        if num["cos_min_absorbed_vs_naive"] < COS_MIN:
            raise AssertionError(f"{label} numerics: the absorbed MLA decode "
                                 f"against mla_decode_naive, cosine "
                                 f"{num['cos_min_absorbed_vs_naive']:.5f}")
    del cache, step_logits, pre_logits
    if cfg.n_experts:
        num.update(moe_drops(torch, lm, L, params, cfg, tokens, s_max, label))
    if cfg.frontend:
        api = frontend_api(torch, dev, lm, model, params, label)
        times["model_api"] = api.pop("times")
        num.update(api)
    if cfg.n_prefix:
        num.update(prefix_check(torch, lm, params, cfg, label))
    if cfg.attn_kind == "gqa" and not (cfg.n_experts or cfg.ssm_state
                                       or cfg.frontend):
        times.update(sdpa_yardstick(torch, dev, cfg, L, num))
    out = dict(arch=cfg.name, layers=cfg.n_layers,
               layers_full=serve_config(arch).n_layers, depth_cut=cut,
               rans_requests=rans_batch,
               rans_cut=RANS_CUT if rans_batch != B else None,
               params=n_params, weight_bytes=w_bytes,
               batch=B, prompt=T, new=NEW, s_max=s_max, kv_bytes=kv_bytes,
               **times, **num,
               peak_device_bytes=torch.cuda.max_memory_allocated(),
               phase_s=time.perf_counter() - t_phase, card=card)
    log(f"{label} " + json.dumps(out))
    return out


def frontend_api(torch, dev, lm, model, params, label) -> dict:
    """The frontend's own inputs through the Model API on the card:
    SERVE_BATCH requests of seeded embeddings in the compute dtype
    (paligemma: its n_prefix patch embeds and FRONT_TEXT text tokens;
    musicgen: SERVE_PROMPT frames), one prefill and SERVE_NEW decode
    steps (paligemma: greedy tokens through decode_step(token=), the
    port's scaled token path; musicgen: seeded frames through
    decode_step(embed=)), twice: the second run timed (host clock,
    synchronised) and its tokens equal to the first's; every logit
    finite.  Then decode_step after a prefill against the last position
    of a prefill over the input plus that step (the token or the frame)
    at cosine >= COS_MIN; for paligemma also the reference's unscaled
    token lookup against the same prefill (its decode fault, measured,
    not held)."""
    cfg = model.cfg
    B, NEW = SERVE_BATCH, SERVE_NEW
    gen = torch.Generator(device=dev).manual_seed(3)
    dt = getattr(torch, cfg.dtype)
    patches = cfg.frontend == "patches"
    n_emb = cfg.n_prefix if patches else SERVE_PROMPT
    batch = {"embeds": torch.randn((B, n_emb, cfg.d_model), generator=gen,
                                   device=dev, dtype=dt)}
    if patches:
        batch["tokens"] = torch.randint(0, cfg.vocab_size, (B, FRONT_TEXT),
                                        generator=gen, device=dev)
    T = n_emb + (FRONT_TEXT if patches else 0)
    s_max = T + NEW + 1
    frames = torch.randn((NEW + 1, B, 1, cfg.d_model), generator=gen,
                         device=dev, dtype=dt)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache, pos = model.prefill(params, batch, s_max=s_max)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        toks, finite = [], bool(torch.isfinite(logits).all())
        for i in range(NEW):
            if patches:
                tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
                toks.append(tok)
                logits, cache = model.decode(params, cache, token=tok,
                                             pos=pos)
            else:
                logits, cache = model.decode(params, cache, pos=pos,
                                             embed=frames[i])
            finite &= bool(torch.isfinite(logits).all())
            pos = pos + 1
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        toks = torch.cat(toks, 1).cpu() if toks else logits.cpu()
        return toks, finite, (t1 - t0) * 1e3, (t2 - t1) / NEW * 1e3

    first, ok1, _, _ = run()
    again, ok2, pre_ms, dec_ms = run()
    if not (ok1 and ok2):
        raise AssertionError(f"{label} model API: logits not finite")
    if not torch.equal(first, again):
        raise AssertionError(f"{label} model API: a second run differs")

    logits, cache, pos = model.prefill(params, batch, s_max=s_max)
    if patches:
        nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
        longer = dict(batch, tokens=torch.cat([batch["tokens"], nxt], 1))
        step, _ = model.decode(params, cache, token=nxt, pos=pos)
    else:
        longer = {"embeds": torch.cat([batch["embeds"], frames[NEW]], 1)}
        step, _ = model.decode(params, cache, pos=pos, embed=frames[NEW])
    del cache
    full, _, _ = model.prefill(params, longer, s_max=s_max)
    cos = cosines(torch, step, full)
    out = {"times": {"prefill_ms": pre_ms, "decode_ms_per_step": dec_ms,
                     "inputs": {k: list(v.shape) for k, v in batch.items()}},
           "cos_min_api_decode_vs_prefill": float(cos.min()),
           "max_abs_diff_api_decode_vs_prefill": float(
               (step - full).abs().max())}
    if patches:
        _, cache, pos = model.prefill(params, batch, s_max=s_max)
        raw = params.embed.to(dt)[nxt]                 # unscaled
        ref_step, _ = model.decode(params, cache, pos=pos, embed=raw)
        out["cos_min_unscaled_token_decode_vs_prefill"] = float(
            cosines(torch, ref_step, full).min())
        del cache, ref_step
    del step, full, logits
    if out["cos_min_api_decode_vs_prefill"] < COS_MIN:
        raise AssertionError(f"{label} model API: decode_step("
                             f"{'token' if patches else 'embed'}=) against "
                             "prefill, cosine "
                             f"{out['cos_min_api_decode_vs_prefill']:.5f}")
    log(f"{label} model API: {B} x {json.dumps(out['times']['inputs'])}, "
        f"prefill {pre_ms:.1f} ms, decode {dec_ms:.2f} ms a step "
        f"({NEW} steps through decode_step("
        f"{'token' if patches else 'embed'}=)), every logit finite; decode "
        f"against prefill cosine {out['cos_min_api_decode_vs_prefill']:.5f}"
        + (f"; the reference's unscaled token lookup "
           f"{out['cos_min_unscaled_token_decode_vs_prefill']:.5f}"
           if patches else ""))
    return out


def prefix_check(torch, lm, params, cfg, label) -> dict:
    """The prefix-LM mask on the card against the port's CPU path: the
    first PREFIX_LAYERS layers (embedding and head kept) in float32, one
    request of n_prefix seeded patch embeds and FRONT_TEXT tokens, the
    logits at cosine >= PREFIX_COS_MIN at every position; and the same
    layers under a causal mask (n_prefix 0) differ over the patches."""
    cut = dataclasses.replace(cfg, n_layers=PREFIX_LAYERS, dtype="float32")

    def sub(device):
        p = lm.LM(cut, device="meta")
        p.load_state_dict({
            k: v.to(device, torch.float32)
            for k, v in params.state_dict().items()
            if not k.startswith("layers.")
            or int(k.split(".")[1]) < PREFIX_LAYERS}, assign=True)
        return p
    gen = torch.Generator().manual_seed(4)
    emb = torch.randn((1, cfg.n_prefix, cfg.d_model), generator=gen)
    tok = torch.randint(0, cfg.vocab_size, (1, FRONT_TEXT), generator=gen)
    dev = params.embed.device
    card, _ = lm.forward(sub(dev), cut, tok.to(dev), emb.to(dev))
    causal, _ = lm.forward(sub(dev), dataclasses.replace(cut, n_prefix=0),
                           tok.to(dev), emb.to(dev))
    cpu, _ = lm.forward(sub("cpu"), cut, tok, emb)
    cos = cosines(torch, card.cpu(), cpu)
    moved = float((card - causal)[:, :cfg.n_prefix].abs().max())
    out = {"prefix_layers": PREFIX_LAYERS,
           "cos_min_prefix_card_vs_cpu": float(cos.min()),
           "max_abs_diff_prefix_card_vs_cpu": float(
               (card.cpu() - cpu).abs().max()),
           "max_abs_diff_prefix_vs_causal": moved}
    del card, causal, cpu
    if out["cos_min_prefix_card_vs_cpu"] < PREFIX_COS_MIN or not moved > 0:
        raise AssertionError(f"{label} prefix mask: " + json.dumps(out))
    log(f"{label} prefix mask, {PREFIX_LAYERS} layers f32, {cfg.n_prefix} "
        f"patches + {FRONT_TEXT} tokens: card against CPU cosine "
        f"{out['cos_min_prefix_card_vs_cpu']:.7f} (max abs diff "
        f"{out['max_abs_diff_prefix_card_vs_cpu']:.3e}); against a causal "
        f"mask the patch positions move by up to {moved:.3e}")
    return out


# Llama-3.2-1B trained at full width and depth: TRAIN_BATCH x TRAIN_SEQ
# TokenPipeline tokens a step, TRAIN_STEPS steps a run (compression off,
# then B = TRAIN_BITS), then TRAIN_PROFILED more under torch.profiler.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_PROFILED = 4, 256, 8, 3
TRAIN_BITS = 6
TRAIN_LR, TRAIN_WARMUP = 1e-3, 2
LOSS_DROP = 1.0                    # nats, step 1 -> step TRAIN_STEPS (PERF.md)
GRAD_LEAVES = ("layers/attn/wk", "layers/attn/wo", "layers/ln_attn/scale",
               "ln_f/scale")       # real gradients, card against the CPU
# The restart run: full width, depth cut to RESTART_LAYERS decoder layers
# (the tied embedding kept; one layer for the run's 1,200 s, PERF.md
# section 4); checkpoints every 2 steps, an anchor at 2 and a delta at 4,
# a crash, a restore and steps 5-6.
RESTART_LAYERS, RESTART_E = 1, 1e-4
RESTART_LOSS_RTOL = 1e-3           # resumed against uninterrupted (PERF.md)
STEP_LOSS_RTOL = 1e-5              # one f32 smoke step, card against CPU
# The MLA, MoE, SSM and hybrid families trained at full width.  The MLA
# and MoE depths are cut to fit the optimizer state (about 18 bytes a
# parameter: bf16 weights and grads, the stacked grads, f32 m, v and
# residual): minicpm3-4b's 16 of 62 layers (1.38 G parameters, ~25 GB),
# mixtral-8x7b's 1 of 32 (1.71 G, ~31 GB; 2 layers would be ~57 GB before
# activations).  mamba2-780m (0.78 G, ~14 GB) and hymba-1.5b (1.39 G, ~25
# GB) run uncut (None: every layer).  Each runs TRAIN_FAMILY_STEPS steps at
# B = TRAIN_BITS; `leaf`'s real gradient goes through quantize_dequantize
# on the card and on the CPU (hymba's A_log: the leaf whose gradient the
# reference's SSD makes NaN at chunk 256).  The last item is the sequence
# length: the frontends train on Model.sample_batch batches, paligemma's
# 256 patch embeds and 256 text tokens (2.51 G parameters, ~45 GB of
# state; its (4, 512, 257,216) float32 logits alone are 2.1 GB) and
# musicgen's 256 frames (1.82 G, ~33 GB, remat="block").
TRAIN_FAMILIES = (("minicpm3-4b", 16, "layers/attn/wkv_a", 256),
                  ("mixtral-8x7b", 1, "layers/mlp/we_down", 256),
                  ("mamba2-780m", None, "layers/ssm/in_proj", 256),
                  ("hymba-1.5b", None, "layers/ssm/A_log", 256),
                  ("paligemma-3b", None, "embed", 512),
                  ("musicgen-medium", None, "layers/mlp/w_up", 256))
TRAIN_FAMILY_STEPS = 4


def train_config(bits: int, **kw):
    from repro_torch.train import optim
    from repro_torch.train.trainer import TrainerConfig
    return TrainerConfig(opt=optim.AdamWConfig(
        lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, decay_steps=1000),
        grad_compression_bits=bits, **kw)


def quiet(*_):
    pass


def train_phase(torch, np, dev, launches: dict) -> dict:
    """Training on the card (Trainer.fit through launch/train.py's
    pieces).  (1) Llama-3.2-1B at full width and depth, bf16, seeded on
    the card: TRAIN_STEPS steps with gradient compression off and at
    B = TRAIN_BITS from the same seed; finite losses that fall by
    LOSS_DROP; the histogram kernel once per compressed leaf per step and
    no other kernel; step ms, tokens/s, peak memory and the device idle
    share of TRAIN_PROFILED warm steps.  (2) quantize_dequantize on real
    gradients on the card against the CPU path, bit for bit; one step of
    the reduced f32 config on the card against the CPU.  (3) A restart
    at full width cut to RESTART_LAYERS layers: an anchor at step 2, a
    delta at 4 through kernels 1-4 once per lossy leaf, a new Trainer
    restores step 4 (the step exact, moments within E of the anchor's)
    and trains steps 5-6 to the uninterrupted run's losses.  (4) The
    TRAIN_FAMILIES (``family_train``)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch import interop
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.tree import leaves_with_keys
    from repro_torch.core.types import NumarckParams
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import hist, ops
    from repro_torch.models.model import Model, build
    from repro_torch.train import gradcomp, optim
    from repro_torch.train.trainer import Trainer, loss_and_grads

    card = card_line()
    K = ops.KERNELS
    t_phase = time.perf_counter()
    cfg = serve_config()
    model = Model(cfg)
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_SEQ + 1, TRAIN_BATCH, seed=0)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out = dict(arch=cfg.name, params=model.param_count(), batch=TRAIN_BATCH,
               seq=TRAIN_SEQ, steps=TRAIN_STEPS, lr=TRAIN_LR, runs={})
    grads = None
    for bits in (0, TRAIN_BITS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer(model, train_config(bits), device=dev)
        t0 = time.perf_counter()
        state = tr.init_state(0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_leaves = len(list(leaves_with_keys(state.params)))
        (state, step, losses), got = counted(torch, K, lambda: tr.fit(
            state, pipe.from_step(0), n_steps=TRAIN_STEPS, log=quiet))
        label = f"train B={bits}"
        check_counts(label, got, {"hist": TRAIN_STEPS * n_leaves}
                     if bits else {})
        launches[label] = got
        if not all(np.isfinite(losses)) or \
                losses[-1] > losses[0] - LOSS_DROP:
            raise AssertionError(f"{label}: losses {losses} do not fall by "
                                 f"{LOSS_DROP}")
        step_ms = statistics.median(tr._times[1:]) * 1e3
        peak = torch.cuda.max_memory_allocated()
        tpath = str(OUT / f"profile_train_b{bits}.json")
        OUT.mkdir(exist_ok=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("chip_smoke.train"):
                state, step, more = tr.fit(
                    state, pipe.from_step(step), start_step=step,
                    n_steps=step + TRAIN_PROFILED, log=quiet)
                torch.cuda.synchronize()
        prof.export_chrome_trace(tpath)
        share = idle_share(tpath, "chip_smoke.train")
        with open(tpath, "rb") as f, gzip.open(tpath + ".gz", "wb") as g:
            shutil.copyfileobj(f, g)
        os.remove(tpath)
        run = dict(losses=losses, profiled_losses=more, init_s=init_s,
                   step_ms=step_ms, first_step_ms=tr._times[0] * 1e3,
                   step_ms_all=[round(t * 1e3, 2) for t in tr._times],
                   tokens_per_s=tokens / step_ms * 1e3,
                   peak_device_bytes=peak, idle_share=share["idle_share"],
                   idle_window_ms=share["window_ms"],
                   kernels_in_window=share["kernels"],
                   top_kernels_ms=share["top_kernels_ms"], launches=got)
        out["runs"][f"B={bits}"] = run
        log(f"train {cfg.name} full width, {cfg.n_layers} layers, "
            f"{cfg.dtype}, {out['params']} parameters, {TRAIN_BATCH} x "
            f"{TRAIN_SEQ} tokens, gradient compression "
            f"{'B=' + str(bits) if bits else 'off'}: losses "
            f"{[round(x, 4) for x in losses]}, step {step_ms:.1f} ms "
            f"(median of steps 2-{TRAIN_STEPS}; the first "
            f"{run['first_step_ms']:.1f}), {run['tokens_per_s']:.0f} "
            f"tokens/s, peak {peak / 1e9:.2f} GB, launches {json.dumps(got)}"
            f"; device idle share {share['idle_share']:.4f} of "
            f"{share['window_ms']:.1f} ms ({TRAIN_PROFILED} steps, "
            f"{share['kernels']} kernels, busy "
            f"{share['kernel_busy_ms']:.1f} ms); top kernels ms "
            f"{json.dumps(share['top_kernels_ms'])}; trace {tpath}.gz; "
            f"{card}")
        if not bits:
            # real gradients of the trained model, for (2)
            _, _, g = loss_and_grads(model, state.params, {
                k: torch.as_tensor(v, device=dev)
                for k, v in pipe.batch(step).items()})
            flat = dict(leaves_with_keys(g))
            grads = {k: flat[k].float() for k in GRAD_LEAVES}
            del g, flat
        del tr, state
        torch.cuda.empty_cache()

    # -- (2) the card against the CPU -------------------------------------
    rows = {}
    for key, g in grads.items():
        hist.KERNEL.launches = 0
        got, ginfo = gradcomp.quantize_dequantize(g, b_bits=TRAIN_BITS)
        torch.cuda.synchronize()
        n_launch = hist.KERNEL.launches
        want, winfo = gradcomp.quantize_dequantize(g.cpu(),
                                                   b_bits=TRAIN_BITS)
        if n_launch != 1 or not torch.equal(
                got.cpu().view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"train gradcomp {key}: the card differs "
                                 f"from the CPU ({n_launch} launches)")
        a, b = float(ginfo["alpha"]), float(winfo["alpha"])
        if abs(a - b) > 1e-6 * max(abs(b), 1e-30):
            raise AssertionError(f"train gradcomp {key}: alpha {a} vs {b}")
        rows[key] = dict(n=g.numel(), alpha=a, alpha_cpu=b)
    del grads
    out["gradcomp_card_vs_cpu"] = rows
    smoke = build(SERVE_ARCH, smoke=True)
    cpu_tr = Trainer(smoke, train_config(TRAIN_BITS), device="cpu")
    card_tr = Trainer(smoke, train_config(TRAIN_BITS), device=dev)
    cpu_s = cpu_tr.init_state(0)
    card_s = interop.train_state_from_reference(
        interop.train_state_to_reference(cpu_s), smoke.cfg, device=dev)
    sp = TokenPipeline(smoke.cfg.vocab_size, 65, 4, seed=1)
    cpu_s, _, want = cpu_tr.fit(cpu_s, sp.from_step(0), n_steps=1,
                                log=quiet)
    card_s, _, got = card_tr.fit(card_s, sp.from_step(0), n_steps=1,
                                 log=quiet)
    lr1 = float(optim.schedule(train_config(0).opt, torch.tensor(1)))
    card_p = dict(leaves_with_keys(interop.train_state_to_reference(card_s)))
    worst = max(float(np.abs(card_p[k] - w).max()) for k, w in
                leaves_with_keys(interop.train_state_to_reference(cpu_s))
                if k.startswith("params/"))
    if abs(got[0] - want[0]) > STEP_LOSS_RTOL * abs(want[0]) \
            or worst > 2 * lr1 * 1.001:
        raise AssertionError(f"train smoke step: card loss {got[0]} vs cpu "
                             f"{want[0]}, params max diff {worst}")
    out["smoke_step"] = dict(loss_card=got[0], loss_cpu=want[0],
                             params_max_abs_diff=worst, lr=lr1)
    log(f"train card against CPU: quantize_dequantize B={TRAIN_BITS} on "
        f"real gradients bit-exact, one histogram launch each, "
        f"{json.dumps(rows)}; one {smoke.cfg.name} smoke (f32) step: loss "
        f"{got[0]:.7f} card, {want[0]:.7f} CPU, params max abs diff "
        f"{worst:.3e} (bound 2 lr = {2 * lr1:.1e})")

    # -- (3) restart: an anchor at 2, a delta at 4, crash, restore --------
    cut = dataclasses.replace(cfg, n_layers=RESTART_LAYERS)
    rmodel = Model(cut)
    tcfg = train_config(0, checkpoint_every=2)
    tmp = tempfile.mkdtemp()
    params = NumarckParams(error_bound=RESTART_E)
    save_ms = {}

    def manager():
        mgr = CheckpointManager(tmp, params, anchor_every=2, chain="device",
                                device=dev)
        save = mgr.save

        def timed(step, tree, blocking=None):
            t0 = time.perf_counter()
            r = save(step, tree, blocking)
            torch.cuda.synchronize()
            save_ms[step] = (time.perf_counter() - t0) * 1e3
            return r
        mgr.save = timed
        return mgr

    tr = Trainer(rmodel, tcfg, checkpoint_manager=manager(), device=dev)
    state = tr.init_state(0)
    state, step, first = tr.fit(state, pipe.from_step(0), n_steps=2,
                                log=quiet)
    tree = dict(leaves_with_keys(state.tree()))
    lossy = [k for k, v in tree.items() if v.dtype == torch.float32
             and v.numel() >= 4096 and not any(s in k for s in
                                               ("scale", "step"))]
    anchor = {k: tree[k].clone() for k in lossy}
    save_bytes = sum(v.numel() * v.element_size() for v in tree.values())
    (state, step, more), got = counted(torch, K, lambda: tr.fit(
        state, pipe.from_step(2), start_step=2, n_steps=4, log=quiet))
    check_counts("train restart delta save", got,
                 {k: len(lossy) for k in ("change_ratio", "hist", "bitpack",
                                          "dequant")})
    launches["train restart delta save"] = got
    live = {k: v.clone() for k, v in leaves_with_keys(state.tree())}
    tr.ckpt.close()
    del tr, state, tree
    torch.cuda.empty_cache()
    # the crash: a new Trainer on the same directory
    tr2 = Trainer(rmodel, tcfg, checkpoint_manager=manager(), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (restored, start), got = counted(torch, K, lambda: tr2.restore_or_init(
        7))
    restore_ms = (time.perf_counter() - t0) * 1e3
    launches["train restart restore"] = got
    if start != 4 or tr2.ckpt.last_restore_report:
        raise AssertionError(f"train restart: restored step {start}, report "
                             f"{tr2.ckpt.last_restore_report}")
    worst = 0.0
    for k, v in leaves_with_keys(restored.tree()):
        want = live[k]
        if v.dtype != want.dtype or v.shape != want.shape or \
                v.device != want.device:
            raise AssertionError(f"train restart: {k} restored as "
                                 f"{v.dtype} {tuple(v.shape)} {v.device}")
        if k not in lossy:
            if not same_bits(torch, v, want):
                raise AssertionError(f"train restart: lossless {k} differs")
            continue
        # |recon - x| <= E |previous recon| elementwise (the anchor's
        # leaf), and an ulp or two of x for the float32 reconstruction
        err = (v - want).abs()
        lim = RESTART_E * anchor[k].abs() * 1.01 + want.abs() * 2.4e-7
        if bool((err > lim).any()):
            raise AssertionError(f"train restart: {k} outside E |prev|")
        worst = max(worst, float((err / anchor[k].abs().clamp_min(
            1e-30)).max()))
    if int(restored.opt_state.step) != 4:
        raise AssertionError("train restart: the step leaf is not 4")
    del live, anchor
    tr2.ckpt.close()
    tr2.ckpt = None                    # steps 5-6 need no checkpoint
    restored, step, resumed = tr2.fit(restored, pipe.from_step(4),
                                      start_step=4, n_steps=6, log=quiet)
    del restored, tr2
    torch.cuda.empty_cache()
    full_tr = Trainer(rmodel, tcfg, device=dev)
    _, _, full = full_tr.fit(full_tr.init_state(0), pipe.from_step(0),
                             n_steps=6, log=quiet)
    del full_tr
    shutil.rmtree(tmp)
    diff = max(abs(a - b) / abs(b) for a, b in zip(resumed, full[4:]))
    if step != 6 or diff > RESTART_LOSS_RTOL:
        raise AssertionError(f"train restart: resumed losses {resumed} vs "
                             f"uninterrupted {full[4:]}")
    out["restart"] = dict(
        layers=RESTART_LAYERS, save_bytes=save_bytes, lossy=len(lossy),
        save_ms=save_ms, restore_ms=restore_ms, losses_first=first + more,
        losses_uninterrupted=full, losses_resumed=resumed,
        max_rel_loss_diff=diff, max_err_over_prev=worst,
        delta_launches=launches["train restart delta save"],
        restore_launches=got)
    log(f"train restart: {cut.name} cut to {RESTART_LAYERS} layers, "
        f"{save_bytes / 1e9:.3f} GB a save ({len(lossy)} lossy leaves), "
        f"save ms {json.dumps({k: round(v, 1) for k, v in save_ms.items()})}"
        f" (2: anchor, 4: delta, launches "
        f"{json.dumps(launches['train restart delta save'])}), restore of "
        f"step 4 {restore_ms:.1f} ms (launches {json.dumps(got)}), lossy "
        f"leaves within E |anchor| (max {worst:.3e}); losses first "
        f"{[round(x, 5) for x in first + more]}, resumed "
        f"{[round(x, 5) for x in resumed]}, uninterrupted "
        f"{[round(x, 5) for x in full]} (max rel diff {diff:.2e}); {card}")
    out["peak_device_bytes"] = max(r["peak_device_bytes"]
                                   for r in out["runs"].values())

    # -- (4) the MLA, MoE, SSM, hybrid and frontend families --------------
    out["families"] = {arch: family_train(torch, np, dev, launches, arch,
                                          n_layers, leaf, card, seq)
                       for arch, n_layers, leaf, seq in TRAIN_FAMILIES}
    out["phase_s"] = time.perf_counter() - t_phase
    out["card"] = card
    log("train " + json.dumps(out))
    return out


def family_train(torch, np, dev, launches: dict, arch: str, n_layers,
                 leaf: str, card: str, seq: int = TRAIN_SEQ) -> dict:
    """`arch` at full width, `n_layers` decoder layers (None: all), bf16,
    seeded on the card, on TRAIN_BATCH x `seq` TokenPipeline tokens (a
    frontend: Model.sample_batch batches of embeds and tokens, made on the
    card from a seeded generator): TRAIN_FAMILY_STEPS steps of Trainer.fit with
    gradient compression at B = TRAIN_BITS (the histogram kernel once per
    leaf -- 3-D MLA projections, slot-wise expert stacks and the SSD's
    leaves among them -- per step, no other kernel), finite losses; on
    the next batch every gradient leaf finite and the MoE's aux loss
    finite and > 0; that batch's gradient of `leaf` through
    quantize_dequantize on the card (one histogram launch) and on the
    CPU, bit for bit.  Step ms, tokens/s, peak memory."""
    from repro_torch.core.tree import leaves_with_keys
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import hist, ops
    from repro_torch.models.model import Model
    from repro_torch.train import gradcomp
    from repro_torch.train.trainer import Trainer, loss_and_grads

    cfg = serve_config(arch, n_layers)
    model = Model(cfg)
    label = f"train {arch} B={TRAIN_BITS}"
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if cfg.frontend:
        gen = torch.Generator(device=dev).manual_seed(0)
        batches = [model.sample_batch(gen, TRAIN_BATCH, seq)
                   for _ in range(TRAIN_FAMILY_STEPS + 1)]
    else:
        pipe = TokenPipeline(cfg.vocab_size, seq + 1, TRAIN_BATCH, seed=0)
        batches = [pipe.batch(i) for i in range(TRAIN_FAMILY_STEPS + 1)]
    tr = Trainer(model, train_config(TRAIN_BITS), device=dev)
    state = tr.init_state(0)
    n_leaves = len(list(leaves_with_keys(state.params)))
    (state, step, losses), got = counted(torch, ops.KERNELS, lambda: tr.fit(
        state, iter(batches[:-1]), n_steps=TRAIN_FAMILY_STEPS, log=quiet))
    check_counts(label, got, {"hist": TRAIN_FAMILY_STEPS * n_leaves})
    launches[label] = got
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: losses {losses}")
    times = list(tr._times)
    step_ms = statistics.median(times[1:]) * 1e3
    _, met, g = loss_and_grads(model, state.params, {
        k: torch.as_tensor(v, device=dev) for k, v in batches[-1].items()})
    aux = float(met["aux"])
    if cfg.n_experts and not (np.isfinite(aux) and aux > 0):
        raise AssertionError(f"{label}: the MoE aux loss is {aux}")
    bad = [k for k, t in leaves_with_keys(g) if not bool(torch.isfinite(t)
                                                         .all())]
    if bad:
        raise AssertionError(f"{label}: gradients not finite in {bad}")
    grad = dict(leaves_with_keys(g))[leaf].float()
    del g, state, tr
    hist.KERNEL.launches = 0
    qd, qinfo = gradcomp.quantize_dequantize(grad, b_bits=TRAIN_BITS)
    torch.cuda.synchronize()
    n_launch = hist.KERNEL.launches
    want, winfo = gradcomp.quantize_dequantize(grad.cpu(), b_bits=TRAIN_BITS)
    if n_launch != 1 or not torch.equal(qd.cpu().view(torch.int32),
                                        want.view(torch.int32)):
        raise AssertionError(f"{label} gradcomp {leaf}: the card differs "
                             f"from the CPU ({n_launch} launches)")
    peak = torch.cuda.max_memory_allocated()
    out = dict(arch=arch, layers=cfg.n_layers, params=model.param_count(),
               leaves=n_leaves, losses=losses, aux=aux, step_ms=step_ms,
               first_step_ms=times[0] * 1e3, seq=seq,
               step_ms_all=[round(t * 1e3, 2) for t in times],
               tokens_per_s=TRAIN_BATCH * seq / step_ms * 1e3,
               peak_device_bytes=peak, launches=got,
               gradcomp_leaf=dict(key=leaf, shape=list(grad.shape),
                                  alpha=float(qinfo["alpha"]),
                                  alpha_cpu=float(winfo["alpha"])))
    del grad, qd, want
    torch.cuda.empty_cache()
    log(f"{label}: {cfg.name} full width, {cfg.n_layers} of "
        f"{serve_config(arch).n_layers} layers, {out['params']} parameters, "
        f"{TRAIN_BATCH} x {seq} positions: losses "
        f"{[round(x, 4) for x in losses]}, aux {aux:.5f}, step "
        f"{step_ms:.1f} ms (median of steps 2-{TRAIN_FAMILY_STEPS}), "
        f"{out['tokens_per_s']:.0f} tokens/s, peak {peak / 1e9:.2f} GB, "
        f"launches {json.dumps(got)} ({n_leaves} leaves a step), every "
        f"gradient leaf finite; "
        f"quantize_dequantize of {leaf} {tuple(out['gradcomp_leaf']['shape'])}"
        f" card against CPU bit-exact, one histogram launch; {card}")
    return out


# The paper's comparison compressors (Sec. II, Figs. 9-12) on one delta
# step of each series: ISABELA's window and knots, and ZFP's absolute
# tolerance mean |x| * E as benchmarks/bench_compression.py sets it.
ISABELA_WINDOW, ISABELA_KNOTS = 1024, 32
BASELINE_STEP = 1
ZFP_TOL_FACTOR = 8                 # tests/test_baselines.py's ZFP bound


def host_ms(torch, fn) -> tuple:
    """(fn's result, its host-clock ms, synchronised on both sides)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def baselines_phase(torch, np, dev, data: dict, results: dict,
                    launches: dict) -> dict:
    """ISABELA, ZFP and zlib (repro_torch.baselines) on step BASELINE_STEP
    of each series at E, on the card and with device="cpu": payloads byte
    for byte and decompressed arrays bit for bit equal; ISABELA within
    the relative bound E, ZFP within ZFP_TOL_FACTOR x its tolerance;
    ISABELA's compress launches the bit-pack kernel once (its
    permutations) and no other kernel, ZFP and both decompressions none.
    Each compression ratio beside NUMARCK's for the same step (phase 2's
    zlib steps) and series; ms to compress and decompress on the card
    (host clock, the second call)."""
    from repro_torch.baselines import isabela, zfp_like, zlib_lossless
    from repro_torch.kernels import ops

    card = card_line()
    out = {}
    for name in MAIN_RUNS:
        x = data[name][BASELINE_STEP]
        tol = float(np.mean(np.abs(x))) * E
        raw = sum(a.nbytes for a in data[name])
        row = {"dtype": str(x.dtype), "shape": list(x.shape),
               "cr": {"numarck": x.nbytes / results[name][BASELINE_STEP]
                      .nbytes,
                      "numarck_series": raw / sum(s.nbytes
                                                  for s in results[name])},
               "ms": {}}
        coders = {
            "isabela": (lambda d: isabela.compress(
                x, E, ISABELA_WINDOW, ISABELA_KNOTS, device=d),
                isabela.decompress, {"bitpack": 1}),
            "zfp": (lambda d: zfp_like.compress(x, tol, device=d),
                    zfp_like.decompress, {})}
        for coder, (comp, decomp, want) in coders.items():
            label = f"{coder} {name}"
            blob, got = counted(torch, ops.KERNELS, lambda: comp(dev))
            check_counts(f"{label} compress", got, want)
            launches[label] = got
            rec, got = counted(torch, ops.KERNELS,
                               lambda: decomp(blob, device=dev))
            check_counts(f"{label} decompress", got, {})
            cpu = comp("cpu")
            if blob.payload != cpu.payload:
                raise AssertionError(f"{label}: the card's payload differs "
                                     "from device=cpu's")
            if not np.array_equal(rec.view(np.uint8), decomp(
                    cpu, device="cpu").view(np.uint8)):
                raise AssertionError(f"{label}: the card's decompressed "
                                     "array differs from device=cpu's")
            err = np.abs(rec.astype(np.float64) - x)
            if coder == "isabela":
                err = float((err / np.maximum(np.abs(x), 1e-30)).max())
                bound = E * (1 + 1e-6)
            else:
                err, bound = float(err.max()), tol * ZFP_TOL_FACTOR
            if not err <= bound:
                raise AssertionError(f"{label}: error {err} over {bound}")
            _, c_ms = host_ms(torch, lambda: comp(dev))
            _, d_ms = host_ms(torch, lambda: decomp(blob, device=dev))
            row["cr"][coder] = x.nbytes / blob.nbytes
            row["ms"][coder] = {"compress": c_ms, "decompress": d_ms}
            row[f"{coder}_error"] = err
            row[f"{coder}_bound"] = bound
            if coder == "isabela":
                row["isabela_exceptions"] = blob.meta["n_exceptions"]
        zb, z_ms = host_ms(torch, lambda: zlib_lossless.compress(x))
        row["cr"]["zlib"] = x.nbytes / zb.nbytes
        row["ms"]["zlib"] = {"compress": z_ms}
        row["numarck_wins"] = all(row["cr"]["numarck"] > row["cr"][c]
                                  for c in ("isabela", "zfp", "zlib"))
        out[name] = row
        log(f"baselines {name} step {BASELINE_STEP} {x.dtype} "
            f"{tuple(x.shape)}, E = {E}: CR NUMARCK "
            f"{row['cr']['numarck']:.3f} (series "
            f"{row['cr']['numarck_series']:.3f}), ISABELA "
            f"{row['cr']['isabela']:.3f}, ZFP {row['cr']['zfp']:.3f} (tol "
            f"{tol:.4e}), zlib {row['cr']['zlib']:.3f}; NUMARCK "
            f"{'beats' if row['numarck_wins'] else 'does not beat'} every "
            f"baseline; ms on the card (compress / decompress): ISABELA "
            f"{row['ms']['isabela']['compress']:.1f} / "
            f"{row['ms']['isabela']['decompress']:.1f}, ZFP "
            f"{row['ms']['zfp']['compress']:.1f} / "
            f"{row['ms']['zfp']['decompress']:.1f}, zlib (host) {z_ms:.1f}; "
            f"payloads byte-equal to device=cpu, ISABELA error "
            f"{row['isabela_error']:.3e} <= {E}, ZFP error "
            f"{row['zfp_error']:.3e} <= {ZFP_TOL_FACTOR} tol; launches "
            f"{json.dumps(launches[f'isabela {name}'])}; {card}")
    log("baselines " + json.dumps(out))
    return out


def run(torch, np) -> dict:
    from repro_torch import compress_series, decompress_series, interop
    from repro_torch.core import compress, packing, ratios
    from repro_torch.core.types import NumarckParams
    from repro_torch.data.temporal import generate_series
    from repro_torch.kernels import _build, bitpack, change_ratio, dequant
    from repro_torch.kernels import hist, ops, rans

    dev = torch.device("cuda")
    K = ops.KERNELS
    t_run = time.perf_counter()

    def mark(phase: str) -> None:
        """The run's elapsed host time as `phase` starts (PERF.md's time
        accounting against the 1,200 s limit)."""
        log(f"elapsed {time.perf_counter() - t_run:.1f} s: {phase}")

    # -- 1. build ----------------------------------------------------------
    log(f"build: {_build.build():.1f} s for {len(_build.SOURCES)} sources "
        f"({' '.join(_build.NVCC_FLAGS)})")
    for k in K:
        _build.library(k.lib)

    # -- 2. the main path on the card --------------------------------------
    mark("main")
    params = NumarckParams(error_bound=E)
    data = {name: list(generate_series(name, steps, seed=0, scale=SCALE))
            for name, steps in MAIN_RUNS.items()}
    results, wall, launches = {}, {}, {}
    for name, arrays in data.items():
        # Each series is its own run of the path: counts are set to 0 just
        # before it and read just after.
        t0 = time.perf_counter()
        results[name], launches[name] = counted(
            torch, K, lambda: compress_series(arrays, params, chain="device",
                                              device="cuda"))
        wall[name] = time.perf_counter() - t0
        log(f"main path {name} launches: {json.dumps(launches[name])}")
        check_counts(name, launches[name],
                     compress_launches(len(arrays), params))
    main_b = {}
    for name, arrays in data.items():
        steps = results[name]
        want = compress_series(arrays, params, chain="device", device="cpu")
        same_steps(np, interop, name, steps, want)
        recon = decompress_series(steps, device="cuda")
        errs = check_recon(np, name, arrays, recon)
        main_b[name] = [s.b_bits for s in steps[1:]]
        nbytes = sum(s.nbytes for s in steps)
        raw = sum(a.nbytes for a in arrays)
        log(f"main path {name}: {len(steps)} steps of "
            f"{arrays[0].shape} {arrays[0].dtype}, "
            f"{wall[name] / len(steps) * 1e3:.1f} ms/step wall "
            f"(first call, incl. upload and host finalize), B={main_b[name]}, "
            f"CR={raw / nbytes:.2f}, max mean error {max(errs):.3e}, "
            "byte-identical to device=cpu")

    # -- 3. the rANS paths on the card --------------------------------------
    mark("rans")
    rans_steps = {}
    min_bytes = rans.DEVICE_MIN_BYTES
    for label, (name, kw) in RANS_RUNS.items():
        arrays = data[name]
        p = NumarckParams(error_bound=E, **kw)
        # Sedov's 0.17 M-element f64 steps are below the device route's
        # threshold: lower it so that the f64 route runs the kernels.
        rans.DEVICE_MIN_BYTES = 0 if name == "sedov" else min_bytes
        try:
            t0 = time.perf_counter()
            steps, got = counted(torch, K, lambda: compress_series(
                arrays, p, chain="device", device="cuda"))
            wall_s = time.perf_counter() - t0
            log(f"rans path {label} launches: {json.dumps(got)}")
            check_counts(f"rans {label}", got, compress_launches(len(arrays),
                                                                 p))
            launches[f"rans {label}"] = got
            same_steps(np, interop, f"rans {label}", steps, compress_series(
                arrays, p, chain="device", device="cpu"))
            if name == "sedov":
                # The f64 read route through the decode and dequantize
                # kernels (CMIP's reads run in the archive phase).
                recon, got = counted(torch, K, lambda: decompress_series(
                    steps, device=dev))
                check_counts(f"read {label}", got, read_launches(steps))
                launches[f"read {label}"] = got
                cpu = decompress_series(steps, device="cpu")
                if not all(np.array_equal(a, b) for a, b in zip(recon, cpu)):
                    raise AssertionError(f"read {label}: cuda differs from "
                                         "cpu")
                check_recon(np, f"read {label}", arrays, recon)
                log(f"read {label} launches: {json.dumps(got)}, "
                    "bit-identical to device=cpu")
        finally:
            rans.DEVICE_MIN_BYTES = min_bytes
        version = 2 if p.symbol_rans else 1
        versions = [rans.blob_version(b) for s in steps[1:]
                    for b in s.index_blocks]
        if version not in versions or set(versions) - {0, version}:
            raise AssertionError(f"rans {label}: blob versions {versions}")
        if label == "cmip v1":
            st = steps[2]
            host = [rans.compress(rans.decompress(b)) for b in
                    st.index_blocks]
            if host != list(st.index_blocks):
                raise AssertionError("cmip v1: blobs differ from the host "
                                     "coder of the same packed bytes")
        rans_steps[label] = steps
        nbytes = sum(s.nbytes for s in steps)
        raw = sum(a.nbytes for a in arrays)
        log(f"rans path {label}: {len(steps)} steps, "
            f"{wall_s / len(steps) * 1e3:.1f} ms/step wall (first call), "
            f"B={[s.b_bits for s in steps[1:]]}, CR={raw / nbytes:.2f} "
            f"(zlib {raw / sum(s.nbytes for s in results[name]):.2f}), blob "
            f"versions {sorted(set(versions))}, byte-identical to device=cpu")

    # -- 4. archive and read on the card -----------------------------------
    mark("archive")
    read_counts = archive_phase(torch, np, dev, {
        "cmip zlib": (data["cmip"], results["cmip"]),
        "cmip v1": (data["cmip"], rans_steps["cmip v1"]),
        "cmip v2": (data["cmip"], rans_steps["cmip v2"])})
    for label, got in read_counts.items():
        launches[f"read {label}"] = got

    # -- 5. the equal-width, k-means and log-scale strategies -------------
    mark("strategies")
    strategies_phase(torch, np, dev, data, launches)

    # -- 6. the sharded and multi-process drivers --------------------------
    mark("sharded")
    sharded_phase(torch, np, dev, data, launches)

    # -- 7. one warm step, stage by stage ----------------------------------
    mark("warm")
    first, step_in = data["cmip"][0], data["cmip"][1]
    warm = {}
    for codec in ("zlib", "rans"):
        p = NumarckParams(error_bound=E, codec=codec)
        stages, step = stage_times(torch, p, dev, first, step_in)
        prev_t = torch.from_numpy(first).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if compress.device_decode_route(step):
            compress.decompress_step_device(step, prev_t, dev)
        else:
            compress.decompress_step(step, first, device=dev)
        torch.cuda.synchronize()
        stages["read"] = (time.perf_counter() - t0) * 1e3
        warm[codec] = stages
        # The whole series again (warm), and the anchor's share of it.
        t0 = time.perf_counter()
        steps = compress_series(data["cmip"], p, chain="device", device=dev)
        t_c = time.perf_counter() - t0
        t0 = time.perf_counter()
        decompress_series(steps, device=dev)
        t_d = time.perf_counter() - t0
        t0 = time.perf_counter()
        anchor = compress.make_anchor(first, p)
        t_a = time.perf_counter() - t0
        t0 = time.perf_counter()
        compress.decode_anchor(anchor, dev)
        t_ad = time.perf_counter() - t0
        log(f"warm CMIP series, {codec}, ms: compress_series "
            f"{t_c * 1e3:.1f} ({len(steps)} steps; the anchor alone "
            f"{t_a * 1e3:.1f}), decompress_series {t_d * 1e3:.1f} (the "
            f"anchor alone {t_ad * 1e3:.1f})")
        log(f"one warm CMIP step, {codec}, ms: " + ", ".join(
            f"{k} {v:.2f}" for k, v in stages.items())
            + f" (step {step.nbytes} bytes; encode = range pass, kernels "
            "1-3, sort, auto-B, copies to host"
            + (", rANS encode kernel" if codec == "rans" else "")
            + "; read = decode_step, " + (
                "rANS decode + unpack + dequantize kernels, patch"
                if codec == "rans" else "host zlib route") + ")")

    route_times(torch, np, dev, data)

    # -- 8. telemetry on the card, the step trace ---------------------------
    mark("telemetry")
    telemetry_phase(torch, np, dev, data, launches)

    # -- 9. the checkpoint manager, elastic restore, the GPipe schedule ---
    mark("checkpoint")
    with tempfile.TemporaryDirectory() as tmp:
        ck = checkpoint_phase(torch, np, dev, launches, tmp)
        mark("elastic")
        elastic_phase(torch, np, dev, ck, launches)
        del ck
    torch.cuda.empty_cache()
    mark("pipeline")
    pipeline_phase(torch, np, dev)

    # -- 10. the models and the serving engine -----------------------------
    mark("serve")
    serve_phase(torch, np, dev, launches)
    for family in FAMILIES:
        serve_phase(torch, np, dev, launches, *family)
        torch.cuda.empty_cache()

    # -- 11. training: the trainer, gradient compression, restart ---------
    mark("train")
    train_phase(torch, np, dev, launches)

    # -- 12. the paper's baselines on the card -----------------------------
    mark("baselines")
    baselines_phase(torch, np, dev, data, results, launches)

    # -- 13. each kernel against its plain version, timed ------------------
    mark("kernels")
    log_clocks("before the kernel phase")
    prev_big, curr_big = big_pair(np, N_BIG)
    pairs = {"cmip": (data["cmip"][0].reshape(-1), data["cmip"][1].reshape(-1)),
             "2^26": (prev_big, curr_big)}
    n_main = data["cmip"][0].size
    b_main = main_b["cmip"][0]
    # ``launches`` is the count of the kernel's own main path: the CMIP zlib
    # run for kernels 1-4, the CMIP v1 rANS run for the encode, the read of
    # the CMIP v1 archive for the decode and unpack.  ``launches_by_path``
    # gives every run's count.
    own = {"rans_encode": "rans cmip v1", "rans_decode": "read cmip v1",
           "rans_unpack": "read cmip v1"}
    table = {k.name: dict(name=k.name, route=k.route, source=k.source,
                          replaces=k.replaces,
                          launches=launches[own.get(k.name, "cmip")][k.name],
                          launches_by_path={p: c[k.name]
                                            for p, c in launches.items()},
                          max_abs_err=0.0)
             for k in K}

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
        line, uline = [], []
        for b in range(1, 25):
            idx, be = pack_input(torch, dev, gen, n, b, params, main)
            n_pad = idx.numel()
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
            nbytes = pack_bytes(n_pad, b)
            put_by_b(table, "bitpack", label, b, ms, nbytes, 3 * n_pad)
            if main and b == b_main:
                plain_ms = time_ms(torch, lambda: bitpack.pack_bits_plain(
                    idx, b_bits=b))
                record("bitpack", ms, plain_ms, nbytes, 3 * n_pad,
                       FP32_OPS_PER_S)
            # The unpack of the same words, as whole blocks of be indices:
            # exact against its plain version and a round trip.
            byts = unpack_rows(torch, got, n_pad, be, b)
            nb = byts.shape[0]
            out = rans.unpack_cuda(byts, b_bits=b, be=be)
            check("rans_unpack", out, rans.unpack_plain(byts, b_bits=b,
                                                        be=be))
            if not torch.equal(out.view(-1), idx[:nb * be]):
                raise AssertionError(f"rans_unpack B={b}: the unpack of the "
                                     "packed indices differs from them")
            ms = time_ms(torch, lambda: rans.unpack_cuda(byts, b_bits=b,
                                                         be=be))
            uline.append(f"B{b}={ms:.4f}")
            put_by_b(table, "rans_unpack", label, b, ms,
                     unpack_bytes(nb, be, b), 6 * nb * be)
            del idx, got, byts, out
        log(f"bitpack {label} n={n}{' (block-padded)' if main else ''} ms: "
            + " ".join(line) + ", all exact")
        log(f"rans_unpack {label} (whole blocks of the packed words) ms: "
            + " ".join(uline) + ", all exact and round trips")
        log(f"share of the bound by B, {label}: " + json.dumps(
            {k: {b: round(r["share"], 3) for b, r in
                 table[k]["by_b"][label].items()}
             for k in ("bitpack", "rans_unpack")}))

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

    rans_kernel_phase(torch, np, dev, {"cmip": pairs["cmip"],
                                       "2^26": pairs["2^26"]}, table)
    anchor_encode(torch, np, dev, data["cmip"][0], params, table)

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
    log_clocks("after the kernel phase")
    mark("end")
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
        card = card_line()
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
