"""Full pipeline on a FLASH-stir-like simulation: multi-variable archive,
binning-strategy comparison, baselines, and partial decompression -- the
paper's Sec. V workflow end to end, on the PyTorch port (``repro_torch``):
the stages and the baselines' arithmetic run on a CUDA card unless
``--device cpu`` asks for the plain PyTorch versions.

    PYTHONPATH=src python examples/torch_compress_simulation.py
    PYTHONPATH=src python examples/torch_compress_simulation.py --device cpu
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch.baselines import isabela, zfp_like, zlib_lossless
from repro_torch.core import (NCKWriter, NumarckParams, TemporalArchive,
                              compress_series, compress_step,
                              decompress_series, mean_error_rate)
from repro_torch.core.chain import resolve_device
from repro_torch.data.temporal import generate_series

E = 1e-3


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    variables = {name: list(generate_series(name, 4, seed=13, scale=2))
                 for name in ("stir", "asr")}

    # ---- strategy comparison on stir (paper Sec. V-D) -------------------
    print("binning strategies on stir (CR of delta steps):")
    for strat in ("topk", "equal", "log", "kmeans"):
        p = NumarckParams(error_bound=E, strategy=strat,
                          b_bits=None if strat == "topk" else 8)
        steps = compress_series(variables["stir"], p, device=dev)
        cr = np.mean([s.compression_ratio() for s in steps[1:]])
        me = max(mean_error_rate(o, r) for o, r in
                 zip(variables["stir"], decompress_series(steps, device=dev)))
        print(f"  {strat:7s} CR={cr:5.2f}  ME={me:.2e}")

    # ---- baselines (paper Figs. 9-12) -----------------------------------
    curr = variables["stir"][-1]
    prev = variables["stir"][-2]
    st = compress_step(prev, curr, NumarckParams(error_bound=E), device=dev)
    tol = float(np.mean(np.abs(curr))) * E
    isa = isabela.compress(curr, E, device=dev)
    zfp = zfp_like.compress(curr, tol, device=dev)
    print("\nvs baselines on stir (one iteration):")
    print(f"  NUMARCK  CR={st.compression_ratio():.2f}")
    print(f"  ISABELA  CR={curr.nbytes/isa.nbytes:.2f}")
    print(f"  ZFP-like CR={curr.nbytes/zfp.nbytes:.2f}")
    print(f"  ZLIB     CR={curr.nbytes/zlib_lossless.compress(curr).nbytes:.2f}")

    # ---- multi-variable archive + partial reads -------------------------
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "sim.nck")
        w = NCKWriter()
        p = NumarckParams(error_bound=E, block_bytes=1 << 14)
        for name, series in variables.items():
            for i, s in enumerate(compress_series(series, p, device=dev)):
                w.add_step(f"{name}_it{i:05d}", s)
        w.write(path)
        print(f"\narchive: {os.path.getsize(path)/1e6:.2f} MB for "
              f"{sum(sum(a.nbytes for a in s) for s in variables.values())/1e6:.2f} MB raw")

        ar = TemporalArchive(path)
        n = variables["asr"][0].size
        seg = ar.read_range("asr", 3, n // 4, n // 4 + 5000)
        full = ar.read_full("asr", 3)
        np.testing.assert_array_equal(seg,
                                      full.reshape(-1)[n // 4: n // 4 + 5000])
        print("partial decompression (asr, it3, 5000 elems): exact ✓")


if __name__ == "__main__":
    main()
