"""Quickstart: compress a temporal dataset with parallel NUMARCK, on the
PyTorch port (``repro_torch``): the stages run on a CUDA card unless
``--device cpu`` asks for the plain PyTorch versions.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch.core import (NumarckParams, TemporalArchive, compress_series,
                              decompress_series, mean_error_rate)
from repro_torch.core.chain import resolve_device
from repro_torch.data.temporal import generate_series

# /tmp/quickstart_torch.nck by default: never the JAX example's file
ARCHIVE = os.path.join(tempfile.gettempdir(), "quickstart_torch.nck")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 6 snapshots of a turbulence-like field (FLASH-stir analogue)
    series = list(generate_series("stir", n_iterations=6, seed=0, scale=2))
    print(f"dataset: {len(series)} iterations x {series[0].shape} "
          f"{series[0].dtype} ({series[0].nbytes/1e6:.1f} MB each)")

    params = NumarckParams(error_bound=1e-3)      # E = 0.1%, auto-B, top-k
    steps = compress_series(series, params, device=dev)

    total_in = sum(a.nbytes for a in series)
    total_out = sum(s.nbytes for s in steps)
    print(f"compression ratio: {total_in/total_out:.2f} "
          f"(deltas only: {np.mean([s.compression_ratio() for s in steps[1:]]):.2f})")
    for i, s in enumerate(steps):
        kind = "anchor" if s.is_anchor else f"B={s.b_bits} alpha={s.alpha:.3f}"
        print(f"  it{i}: {s.nbytes/1e6:6.2f} MB  {kind}")

    recon = decompress_series(steps, device=dev)
    for i, (orig, rec) in enumerate(zip(series, recon)):
        assert mean_error_rate(orig, rec) <= params.error_bound * 1.01

    # write an archive + partial decompression
    TemporalArchive.write(ARCHIVE, "dens", steps)
    ar = TemporalArchive(ARCHIVE)
    window = ar.read_range("dens", 5, 1000, 1200)
    np.testing.assert_array_equal(window,
                                  recon[5].reshape(-1)[1000:1200])
    print("partial decompression of [1000:1200) at iteration 5: exact ✓")
    print(f"mean error rate (it5): "
          f"{mean_error_rate(series[5], recon[5]):.2e} <= E={params.error_bound}")


if __name__ == "__main__":
    main()
