"""PyTorch/CUDA port of the NUMARCK temporal compressor.

The JAX package ``repro`` is the reference; this package mirrors its
names and module layout and produces byte-identical steps.  It imports
``torch``, ``numpy`` and the standard library only.  Entry points run on
the CUDA device unless the caller passes ``device="cpu"``; on CPU tensors
every kernel wrapper takes its plain PyTorch version.
"""
from repro_torch.core.compress import (TemporalCompressor,
                                       TemporalDecompressor, compress_series,
                                       compress_step, decompress_series,
                                       decompress_step, encode_device,
                                       make_anchor)
from repro_torch.core.container import NCKReader, NCKWriter, verify_nck
from repro_torch.core.partial import TemporalArchive, read_step_range
from repro_torch.core.types import (CompressedStep, NumarckParams,
                                    mean_error_rate)

__all__ = ["NumarckParams", "CompressedStep", "mean_error_rate",
           "compress_step", "decompress_step", "make_anchor",
           "encode_device", "compress_series", "decompress_series",
           "TemporalCompressor", "TemporalDecompressor", "NCKWriter",
           "NCKReader", "TemporalArchive", "read_step_range", "verify_nck"]
