"""NUMARCK core stages of the PyTorch port (see ``repro_torch``): the
reference's ``repro.core`` names, each from its port module."""
from repro_torch.core.chain import (CHAIN_AUTO, CHAIN_DEVICE, CHAIN_HOST,
                                    DeviceReferenceChain, HostReferenceChain,
                                    ReferenceChain, SessionChain,
                                    make_reference_chain, resolve_residency)
from repro_torch.core.compress import (TemporalCompressor,
                                       TemporalDecompressor, compress_series,
                                       compress_step, decompress_series,
                                       decompress_step, encode_device,
                                       make_anchor)
from repro_torch.core.container import NCKReader, NCKWriter
from repro_torch.core.entropy import codec_names, get_codec, register_codec
from repro_torch.core.partial import TemporalArchive, read_step_range
from repro_torch.core.pipeline import (DeviceEncoded, EncodedIndices,
                                       finalize_step, reconstruction_dtype)
from repro_torch.core.types import (CompressedStep, NumarckParams,
                                    mean_error_rate)

__all__ = [
    "NumarckParams", "CompressedStep", "mean_error_rate",
    "compress_step", "decompress_step", "make_anchor", "encode_device",
    "compress_series", "decompress_series",
    "TemporalCompressor", "TemporalDecompressor",
    "ReferenceChain", "HostReferenceChain", "DeviceReferenceChain",
    "SessionChain", "make_reference_chain", "resolve_residency",
    "CHAIN_HOST", "CHAIN_DEVICE", "CHAIN_AUTO",
    "EncodedIndices", "DeviceEncoded", "finalize_step",
    "reconstruction_dtype",
    "codec_names", "get_codec", "register_codec",
    "NCKWriter", "NCKReader", "TemporalArchive", "read_step_range",
]
