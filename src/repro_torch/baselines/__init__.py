"""Comparison compressors: ISABELA-like, ZFP-like, ZLIB lossless (the
port of the reference's ``repro.baselines``: the same functions, blobs
and payload bytes, the arithmetic in torch on the device)."""
