"""ZLIB lossless baseline (paper Sec. II: 'may not achieve a good
compression ratio for high entropy data').

The reference's ``baselines/zlib_lossless.py``: there is no arithmetic
to move to the device, and zlib runs on the host, as it does there.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np


@dataclass
class ZlibBlob:
    payload: bytes
    dtype: str
    shape: tuple

    @property
    def nbytes(self) -> int:
        return len(self.payload) + 16


def compress(data: np.ndarray, level: int = 6) -> ZlibBlob:
    arr = np.ascontiguousarray(data)
    return ZlibBlob(zlib.compress(arr.tobytes(), level), str(arr.dtype),
                    tuple(arr.shape))


def decompress(blob: ZlibBlob) -> np.ndarray:
    raw = zlib.decompress(blob.payload)
    return np.frombuffer(raw, blob.dtype).reshape(blob.shape).copy()


__all__ = ["compress", "decompress", "ZlibBlob"]
