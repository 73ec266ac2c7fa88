"""4-bit intra-tile index codec.

Vectorized equivalent of the reference's nibble packer
(reference: src/encode.h:29-63 and the COO (row<<4)|col packing at
src/csr2tile.h:975-980). Two 4-bit intra-tile column indices are packed per
byte for CSR/ELL payloads; COO entries pack (row, col) of one nonzero into a
single byte. This halves (CSR/ELL) index traffic from HBM, which is what a
bandwidth-bound SpMV kernel pays for.

All functions are pure NumPy and operate on whole arrays (the reference
packs element-by-element in C loops).
"""
from __future__ import annotations

import numpy as np

HIGH_NIBBLE = 0xF0  # reference: common.h `num_f`
LOW_NIBBLE = 0x0F  # reference: common.h `num_b`


def pack_nibbles(idx: np.ndarray) -> np.ndarray:
    """Pack an array of 4-bit indices, two per byte.

    Element 2k goes to the high nibble, 2k+1 to the low nibble, matching
    reference `encode()` (encode.h:29-50). Odd-length input is zero-padded.
    """
    idx = np.ascontiguousarray(idx, dtype=np.uint8)
    if idx.ndim != 1:
        raise ValueError("pack_nibbles expects a 1-D array")
    if np.any(idx > 15):
        raise ValueError("indices must fit in 4 bits")
    n = idx.shape[0]
    if n % 2:
        idx = np.concatenate([idx, np.zeros(1, dtype=np.uint8)])
    pairs = idx.reshape(-1, 2)
    return ((pairs[:, 0] << 4) | pairs[:, 1]).astype(np.uint8)


def unpack_nibbles(packed: np.ndarray, count: int) -> np.ndarray:
    """Inverse of :func:`pack_nibbles`; returns `count` 4-bit indices.

    Matches reference `decode()` (encode.h:52-63): even positions from the
    high nibble, odd from the low nibble.
    """
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    out = np.empty(packed.shape[0] * 2, dtype=np.uint8)
    out[0::2] = (packed & HIGH_NIBBLE) >> 4
    out[1::2] = packed & LOW_NIBBLE
    return out[:count]


def pack_coo(rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Pack per-nonzero (row, col) intra-tile coordinates as (row<<4)|col.

    Matches the COO packing at reference csr2tile.h:975-980.
    """
    rows = np.asarray(rows, dtype=np.uint8)
    cols = np.asarray(cols, dtype=np.uint8)
    if np.any(rows > 15) or np.any(cols > 15):
        raise ValueError("intra-tile coordinates must fit in 4 bits")
    return ((rows << 4) | cols).astype(np.uint8)


def unpack_coo(packed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of :func:`pack_coo` (reference tilespmv_cpu.h:165-166)."""
    packed = np.asarray(packed, dtype=np.uint8)
    return ((packed & HIGH_NIBBLE) >> 4).astype(np.uint8), (
        packed & LOW_NIBBLE).astype(np.uint8)
