"""CPU tiled SpMV reference path.

Vectorized NumPy equivalent of the reference's sequential CPU engine
(reference: src/tilespmv_cpu.h:3-285): executes all seven per-tile format
algorithms directly on the TileMatrix payload buckets and produces y = A*x.
This is the correctness oracle for the device path and the target of the
exact-match check against the scalar CSR golden model
(tilespmv_cpu.h:274-284).

Unlike the GPU reference, COO tiles are computed from the per-tile COO
bucket here (the device path uses the extracted residual instead,
mirroring how the reference GPU kernels defer COO to replay buffers,
tilespmv_cuda.h:461-500).
"""
from __future__ import annotations

import numpy as np

from ..core.tile_matrix import TileMatrix


def _tile_geometry(tm: TileMatrix, tile_ids: np.ndarray):
    b = tm.config.tile_size
    trow = tm.tile_rowidx[tile_ids].astype(np.int64)
    tcol = tm.tile_columnidx[tile_ids].astype(np.int64)
    rowlen = tm.rowlen(trow).astype(np.int64)
    collen = tm.collen(tcol).astype(np.int64)
    return trow * b, tcol * b, rowlen, collen


def _expand(ptr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-element (owner, offset-within-owner) for a ragged layout."""
    sizes = np.diff(ptr)
    owner = np.repeat(np.arange(sizes.shape[0], dtype=np.int64), sizes)
    off = np.arange(int(ptr[-1]), dtype=np.int64) - ptr[owner]
    return owner, off


def spmv_cpu(tm: TileMatrix, x: np.ndarray,
             include_coo_tiles: bool = True,
             include_residual: bool = False) -> np.ndarray:
    """y = A @ x over the tiled container.

    Exactly one of `include_coo_tiles` / `include_residual` should be true
    (they hold the same extracted entries; using both double-counts COO
    tiles). With HYB tiles present, the residual also carries HYB overflow,
    so `include_residual=True` is required for HYB-converted matrices —
    matching the reference GPU flow where the HYB-COO tail is disabled in
    the fused kernel (tilespmv_cuda.h:635-660).
    """
    x = np.asarray(x)
    if x.shape != (tm.n,):
        raise ValueError(f"x has shape {x.shape}, expected ({tm.n},)")
    m = tm.m
    acc = np.result_type(tm.csr.val.dtype, x.dtype)
    y = np.zeros(m, dtype=acc)
    b = tm.config.tile_size

    # ---- tile-CSR (tilespmv_cpu.h:140-158) ----
    bk = tm.csr
    if bk.val.size:
        owner, _ = _expand(bk.nnz_ptr)
        row0, col0, _, _ = _tile_geometry(tm, bk.tile_ids)
        grow = row0[owner] + bk.row.astype(np.int64)
        gcol = col0[owner] + bk.col.astype(np.int64)
        np.add.at(y, grow, bk.val * x[gcol])

    # ---- tile-COO (tilespmv_cpu.h:159-172) ----
    bk = tm.coo
    if include_coo_tiles and bk.val.size:
        owner, _ = _expand(bk.nnz_ptr)
        row0, col0, _, _ = _tile_geometry(tm, bk.tile_ids)
        grow = row0[owner] + bk.row.astype(np.int64)
        gcol = col0[owner] + bk.col.astype(np.int64)
        np.add.at(y, grow, bk.val * x[gcol])

    # ---- tile-ELL (tilespmv_cpu.h:173-192): column-major slots, padded
    # entries have val == 0 and contribute nothing ----
    bk = tm.ell
    if bk.val.size:
        owner, off = _expand(bk.ptr)
        row0, col0, rowlen, _ = _tile_geometry(tm, bk.tile_ids)
        ri = off % rowlen[owner]
        grow = row0[owner] + ri
        gcol = col0[owner] + bk.col.astype(np.int64)
        np.add.at(y, grow, bk.val * x[gcol])

    # ---- tile-HYB (tilespmv_cpu.h:193-223) ----
    bk = tm.hyb
    if bk.ell_val.size:
        owner, off = _expand(bk.ell_ptr)
        row0, col0, rowlen, _ = _tile_geometry(tm, bk.tile_ids)
        ri = off % rowlen[owner]
        grow = row0[owner] + ri
        gcol = col0[owner] + bk.ell_col.astype(np.int64)
        np.add.at(y, grow, bk.ell_val * x[gcol])
    if bk.coo_val.size and not include_residual:
        # overflow entries: replay inline only when the residual is off
        owner, _ = _expand(bk.coo_ptr)
        row0, col0, _, _ = _tile_geometry(tm, bk.tile_ids)
        grow = row0[owner] + bk.coo_row.astype(np.int64)
        gcol = col0[owner] + bk.coo_col.astype(np.int64)
        np.add.at(y, grow, bk.coo_val * x[gcol])

    # ---- dense (tilespmv_cpu.h:224-239): column-major rowlen x collen ----
    bk = tm.dns
    if bk.val.size:
        owner, off = _expand(bk.ptr)
        row0, col0, rowlen, _ = _tile_geometry(tm, bk.tile_ids)
        ri = off % rowlen[owner]
        ci = off // rowlen[owner]
        np.add.at(y, row0[owner] + ri, bk.val * x[col0[owner] + ci])

    # ---- dense-row (tilespmv_cpu.h:240-254): packed full rows ----
    bk = tm.dnsrow
    if bk.val.size:
        owner, off = _expand(bk.ptr)
        row0, col0, _, collen = _tile_geometry(tm, bk.tile_ids)
        rank = off // collen[owner]
        ci = off % collen[owner]
        ri = bk.row_ids[bk.row_ptr[owner] + rank].astype(np.int64)
        np.add.at(y, row0[owner] + ri, bk.val * x[col0[owner] + ci])

    # ---- dense-col (tilespmv_cpu.h:255-269): packed full columns ----
    bk = tm.dnscol
    if bk.val.size:
        owner, off = _expand(bk.ptr)
        row0, col0, rowlen, _ = _tile_geometry(tm, bk.tile_ids)
        rank = off // rowlen[owner]
        ri = off % rowlen[owner]
        ci = bk.col_ids[bk.col_ptr[owner] + rank].astype(np.int64)
        np.add.at(y, row0[owner] + ri, bk.val * x[col0[owner] + ci])

    # ---- residual (the reference computes this with CSR5 on GPU;
    # here a plain CSR walk) ----
    if include_residual and tm.residual.nnz:
        r = tm.residual
        rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(r.indptr))
        np.add.at(y, rows, r.val * x[r.indices])

    return y


def plan_chunks(tm: TileMatrix):
    """Warp-chunk load balancer (reference tilespmv_cpu.h:68-118).

    Splits tile-rows with more than `config.chunk_tiles` tiles into chunks.
    Returns (row_idx[int32], is_split[bool], tile_start[int64],
    tile_stop[int64]) — one entry per chunk; split chunks must accumulate
    into y instead of overwriting (the sign-bit convention
    `blki | 0x80000000` in the reference becomes an explicit bool here).
    """
    th = tm.config.chunk_tiles
    counts = np.diff(tm.tile_ptr)
    n_chunks_per_row = np.where(counts <= th, 1,
                                -(-counts // th)).astype(np.int64)
    # rows with zero tiles still get one (empty) chunk, like the reference
    total = int(n_chunks_per_row.sum())
    row_idx = np.repeat(np.arange(tm.tilem, dtype=np.int32), n_chunks_per_row)
    is_split = np.repeat(counts > th, n_chunks_per_row)
    # chunk lengths: ceil(count / n_chunks) per reference :105
    lenblk = np.where(n_chunks_per_row > 0,
                      -(-counts // np.maximum(n_chunks_per_row, 1)), 0)
    first = np.zeros(total, dtype=np.int64)
    first[np.cumsum(n_chunks_per_row)[:-1]] = 1
    first[0] = 1
    local_i = np.arange(total) - np.repeat(
        np.concatenate([[0], np.cumsum(n_chunks_per_row)[:-1]]),
        n_chunks_per_row)
    start = tm.tile_ptr[row_idx] + local_i * np.repeat(lenblk,
                                                       n_chunks_per_row)
    stop = np.minimum(start + np.repeat(lenblk, n_chunks_per_row),
                      tm.tile_ptr[row_idx + 1])
    return row_idx, is_split, start, stop
