"""Execution plan.

The reference fuses all seven per-tile formats into one mega-kernel that
branches per tile on the format code (reference: tilespmv_cuda.h:394-792),
one warp per tile row. Array programs compiled by XLA cannot branch per
tile, so this design separates *storage* (TileMatrix, reference-parity)
from *execution*:

`build_plan` compiles a TileMatrix into static-shaped, format-segregated,
padded arrays — one regular "engine" input per format family — so each
engine is a branch-free vectorized kernel over a rectangular array:

* dense tiles   -> (nt, B, B) batched tile·x-block products
* dense rows    -> (R, B) row dot-products, scatter by global row
* dense cols    -> (C, B) column AXPYs, scatter by tile-row block
* ELL tiles     -> width-class sub-buckets (nt, W, B) slot grids; HYB tiles'
                   ELL parts are folded in here (the reference's fused
                   kernel also runs HYB as ELL-only, tilespmv_cuda.h:606-663)
* CSR tiles     -> nnz-class sub-buckets (nt, W) flat pairs with packed
                   (row<<4|col) bytes — the 4-bit codec of encode.py
* COO tiles + HYB overflow -> the residual CSR, executed as a sorted
                   segment-sum (the CSR5 analog, SURVEY.md §7)

Load balance: padding-to-class replaces the reference's warp-chunk splitter
(tilespmv_cpu.h:68-118) — every lane of a class array carries equal work, so
the grid is rectangular by construction.

Partial y contributions land in a (tilem, B) block accumulator via
scatter-add keyed by tile-row (functional psum, not atomics), then flatten.

All plan arrays are JAX arrays; the plan is a pytree, so `spmv` jits with
static shapes and shards with NamedSharding.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..config import TileConfig
from ..core.tile_matrix import TileMatrix

# nnz classes for CSR tiles (tile nnz is in (coo_th, dense_th) = (12, 192)
# for default config) and width classes for ELL tiles.
CSR_NNZ_CLASSES = (16, 32, 64, 128, 256)
ELL_WIDTH_CLASSES = (1, 2, 4, 8, 16)


def _round_class(values: np.ndarray, classes: tuple[int, ...]) -> np.ndarray:
    """Smallest class >= value."""
    classes_arr = np.asarray(classes)
    idx = np.searchsorted(classes_arr, values, side="left")
    if np.any(idx >= len(classes)):
        raise ValueError(f"value exceeds largest class {classes[-1]}")
    return classes_arr[idx]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DenseEngine:
    """Dense tiles: val[t] is the full B x B tile (row-major)."""
    val: Any        # (nt, B, B) compute dtype
    tilerow: Any    # (nt,) int32
    tilecol: Any    # (nt,) int32


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RowEngine:
    """Dense-row tiles, flattened to independent full rows."""
    val: Any        # (R, B)
    grow: Any       # (R,) int32 global output row
    tilecol: Any    # (R,) int32


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ColEngine:
    """Dense-col tiles, flattened to independent full columns."""
    val: Any        # (C, B)
    gcol: Any       # (C,) int32 global input column
    tilerow: Any    # (C,) int32


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EllEngine:
    """One ELL width class: column-of-slots grid per tile."""
    val: Any        # (nt, W, B)
    col: Any        # (nt, W, B) uint8 intra-tile column (0 where padded)
    tilerow: Any    # (nt,) int32
    tilecol: Any    # (nt,) int32


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CsrEngine:
    """One CSR nnz class: flat (val, packed row|col) pairs per tile."""
    val: Any        # (nt, W)
    rowcol: Any     # (nt, W) uint8 packed (row<<4)|col; padded -> val 0
    tilerow: Any    # (nt,) int32
    tilecol: Any    # (nt,) int32


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ResidualEngine:
    """Sorted-COO residual (global indices), segment-sum by row."""
    val: Any        # (nnz,)
    row: Any        # (nnz,) int32 sorted ascending
    col: Any        # (nnz,) int32


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SpMVPlan:
    """Everything `spmv` needs, as one pytree."""
    dense: DenseEngine
    rows: RowEngine
    cols: ColEngine
    ells: tuple  # of EllEngine (one per active width class)
    csrs: tuple  # of CsrEngine (one per active nnz class)
    residual: ResidualEngine

    m: int = dataclasses.field(metadata=dict(static=True))
    n: int = dataclasses.field(metadata=dict(static=True))
    tilem: int = dataclasses.field(metadata=dict(static=True))
    tilen: int = dataclasses.field(metadata=dict(static=True))
    tile_size: int = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))

    @property
    def x_padded_len(self) -> int:
        return self.tilen * self.tile_size

    @property
    def y_padded_len(self) -> int:
        return self.tilem * self.tile_size

    def bytes_accessed(self) -> int:
        """HBM bytes one SpMV streams (A payloads + x + y), for roofline."""
        def nbytes(a):
            return int(np.prod(a.shape)) * a.dtype.itemsize
        total = 0
        total += nbytes(self.dense.val) + 8 * self.dense.tilerow.shape[0]
        total += nbytes(self.rows.val) + 8 * self.rows.grow.shape[0]
        total += nbytes(self.cols.val) + 8 * self.cols.gcol.shape[0]
        for e in self.ells:
            total += nbytes(e.val) + nbytes(e.col) + 8 * e.tilerow.shape[0]
        for e in self.csrs:
            total += nbytes(e.val) + nbytes(e.rowcol) + 8 * e.tilerow.shape[0]
        total += (nbytes(self.residual.val) + nbytes(self.residual.row)
                  + nbytes(self.residual.col))
        total += self.x_padded_len * self.dense.val.dtype.itemsize
        total += self.m * self.dense.val.dtype.itemsize
        return total

    def flops(self) -> int:
        """2*nnz useful flops (reference GFLOPS metric,
        tilespmv_cuda.h:1138)."""
        return 2 * self.nnz


def _pad_rows(a: np.ndarray, rows: int) -> np.ndarray:
    """Pad axis 0 to `rows` (appending zeros)."""
    if a.shape[0] == rows:
        return a
    pad = [(0, rows - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad)


def build_plan(tm: TileMatrix, compute_dtype=jnp.float32,
               pad_tiles_to: int = 8) -> SpMVPlan:
    """Compile a TileMatrix into a SpMVPlan.

    `pad_tiles_to`: engine leading dims are padded up to a multiple of this
    so XLA sees friendly shapes (padding tiles point at tile (0, 0)
    with zero values — harmless scatter of zeros).
    """
    b = tm.config.tile_size
    cdt = np.dtype(compute_dtype)
    pt = pad_tiles_to

    def pad_nt(nt):
        return max(pt, -(-nt // pt) * pt)

    # ---------- dense engine ----------
    bk = tm.dns
    nt = bk.num_tiles
    ntp = pad_nt(nt)
    val = np.zeros((ntp, b, b), dtype=cdt)
    if nt:
        trow = tm.tile_rowidx[bk.tile_ids].astype(np.int64)
        tcol = tm.tile_columnidx[bk.tile_ids].astype(np.int64)
        rowlen = tm.rowlen(trow)
        sizes = np.diff(bk.ptr)
        owner = np.repeat(np.arange(nt), sizes)
        off = np.arange(int(bk.ptr[-1])) - bk.ptr[owner]
        ri = off % rowlen[owner]
        ci = off // rowlen[owner]
        val[owner, ri, ci] = bk.val  # column-major storage -> row-major tile
        tilerow = _pad_rows(trow.astype(np.int32), ntp)
        tilecol = _pad_rows(tcol.astype(np.int32), ntp)
    else:
        tilerow = np.zeros(ntp, np.int32)
        tilecol = np.zeros(ntp, np.int32)
    dense = DenseEngine(val=jnp.asarray(val), tilerow=jnp.asarray(tilerow),
                        tilecol=jnp.asarray(tilecol))

    # ---------- dense-row engine ----------
    bk = tm.dnsrow
    nrows = int(bk.row_ids.shape[0])
    nrp = pad_nt(nrows)
    rval = np.zeros((nrp, b), dtype=cdt)
    grow = np.zeros(nrp, np.int32)
    rtcol = np.zeros(nrp, np.int32)
    if nrows:
        per_tile_rows = np.diff(bk.row_ptr)
        owner = np.repeat(np.arange(bk.num_tiles), per_tile_rows)
        trow = tm.tile_rowidx[bk.tile_ids[owner]].astype(np.int64)
        tcol = tm.tile_columnidx[bk.tile_ids[owner]].astype(np.int64)
        collen = tm.collen(tcol)
        # values are packed rows: row r of tile t occupies collen[t] slots
        row_sizes = collen
        starts = np.concatenate([[0], np.cumsum(row_sizes)[:-1]])
        eowner = np.repeat(np.arange(nrows), row_sizes)
        eoff = np.arange(int(row_sizes.sum())) - starts[eowner]
        rval[eowner, eoff] = bk.val
        grow[:nrows] = (trow * b + bk.row_ids.astype(np.int64)).astype(np.int32)
        rtcol[:nrows] = tcol.astype(np.int32)
    rows = RowEngine(val=jnp.asarray(rval), grow=jnp.asarray(grow),
                     tilecol=jnp.asarray(rtcol))

    # ---------- dense-col engine ----------
    bk = tm.dnscol
    ncols = int(bk.col_ids.shape[0])
    ncp = pad_nt(ncols)
    cval = np.zeros((ncp, b), dtype=cdt)
    gcol = np.zeros(ncp, np.int32)
    ctrow = np.zeros(ncp, np.int32)
    if ncols:
        per_tile_cols = np.diff(bk.col_ptr)
        owner = np.repeat(np.arange(bk.num_tiles), per_tile_cols)
        trow = tm.tile_rowidx[bk.tile_ids[owner]].astype(np.int64)
        tcol = tm.tile_columnidx[bk.tile_ids[owner]].astype(np.int64)
        rowlen = tm.rowlen(trow)
        col_sizes = rowlen
        starts = np.concatenate([[0], np.cumsum(col_sizes)[:-1]])
        eowner = np.repeat(np.arange(ncols), col_sizes)
        eoff = np.arange(int(col_sizes.sum())) - starts[eowner]
        cval[eowner, eoff] = bk.val
        gcol[:ncols] = (tcol * b + bk.col_ids.astype(np.int64)).astype(np.int32)
        ctrow[:ncols] = trow.astype(np.int32)
    cols = ColEngine(val=jnp.asarray(cval), gcol=jnp.asarray(gcol),
                     tilerow=jnp.asarray(ctrow))

    # ---------- ELL engines (ELL tiles + HYB ell-parts) ----------
    # Merge ELL tiles and HYB ell-parts into one logical list, then bucket
    # by width class and scatter all flat entries in one shot.
    def ell_sources():
        out = []
        if tm.ell.num_tiles:
            out.append((tm.ell.tile_ids, tm.ell.width.astype(np.int64),
                        tm.ell.ptr, tm.ell.val, tm.ell.col))
        if tm.hyb.num_tiles:
            out.append((tm.hyb.tile_ids, tm.hyb.width.astype(np.int64),
                        tm.hyb.ell_ptr, tm.hyb.ell_val, tm.hyb.ell_col))
        return out

    srcs = ell_sources()
    ells = []
    if srcs:
        all_tids = np.concatenate([s[0] for s in srcs])
        all_w = np.concatenate([s[1] for s in srcs])
        all_val = np.concatenate([s[3] for s in srcs])
        all_col = np.concatenate([s[4] for s in srcs])
        # rebuild a combined ptr
        sizes = np.concatenate(
            [np.diff(s[2]) for s in srcs]).astype(np.int64)
        all_ptr = np.concatenate([[0], np.cumsum(sizes)])
        trow_all = tm.tile_rowidx[all_tids].astype(np.int64)
        tcol_all = tm.tile_columnidx[all_tids].astype(np.int64)
        rowlen_all = tm.rowlen(trow_all)
        n_all = all_tids.shape[0]
        owner = np.repeat(np.arange(n_all), sizes)
        off = np.arange(int(all_ptr[-1])) - all_ptr[owner]
        slot_e = off // rowlen_all[owner]
        ri_e = off % rowlen_all[owner]
        classes = _round_class(all_w, ELL_WIDTH_CLASSES)
        for wc in ELL_WIDTH_CLASSES:
            idx = np.nonzero(classes == wc)[0]
            if idx.size == 0:
                continue
            ntp = pad_nt(idx.size)
            val = np.zeros((ntp, wc, b), dtype=cdt)
            col = np.zeros((ntp, wc, b), dtype=np.uint8)
            local = np.full(n_all, -1, np.int64)
            local[idx] = np.arange(idx.size)
            sel = classes[owner] == wc
            val[local[owner[sel]], slot_e[sel], ri_e[sel]] = all_val[sel]
            col[local[owner[sel]], slot_e[sel], ri_e[sel]] = all_col[sel]
            trow = _pad_rows(trow_all[idx].astype(np.int32), ntp)
            tcol = _pad_rows(tcol_all[idx].astype(np.int32), ntp)
            ells.append(EllEngine(val=jnp.asarray(val), col=jnp.asarray(col),
                                  tilerow=jnp.asarray(trow),
                                  tilecol=jnp.asarray(tcol)))

    # ---------- CSR engines ----------
    csrs = []
    bk = tm.csr
    if bk.num_tiles:
        counts = np.diff(bk.nnz_ptr)
        classes = _round_class(counts, CSR_NNZ_CLASSES)
        owner = np.repeat(np.arange(bk.num_tiles), counts)
        off = np.arange(int(bk.nnz_ptr[-1])) - bk.nnz_ptr[owner]
        packed_all = ((bk.row.astype(np.uint8) << 4)
                      | bk.col.astype(np.uint8))
        for wc in CSR_NNZ_CLASSES:
            idx = np.nonzero(classes == wc)[0]
            if idx.size == 0:
                continue
            ntp = pad_nt(idx.size)
            val = np.zeros((ntp, wc), dtype=cdt)
            rowcol = np.zeros((ntp, wc), dtype=np.uint8)
            local = np.full(bk.num_tiles, -1, np.int64)
            local[idx] = np.arange(idx.size)
            sel = classes[owner] == wc
            val[local[owner[sel]], off[sel]] = bk.val[sel]
            rowcol[local[owner[sel]], off[sel]] = packed_all[sel]
            trow = _pad_rows(
                tm.tile_rowidx[bk.tile_ids[idx]].astype(np.int32), ntp)
            tcol = _pad_rows(
                tm.tile_columnidx[bk.tile_ids[idx]].astype(np.int32), ntp)
            csrs.append(CsrEngine(val=jnp.asarray(val),
                                  rowcol=jnp.asarray(rowcol),
                                  tilerow=jnp.asarray(trow),
                                  tilecol=jnp.asarray(tcol)))

    # ---------- residual engine ----------
    r = tm.residual
    rn = r.nnz
    rnp = max(pt, -(-max(rn, 1) // pt) * pt) if rn else pt
    rval = np.zeros(rnp, dtype=cdt)
    rrow = np.zeros(rnp, np.int32)
    rcol = np.zeros(rnp, np.int32)
    if rn:
        rows_g = np.repeat(np.arange(tm.m, dtype=np.int64),
                           np.diff(r.indptr))
        rval[:rn] = r.val
        rrow[:rn] = rows_g.astype(np.int32)
        rcol[:rn] = r.indices
        # padding rows point at row 0 with val 0 (sorted order preserved
        # only if padded rows use the max row; use last row to keep sorted)
        rrow[rn:] = rrow[rn - 1]
    residual = ResidualEngine(val=jnp.asarray(rval), row=jnp.asarray(rrow),
                              col=jnp.asarray(rcol))

    return SpMVPlan(
        dense=dense, rows=rows, cols=cols, ells=tuple(ells),
        csrs=tuple(csrs), residual=residual,
        m=tm.m, n=tm.n, tilem=tm.tilem, tilen=tm.tilen, tile_size=b,
        nnz=tm.nnz)
