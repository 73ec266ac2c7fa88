"""TileMatrix — the central tiled-sparse container.

Analog of the reference `struct Tile_matrix` (reference:
src/format.h:3-56). The matrix is partitioned into a dense grid of
`tile_size x tile_size` tiles; occupied tiles are stored in a tile-grid CSR
(tile_ptr / tile_columnidx / tile_nnz) and each tile's payload lives in one
of seven format-segregated flat-array groups, exactly as the reference lays
out its per-format arrays (csr2tile.h:801-858). Very sparse (COO) tiles and
HYB overflow entries are additionally extracted into a global residual CSR
matrix (csr2tile.h:899-960), computed at SpMV time by the residual engine.

Everything is a plain NumPy array so the container is a pytree-compatible
bag of flat buffers — the direct input to both the CPU reference path and
the execution planner (ops/plan.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..config import (FMT_COO, FMT_CSR, FMT_DNS, FMT_DNSCOL, FMT_DNSROW,
                      FMT_ELL, FMT_HYB, FORMAT_NAMES, NUM_FORMATS, TileConfig)


@dataclasses.dataclass
class CSRBucket:
    """Tiles stored as tile-local CSR (format 0)."""
    tile_ids: np.ndarray      # int32 [nt] -> global tile index
    nnz_ptr: np.ndarray       # int64 [nt+1] offsets into val/col
    rowptr: np.ndarray        # uint8 [nt, B] per-tile exclusive row scan
    val: np.ndarray           # value [nnz]
    col: np.ndarray           # uint8 [nnz] intra-tile column
    # Per-nnz intra-tile row (redundant with rowptr; the reference derives it
    # by walking rowptr, tilespmv_cpu.h:144-148 — kept explicit here because
    # the execution plan consumes (row, col) pairs directly).
    row: np.ndarray           # uint8 [nnz]

    @property
    def num_tiles(self) -> int:
        return int(self.tile_ids.shape[0])


@dataclasses.dataclass
class COOBucket:
    """Very sparse tiles (format 1); entries also live in the residual."""
    tile_ids: np.ndarray      # int32 [nt]
    nnz_ptr: np.ndarray       # int64 [nt+1]
    val: np.ndarray           # value [nnz]
    row: np.ndarray           # uint8 [nnz] intra-tile row
    col: np.ndarray           # uint8 [nnz] intra-tile column

    @property
    def num_tiles(self) -> int:
        return int(self.tile_ids.shape[0])


@dataclasses.dataclass
class ELLBucket:
    """Regular-row tiles (format 2), column-major slot layout
    val[ptr + slot*rowlen + ri] (reference csr2tile.h:485-504)."""
    tile_ids: np.ndarray      # int32 [nt]
    width: np.ndarray         # int16 [nt]
    ptr: np.ndarray           # int64 [nt+1] offsets (width*rowlen per tile)
    val: np.ndarray           # value [sum(width*rowlen)], zero padded
    col: np.ndarray           # uint8 same shape; 0 where padded

    @property
    def num_tiles(self) -> int:
        return int(self.tile_ids.shape[0])


@dataclasses.dataclass
class HYBBucket:
    """ELL part + per-tile COO overflow (format 3; reference disables the
    selector branch, kept for forced-format parity, csr2tile.h:505-548)."""
    tile_ids: np.ndarray      # int32 [nt]
    width: np.ndarray         # int16 [nt]
    ell_ptr: np.ndarray       # int64 [nt+1]
    ell_val: np.ndarray
    ell_col: np.ndarray       # uint8
    coo_ptr: np.ndarray       # int64 [nt+1]
    coo_val: np.ndarray
    coo_row: np.ndarray       # uint8
    coo_col: np.ndarray       # uint8

    @property
    def num_tiles(self) -> int:
        return int(self.tile_ids.shape[0])


@dataclasses.dataclass
class DNSBucket:
    """Dense tiles (format 4), column-major val[ptr + ci*rowlen + ri]
    (reference csr2tile.h:549-567)."""
    tile_ids: np.ndarray      # int32 [nt]
    ptr: np.ndarray           # int64 [nt+1] (rowlen*collen per tile)
    val: np.ndarray

    @property
    def num_tiles(self) -> int:
        return int(self.tile_ids.shape[0])


@dataclasses.dataclass
class DNSRowBucket:
    """Dense-row tiles (format 5): packed full rows, row-major
    (reference csr2tile.h:568-591)."""
    tile_ids: np.ndarray      # int32 [nt]
    row_ptr: np.ndarray       # int64 [nt+1] cumulative #full-rows
    row_ids: np.ndarray       # uint8 [sum rows] intra-tile row index
    ptr: np.ndarray           # int64 [nt+1] offsets into val
    val: np.ndarray           # packed rows, each collen wide

    @property
    def num_tiles(self) -> int:
        return int(self.tile_ids.shape[0])


@dataclasses.dataclass
class DNSColBucket:
    """Dense-col tiles (format 6): packed full columns, column-major
    (reference csr2tile.h:592-617)."""
    tile_ids: np.ndarray      # int32 [nt]
    col_ptr: np.ndarray       # int64 [nt+1] cumulative #full-cols
    col_ids: np.ndarray       # uint8 [sum cols] intra-tile col index
    ptr: np.ndarray           # int64 [nt+1] offsets into val
    val: np.ndarray           # packed cols, each rowlen tall

    @property
    def num_tiles(self) -> int:
        return int(self.tile_ids.shape[0])


@dataclasses.dataclass
class ResidualCSR:
    """Global CSR of extracted COO-tile entries + HYB overflow
    (reference csr2tile.h:899-960, 'deferredcoo')."""
    indptr: np.ndarray        # int64 [m+1]
    indices: np.ndarray       # int32 [nnz]
    val: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1]) if self.indptr.size else 0


@dataclasses.dataclass
class TileMatrix:
    """The converted matrix: tile-grid CSR + per-format payload buckets."""

    shape: tuple[int, int]
    nnz: int
    config: TileConfig

    # Tile grid (reference format.h:8-14)
    tilem: int
    tilen: int
    tile_ptr: np.ndarray        # int64 [tilem+1]
    tile_rowidx: np.ndarray     # int32 [tilenum] (derived; reference recomputes)
    tile_columnidx: np.ndarray  # int32 [tilenum]
    tile_nnz: np.ndarray        # int64 [tilenum+1] cumulative
    fmt: np.ndarray             # int8 [tilenum] format code 0..6

    csr: CSRBucket
    coo: COOBucket
    ell: ELLBucket
    hyb: HYBBucket
    dns: DNSBucket
    dnsrow: DNSRowBucket
    dnscol: DNSColBucket
    # Lazy: the residual CSR is derivable from the COO bucket + HYB
    # overflow, and its global sort costs ~1.5 s on 6M-nnz matrices —
    # only the XLA engines and the CPU reference consume it, so it is
    # built on first access (reference builds it eagerly,
    # csr2tile.h:899-960; semantics identical)
    residual_: Optional[ResidualCSR] = None

    @property
    def residual(self) -> ResidualCSR:
        if self.residual_ is None:
            object.__setattr__(self, "residual_", self._build_residual())                 if hasattr(self, "__dict__") else None
            if self.residual_ is None:   # frozen-safe fallback
                self.__dict__["residual_"] = self._build_residual()
        return self.residual_

    def _build_residual(self) -> ResidualCSR:
        b = self.config.tile_size
        rows, cols, vals = [], [], []
        bk = self.coo
        if bk.num_tiles:
            counts = np.diff(bk.nnz_ptr)
            owner = np.repeat(np.arange(bk.num_tiles), counts)
            rows.append(self.tile_rowidx[bk.tile_ids[owner]].astype(
                np.int64) * b + bk.row)
            cols.append(self.tile_columnidx[bk.tile_ids[owner]].astype(
                np.int64) * b + bk.col)
            vals.append(bk.val)
        hb = self.hyb
        if hb.num_tiles and hb.coo_val.size:
            sizes = np.diff(hb.coo_ptr)
            owner = np.repeat(np.arange(hb.num_tiles), sizes)
            rows.append(self.tile_rowidx[hb.tile_ids[owner]].astype(
                np.int64) * b + hb.coo_row)
            cols.append(self.tile_columnidx[hb.tile_ids[owner]].astype(
                np.int64) * b + hb.coo_col)
            vals.append(hb.coo_val)
        if rows:
            rr = np.concatenate(rows)
            rc = np.concatenate(cols)
            rv = np.concatenate(vals)
            ro = np.argsort(rr * (self.n + b) + rc, kind="stable")
            rr, rc, rv = rr[ro], rc[ro], rv[ro]
        else:
            rr = np.zeros(0, np.int64)
            rc = np.zeros(0, np.int64)
            rv = np.zeros(0, self.csr.val.dtype)
        indptr = np.concatenate(
            [[0], np.cumsum(np.bincount(rr, minlength=self.m)[: self.m])])
        return ResidualCSR(indptr=indptr.astype(np.int64),
                           indices=rc.astype(np.int32), val=rv)

    @property
    def tilenum(self) -> int:
        return int(self.tile_columnidx.shape[0])

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    def rowlen(self, tile_rowidx) -> np.ndarray:
        """Row extent of tiles in a given tile-row (handles the partial last
        tile-row; reference csr2tile.h:144)."""
        b = self.config.tile_size
        last = self.m - (self.tilem - 1) * b
        return np.where(np.asarray(tile_rowidx) == self.tilem - 1, last, b)

    def collen(self, tile_colidx) -> np.ndarray:
        b = self.config.tile_size
        last = self.n - (self.tilen - 1) * b
        return np.where(np.asarray(tile_colidx) == self.tilen - 1, last, b)

    def format_histogram(self) -> dict[str, int]:
        """Per-format tile counts (reference tilespmv_cpu.h:120-136)."""
        counts = np.bincount(self.fmt, minlength=NUM_FORMATS)
        return {FORMAT_NAMES[i]: int(counts[i]) for i in range(NUM_FORMATS)}

    def stored_bytes(self, value_bytes: Optional[int] = None,
                     packed_indices: bool = True) -> int:
        """HBM bytes a single SpMV must read for A's payloads + metadata.

        Mirrors the reference's byte-counting rationale (selector HYB search
        csr2tile.h:280-294 uses the same model). With `packed_indices` the
        4-bit codec (encode.py) halves CSR/ELL index bytes.
        """
        vb = value_bytes if value_bytes is not None else self.csr.val.itemsize
        idx = 0.5 if packed_indices else 1.0
        b = 0
        b += self.csr.val.size * vb + int(self.csr.val.size * idx)
        b += self.csr.rowptr.size
        b += self.coo.val.size * vb + self.coo.val.size  # packed (row<<4|col)
        b += self.ell.val.size * vb + int(self.ell.val.size * idx)
        b += self.hyb.ell_val.size * vb + int(self.hyb.ell_val.size * idx)
        b += self.hyb.coo_val.size * vb + self.hyb.coo_val.size
        b += self.dns.val.size * vb
        b += self.dnsrow.val.size * vb + self.dnsrow.row_ids.size
        b += self.dnscol.val.size * vb + self.dnscol.col_ids.size
        b += self.residual.val.size * vb + self.residual.indices.size * 4
        b += (self.m + 1) * 8  # residual indptr
        # tile metadata: columnidx + nnz + fmt per tile
        b += self.tilenum * (4 + 4 + 1)
        return int(b)

    def validate(self) -> None:
        """Internal-consistency checks (tests call this on every convert)."""
        assert self.tile_ptr.shape == (self.tilem + 1,)
        assert int(self.tile_ptr[-1]) == self.tilenum
        assert self.tile_nnz.shape == (self.tilenum + 1,)
        # per-tile nnz must match bucket contents
        per_tile = np.diff(self.tile_nnz)
        for code, bucket in ((FMT_CSR, self.csr), (FMT_COO, self.coo)):
            sel = self.fmt[bucket.tile_ids] == code
            assert sel.all()
            np.testing.assert_array_equal(np.diff(bucket.nnz_ptr),
                                          per_tile[bucket.tile_ids])
        # every tile appears in exactly one bucket
        all_ids = np.concatenate([
            self.csr.tile_ids, self.coo.tile_ids, self.ell.tile_ids,
            self.hyb.tile_ids, self.dns.tile_ids, self.dnsrow.tile_ids,
            self.dnscol.tile_ids])
        assert all_ids.size == self.tilenum
        assert np.unique(all_ids).size == self.tilenum
        assert int(self.tile_nnz[-1]) == self.nnz
