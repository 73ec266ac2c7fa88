"""Global configuration for the tiled-SpMV framework.

Analog of the reference's compile-time tunables
(reference: src/common.h:12-63). Unlike the reference, every tunable is a
runtime config value, so one process can convert/execute matrices under
different tile shapes, thresholds, and dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# Format codes — identical numbering to the reference selector
# (reference: src/csr2tile.h:154,162,272,319 and format.h).
FMT_CSR = 0
FMT_COO = 1
FMT_ELL = 2
FMT_HYB = 3  # disabled in the reference selector (csr2tile.h:308-316); kept for parity
FMT_DNS = 4
FMT_DNSROW = 5
FMT_DNSCOL = 6

NUM_FORMATS = 7

FORMAT_NAMES = ("csr", "coo", "ell", "hyb", "dns", "dnsrow", "dnscol")


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Tunables for conversion + execution.

    Defaults reproduce the reference heuristics exactly
    (reference: src/common.h:37-52, src/csr2tile.h:150,159,267).
    """

    # Tile edge length. The reference hard-codes 16 (common.h:37-39); here it
    # is a knob, but the 4-bit intra-tile index codec requires <= 16.
    tile_size: int = 16

    # A tile is stored dense when nnz >= floor(0.75 * rowlen * collen)
    # (reference: csr2tile.h:150-151; note the C int truncation).
    dense_threshold: float = 0.75

    # A tile with nnz <= this many entries is COO, and its entries are
    # extracted into the global residual matrix (reference: common.h:44,
    # csr2tile.h:159-167).
    coo_nnz_threshold: int = 12

    # ELL selected when row-length coefficient of variation <= this
    # (reference: csr2tile.h:267-270).
    ell_cv_threshold: float = 0.2

    # HYB is disabled in the reference (csr2tile.h:308-316). When enabled,
    # tiles with cv >= hyb_cv_threshold and <= hyb_max_coo overflow entries
    # become HYB instead of CSR.
    enable_hyb: bool = False
    hyb_cv_threshold: float = 1.0
    hyb_max_coo: int = 4

    # Load-balance chunking: tile-rows longer than this many tiles are split
    # into chunks (reference: common.h:46 PREFETCH_SMEM_TH=4,
    # tilespmv_cpu.h:68-118).
    chunk_tiles: int = 4

    # Value dtype used for conversion / CPU reference path.
    value_dtype: np.dtype = dataclasses.field(default=np.dtype(np.float64))

    # Benchmark loop structure (reference: common.h:16-22).
    warmup_iters: int = 200
    bench_iters: int = 1000

    # Truncate the row count down to a multiple of tile_size, like the
    # reference driver does (main.cu:71). Off by default: the converter
    # handles partial tiles in both dimensions.
    truncate_rows_to_tile: bool = False

    # Force every tile into one format, bypassing the selector (the
    # "forced format (no selector)" benchmark config, BASELINE.json). Only
    # formats any tile can legally take: "csr", "coo", "ell", "dns".
    force_format: Optional[str] = None

    def __post_init__(self):
        if self.tile_size < 1 or self.tile_size > 16:
            raise ValueError(
                f"tile_size must be in [1, 16] (4-bit intra-tile index codec); "
                f"got {self.tile_size}")
        if not (0.0 < self.dense_threshold <= 1.0):
            raise ValueError("dense_threshold must be in (0, 1]")
        if self.coo_nnz_threshold < 0:
            raise ValueError("coo_nnz_threshold must be >= 0")
        if self.chunk_tiles < 1:
            raise ValueError("chunk_tiles must be >= 1")
        if self.force_format is not None and self.force_format not in (
                "csr", "coo", "ell", "dns"):
            raise ValueError(
                "force_format must be one of csr/coo/ell/dns (dense-row/"
                f"dense-col require structural properties); got "
                f"{self.force_format!r}")

    @property
    def dense_nnz_threshold_full_tile(self) -> int:
        """nnz at which a full tile_size x tile_size tile goes dense."""
        return int(self.tile_size * self.tile_size * self.dense_threshold)


DEFAULT_CONFIG = TileConfig()
