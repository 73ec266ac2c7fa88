"""tilespmv-tpu: a tiled sparse linear-algebra framework in JAX.

From-scratch JAX re-design of TileSpMV (IPDPS'21): matrices are
partitioned into 16x16 tiles, each tile auto-selected among seven storage
formats, very sparse tiles extracted into a residual matrix, and y = A*x
computed by format-bucketed engines that XLA compiles for the device,
scaling over device meshes via shard_map row partitions.
"""
from .config import (DEFAULT_CONFIG, FMT_COO, FMT_CSR, FMT_DNS, FMT_DNSCOL,
                     FMT_DNSROW, FMT_ELL, FMT_HYB, FORMAT_NAMES, TileConfig)
from .core.convert import tile_create
from .core.tile_matrix import TileMatrix
from .io.mmio import CSRMatrix, csr_from_coo, load_mtx, save_mtx
from .ops.cpu_reference import spmv_cpu
from .ops.spmv import TileSpMV, spmm, spmv

__version__ = "0.1.0"

__all__ = [
    "TileConfig", "DEFAULT_CONFIG", "TileMatrix", "CSRMatrix",
    "tile_create", "load_mtx", "save_mtx", "csr_from_coo", "spmv_cpu",
    "TileSpMV", "spmv", "spmm",
    "FORMAT_NAMES", "FMT_CSR", "FMT_COO", "FMT_ELL", "FMT_HYB", "FMT_DNS",
    "FMT_DNSROW", "FMT_DNSCOL",
]
