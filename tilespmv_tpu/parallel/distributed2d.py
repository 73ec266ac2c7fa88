"""2-D block-partitioned SpMV over a (rows x cols) device mesh.

The 1-D row partition (distributed.py) keeps whole matrix rows on one
device — the right default, since y blocks then have unique owners. For
very wide matrices (or very tall x that no longer fits one device's
reach), the tile grid is block-partitioned instead (SURVEY.md §5's
"2-D block-partition for very wide matrices ... partial-sum reduce"):

* device (i, j) owns block A_ij (row stripe i x column stripe j) as a
  complete single-chip TileSpMV problem, converted and planned
  independently, then unified into one SPMD program;
* x is sharded along the column axis and replicated along the row axis
  (`P('col')`), so device (i, j)'s shard IS exactly the x_j its block
  needs — no x exchange at all;
* each device computes the partial y_ij = A_ij @ x_j and the row stripe
  is reduced with one `psum` over the column axis — the functional
  equivalent of the reference's split-chunk atomicAdd
  (tilespmv_cuda.h:384-390) across devices;
* y returns sharded `P('row')` (replicated over columns).

Communication totals per device: zero on x, |y_i| on the reduce —
compare the 1-D partition's |x| all-gather; the 2-D layout wins when the
matrix is much wider than tall or when x cannot be afforded per device.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import DEFAULT_CONFIG, TileConfig
from ..core.convert import tile_create
from ..io.mmio import CSRMatrix
from ..ops.spmv import spmv
from .distributed import _plan_blocks, _row_block
from .mesh import COL_AXIS, ROW_AXIS, make_mesh2d


def _col_slice(csr: CSRMatrix, c0: int, c1: int, cols_padded: int):
    sel = (csr.indices >= c0) & (csr.indices < c1)
    rows = np.repeat(np.arange(csr.m), np.diff(csr.indptr))[sel]
    indptr = np.concatenate(
        [[0], np.cumsum(np.bincount(rows, minlength=csr.m))]).astype(
            np.int64)
    return CSRMatrix((csr.m, cols_padded), indptr,
                     (csr.indices[sel] - c0).astype(csr.indices.dtype),
                     csr.data[sel])


class DistributedSpMV2D:
    """Block-partitioned SpMV: y_i = psum_j(A_ij @ x_j).

    >>> op = DistributedSpMV2D(csr, mesh=make_mesh2d(2, 4))
    >>> y = op(x)        # y sharded P('row') over the mesh
    """

    def __init__(self, csr: CSRMatrix,
                 mesh: Optional[Mesh] = None,
                 config: TileConfig = DEFAULT_CONFIG,
                 compute_dtype=jnp.float32):
        self.mesh = mesh if mesh is not None else make_mesh2d(1, 1)
        nrow, ncol = self.mesh.devices.shape
        b = config.tile_size
        m, n = csr.shape
        rows_per = -(- -(-m // b) // nrow) * b
        cols_per = -(-n // (ncol * b)) * b
        self.m, self.n = m, n
        self.rows_per, self.cols_per = rows_per, cols_per
        self.compute_dtype = jnp.dtype(compute_dtype)

        self.tile_matrices = []
        blocks = []
        for i in range(nrow):
            stripe = _row_block(csr, i * rows_per, (i + 1) * rows_per,
                                rows_per)
            for j in range(ncol):
                blocks.append(_col_slice(stripe, j * cols_per,
                                         min((j + 1) * cols_per, n),
                                         cols_per))
        self.tile_matrices = [tile_create(blk, config) for blk in blocks]
        plans = _plan_blocks(self.tile_matrices, compute_dtype)
        self.local_plan_struct = plans[0]
        stacked = jax.tree.map(
            lambda *xs: jnp.stack(xs).reshape(
                (nrow, ncol) + xs[0].shape), *plans)
        self.plan_sharded = jax.device_put(
            stacked, NamedSharding(self.mesh, P(ROW_AXIS, COL_AXIS)))
        self.n_x_pad = ncol * cols_per

        def local_step(plan_stack, x_j):
            local = jax.tree.map(lambda a: a[0, 0], plan_stack)
            y_part = spmv(local, x_j)
            return jax.lax.psum(y_part, COL_AXIS)

        self._step = jax.jit(jax.shard_map(
            local_step, mesh=self.mesh,
            in_specs=(P(ROW_AXIS, COL_AXIS), P(COL_AXIS)),
            out_specs=P(ROW_AXIS)))

    @property
    def shape(self) -> tuple[int, int]:
        return (self.m, self.n)

    def __call__(self, x) -> jax.Array:
        x = jnp.asarray(x, dtype=self.compute_dtype)
        if x.shape != (self.n,):
            raise ValueError(f"x has shape {x.shape}, expected ({self.n},)")
        if self.n_x_pad != self.n:
            x = jnp.pad(x, (0, self.n_x_pad - self.n))
        x = jax.device_put(x, NamedSharding(self.mesh, P(COL_AXIS)))
        y = self._step(self.plan_sharded, x)
        return y[: self.m]

    def flops(self) -> int:
        return 2 * self.local_plan_struct.nnz
