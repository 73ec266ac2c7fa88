"""SpMV engines, one per plan bucket.

Each engine consumes one plan bucket and produces partial y contributions;
`ops/spmv.py::spmv` assembles them into y. They are plain jnp programs that
XLA compiles for the device: gathers, fused multiplies and scatter-adds.

Replaces the reference's fused per-warp dispatch kernel
(tilespmv_cuda.h:394-792) with branch-free, format-bucketed array programs
(see ops/plan.py docstring for the design rationale).

The two contractions (`dense_blocks`, `csr_blocks`) ask for
`Precision.HIGHEST`: on a GPU, XLA may otherwise run a float32
`dot_general` in TF32, which keeps about three decimal digits.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .plan import (ColEngine, CsrEngine, DenseEngine, EllEngine,
                   ResidualEngine, RowEngine, SpMVPlan)


def dense_blocks(e: DenseEngine, x2d: jax.Array) -> jax.Array:
    """(nt, B) per-tile y-block: full B x B tile times x-block.

    Replaces the unrolled shuffle-broadcast dense device code (reference
    tilespmv_cuda.h:664-710) with one batched matvec.
    """
    xblk = x2d[e.tilecol]  # (nt, B)
    return jnp.einsum("tij,tj->ti", e.val, xblk,
                      precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=x2d.dtype)


def dense_rows(e: RowEngine, x2d: jax.Array) -> jax.Array:
    """(R,) dot product per stored-full row (reference
    tilespmv_cuda.h:711-750 does this with sub-warp shuffle reductions)."""
    xblk = x2d[e.tilecol]  # (R, B)
    return jnp.sum(e.val * xblk, axis=1)


def dense_cols(e: ColEngine, x_pad: jax.Array) -> jax.Array:
    """(C, B) AXPY per stored-full column (reference
    tilespmv_cuda.h:751-778)."""
    return e.val * x_pad[e.gcol][:, None]


def ell_blocks(e: EllEngine, x2d: jax.Array) -> jax.Array:
    """(nt, B) per-tile y-block for one ELL width class.

    The reference gathers x via register shuffles (tilespmv_cuda.h:579-605);
    here the intra-tile gather is a lane-local take_along_axis over the
    16-wide x block. Padded slots carry val == 0.
    """
    xblk = x2d[e.tilecol]  # (nt, B)
    cols = e.col.astype(jnp.int32)  # (nt, W, B)
    g = jnp.take_along_axis(xblk[:, None, :], cols, axis=2)  # (nt, W, B)
    return jnp.sum(e.val * g, axis=1)


def csr_blocks(e: CsrEngine, x2d: jax.Array) -> jax.Array:
    """(nt, B) per-tile y-block for one CSR nnz class.

    y_tile = R^T (v ⊙ (x_blk[cols])) with R the row one-hot — the intra-tile
    row scatter becomes a tiny matmul instead of the reference's 2-lanes-
    per-row shuffle reduction (tilespmv_cuda.h:531-559). Indices arrive
    packed (row<<4)|col (core/encode.py codec) so the class reads 1 byte of
    index per nonzero.
    """
    b = x2d.shape[1]
    rowcol = e.rowcol.astype(jnp.int32)
    row = rowcol >> 4
    col = rowcol & 15
    xblk = x2d[e.tilecol]  # (nt, B)
    xv = jnp.take_along_axis(xblk, col, axis=1)  # (nt, W)
    contrib = e.val * xv  # (nt, W)
    onehot = jax.nn.one_hot(row, b, dtype=contrib.dtype)  # (nt, W, B)
    return jnp.einsum("tw,twb->tb", contrib, onehot,
                      precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=contrib.dtype)


def residual_rows(e: ResidualEngine, x_pad: jax.Array,
                  y_len: int) -> jax.Array:
    """Sorted segment-sum over the residual (the CSR5-analog engine,
    SURVEY.md §7; reference uses the vendored CSR5 library,
    external/CSR5_cuda)."""
    contrib = e.val * x_pad[e.col]
    return jax.ops.segment_sum(contrib, e.row, num_segments=y_len,
                               indices_are_sorted=True)
