"""Public SpMV operator.

`TileSpMV` is the user-facing entry point: it compiles a matrix (CSR or an
already-converted TileMatrix) into an execution plan (`ops/plan.py`) and
exposes a jitted `y = A @ x` over the format-bucketed engines of
`ops/xla_spmv.py`, which XLA compiles for whatever device JAX runs on.

This mirrors the reference's driver (main.cu:142-180) over its CUDA
engine (tilespmv_cuda.h); the CPU engine (tilespmv_cpu.h) is
`ops/cpu_reference.py`.
"""
from __future__ import annotations

from typing import Optional, Union

import jax
import jax.numpy as jnp

from ..config import DEFAULT_CONFIG, TileConfig
from ..core.convert import tile_create
from ..core.tile_matrix import TileMatrix
from ..io.mmio import CSRMatrix
from . import xla_spmv as eng
from .plan import SpMVPlan, build_plan


@jax.jit
def spmv(plan: SpMVPlan, x: jax.Array) -> jax.Array:
    """y = A @ x over an execution plan. Jittable.

    Each format bucket runs under a stable `jax.named_scope` (`dense`,
    `ell_w<W>`, `csr_w<W>`, `cols`, `rows`, `residual`) so a profiler
    trace attributes device time per bucket. Products and sums are taken
    in at least float32 (a bfloat16 plan stores bf16 values only).
    """
    out_dtype = x.dtype
    x = x.astype(jnp.promote_types(x.dtype, jnp.float32))
    b = plan.tile_size
    x_pad = jnp.zeros(plan.x_padded_len, dtype=x.dtype).at[: plan.n].set(x)
    x2d = x_pad.reshape(plan.tilen, b)

    y2d = jnp.zeros((plan.tilem, b), dtype=x.dtype)
    if plan.dense.tilerow.shape[0]:
        with jax.named_scope("dense"):
            y2d = y2d.at[plan.dense.tilerow].add(
                eng.dense_blocks(plan.dense, x2d))
    for e in plan.ells:
        with jax.named_scope(f"ell_w{e.val.shape[1]}"):
            y2d = y2d.at[e.tilerow].add(eng.ell_blocks(e, x2d))
    for e in plan.csrs:
        with jax.named_scope(f"csr_w{e.val.shape[1]}"):
            y2d = y2d.at[e.tilerow].add(eng.csr_blocks(e, x2d))
    if plan.cols.gcol.shape[0]:
        with jax.named_scope("cols"):
            y2d = y2d.at[plan.cols.tilerow].add(
                eng.dense_cols(plan.cols, x_pad))

    y = y2d.reshape(-1)
    if plan.rows.grow.shape[0]:
        with jax.named_scope("rows"):
            y = y.at[plan.rows.grow].add(eng.dense_rows(plan.rows, x2d))
    if plan.residual.val.shape[0]:
        with jax.named_scope("residual"):
            y = y + eng.residual_rows(plan.residual, x_pad,
                                      plan.y_padded_len)
    return y[: plan.m].astype(out_dtype)


@jax.jit
def spmm(plan: SpMVPlan, xs: jax.Array) -> jax.Array:
    """Y = A @ X for X of shape (n, k): SpMV vmapped over the columns of
    X against the shared plan. Beyond-reference capability (the
    reference is SpMV-only)."""
    return jax.vmap(spmv, in_axes=(None, 1), out_axes=1)(plan, xs)


def _check_dtype(compute_dtype) -> None:
    if (jnp.dtype(compute_dtype) == jnp.dtype("float64")
            and not jax.config.jax_enable_x64):
        raise ValueError(
            "compute_dtype=float64 requires jax_enable_x64 "
            "(jax.config.update('jax_enable_x64', True))")


class TileSpMV:
    """Compiled tiled SpMV operator.

    >>> op = TileSpMV(csr)            # convert + plan + jit
    >>> y = op(x)                     # y = A @ x on the default device
    """

    def __init__(self, a: Union[CSRMatrix, TileMatrix],
                 config: TileConfig = DEFAULT_CONFIG,
                 compute_dtype=jnp.float32):
        _check_dtype(compute_dtype)
        self._transpose: Optional["TileSpMV"] = None
        # kept for .T: the transpose is planned from the source CSR (a
        # TileMatrix cannot be transposed without re-tiling anyway)
        self._source_csr = a if isinstance(a, CSRMatrix) else None
        self._config = config
        if isinstance(a, CSRMatrix):
            a = tile_create(a, config)
        self.tile_matrix: Optional[TileMatrix] = a
        self.plan = build_plan(a, compute_dtype=compute_dtype)
        self.compute_dtype = jnp.dtype(compute_dtype)

    @classmethod
    def from_plan(cls, plan: SpMVPlan, compute_dtype=None) -> "TileSpMV":
        """Construct the operator from an already-built (e.g. deserialized,
        core/serialize.py) plan, skipping conversion and planning — plan
        build is the dominant host cost on large matrices. The compute
        dtype defaults to the plan's value dtype."""
        if not isinstance(plan, SpMVPlan):
            raise TypeError(
                f"from_plan takes an SpMVPlan, got {type(plan).__name__}")
        if compute_dtype is None:
            compute_dtype = plan.dense.val.dtype
        _check_dtype(compute_dtype)
        self = cls.__new__(cls)
        self._transpose = None
        self._source_csr = None
        self._config = None
        self.tile_matrix = None
        self.plan = plan
        self.compute_dtype = jnp.dtype(compute_dtype)
        return self

    @property
    def shape(self) -> tuple[int, int]:
        return (self.plan.m, self.plan.n)

    @property
    def T(self) -> "TileSpMV":
        """The transposed operator (y = A^T @ x), converted and planned
        lazily on first access and cached; `op.T.T is op`. Needed by
        least-squares / normal-equation workflows (LSQR, CG on A^T A)
        on the rectangular archetypes. The transpose is planned from
        the SOURCE CSR (utils/host.py::csr_transpose — the reference's
        CSR->CSC pass, utils.h:172-211): A^T's tile structure differs
        from A's, so it gets its own format selection and plan."""
        if self._transpose is None:
            if self._source_csr is None:
                raise ValueError(
                    ".T needs the source CSRMatrix; construct TileSpMV "
                    "from a CSRMatrix (not a TileMatrix or a "
                    "deserialized plan) to use the transposed operator")
            from ..utils.host import csr_transpose
            t = TileSpMV(csr_transpose(self._source_csr),
                         config=self._config or DEFAULT_CONFIG,
                         compute_dtype=self.compute_dtype)
            t._transpose = self
            self._transpose = t
        return self._transpose

    def rmatvec(self, x) -> jax.Array:
        """y = A^T @ x (scipy.sparse.linalg.LinearOperator convention)."""
        return self.T(x)

    def __matmul__(self, x):
        """op @ x: SpMV for 1-D x, SpMM for 2-D x."""
        x = jnp.asarray(x)
        if x.ndim == 1:
            return self(x)
        if x.ndim == 2:
            return self.matmat(x)
        raise ValueError(f"op @ x needs x of rank 1 or 2, got {x.ndim}")

    def __call__(self, x) -> jax.Array:
        x = jnp.asarray(x, dtype=self.compute_dtype)
        if x.shape != (self.plan.n,):
            raise ValueError(
                f"x has shape {x.shape}, expected ({self.plan.n},)")
        return spmv(self.plan, x)

    def matmat(self, xs) -> jax.Array:
        """Y = A @ X for X (n, k) — multi-vector SpMM."""
        return spmm(self.plan, jnp.asarray(xs, dtype=self.compute_dtype))

    def flops(self) -> int:
        return self.plan.flops()

    def bytes_accessed(self) -> int:
        return self.plan.bytes_accessed()
