"""PageRank over a power-law graph.

The adjacency matrix of a power-law graph converts to near-singleton
16x16 tiles, which land in the residual engine (a gather plus a sorted
segment sum, ops/xla_spmv.py). The full power iteration is jitted; each
step is one SpMV plus elementwise work on the device.

    python examples/pagerank.py
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np

from tilespmv_tpu.io import generate
from tilespmv_tpu.io.mmio import csr_from_coo
from tilespmv_tpu.ops.spmv import TileSpMV, spmv


def column_stochastic(csr):
    """Scale columns to sum to 1 (dangling columns stay zero)."""
    rows = np.repeat(np.arange(csr.m), np.diff(csr.indptr))
    colsum = np.zeros(csr.n)
    np.add.at(colsum, csr.indices, csr.data)
    scale = np.where(colsum > 0, 1.0 / np.maximum(colsum, 1e-300), 0.0)
    vals = csr.data * scale[csr.indices]
    return csr_from_coo(csr.m, csr.n, rows, csr.indices.astype(np.int64),
                        vals)


def pagerank(op: TileSpMV, damping: float = 0.85, iters: int = 50):
    @functools.partial(jax.jit, static_argnames=("k",))
    def run(plan, k):
        n = plan.n
        base = jnp.full(n, (1.0 - damping) / n, jnp.float32)

        def body(_, r):
            r2 = damping * spmv(plan, r) + base
            # dangling mass redistributed uniformly
            return r2 + (1.0 - jnp.sum(r2)) / n

        return jax.lax.fori_loop(0, k, body, jnp.full(n, 1.0 / n,
                                                      jnp.float32))

    return run(op.plan, iters)


def main():
    g = generate.power_law(4096, 4096, avg_nnz_per_row=12, seed=7)
    a = column_stochastic(g)
    op = TileSpMV(a)
    r = pagerank(op)
    r = np.asarray(r)
    top = np.argsort(r)[::-1][:5]
    print(f"PageRank: n={a.n} nnz={a.nnz} sum={r.sum():.6f} "
          f"top5={top.tolist()}")
    # golden check against dense power iteration
    d = a.to_dense()
    x = np.full(a.n, 1.0 / a.n)
    for _ in range(50):
        x2 = 0.85 * d @ x + 0.15 / a.n
        x = x2 + (1.0 - x2.sum()) / a.n
    err = np.max(np.abs(r - x))
    print(f"max abs err vs dense power iteration: {err:.2e}")
    return err


if __name__ == "__main__":
    main()
