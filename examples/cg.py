"""Conjugate-gradient solve with TileSpMV as the operator.

Demonstrates the framework in a real iterative workload: the SpMV is the
hot loop, so the whole CG iteration is jitted with the compiled plan as a
pytree argument — every iteration runs on the device with no host round
trips.

    python examples/cg.py            # SPD system from the corpus
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np

from tilespmv_tpu.io import generate
from tilespmv_tpu.io.mmio import CSRMatrix, csr_from_coo
from tilespmv_tpu.ops.spmv import TileSpMV, spmv


def make_spd(n: int = 4096, seed: int = 0) -> CSRMatrix:
    """Sparse SPD system: A = L + L^T + diag shift (banded + noise)."""
    base = generate.banded(n, n, bandwidth=4, seed=seed)
    rows = np.repeat(np.arange(n), np.diff(base.indptr))
    cols = base.indices.astype(np.int64)
    vals = base.data
    # symmetrize and diagonally dominate
    r = np.concatenate([rows, cols, np.arange(n)])
    c = np.concatenate([cols, rows, np.arange(n)])
    v = np.concatenate([vals, vals, np.full(n, 25.0)])
    return csr_from_coo(n, n, r, c, v)


def cg(op: TileSpMV, b: jax.Array, iters: int = 200):
    """Plain CG, fully on device (plan is a pytree argument)."""

    @functools.partial(jax.jit, static_argnames=("k",))
    def run(plan, b, k):
        tiny = jnp.asarray(1e-30, b.dtype)

        def body(_, state):
            x, r, p, rs = state
            ap = spmv(plan, p)
            alpha = rs / jnp.maximum(jnp.vdot(p, ap), tiny)
            x = x + alpha * p
            r = r - alpha * ap
            rs_new = jnp.vdot(r, r)
            p = r + (rs_new / jnp.maximum(rs, tiny)) * p
            return x, r, p, rs_new

        x0 = jnp.zeros_like(b)
        state = (x0, b, b, jnp.vdot(b, b))
        x, r, _, _ = jax.lax.fori_loop(0, k, body, state)
        return x, jnp.sqrt(jnp.vdot(r, r))

    return run(op.plan, b, iters)


def main():
    csr = make_spd()
    op = TileSpMV(csr)
    rng = np.random.default_rng(0)
    x_true = rng.standard_normal(csr.n).astype(np.float32)
    b = jnp.asarray(csr.matvec(x_true.astype(np.float64)),
                    dtype=jnp.float32)
    x, rnorm = cg(op, b, iters=200)
    err = float(jnp.linalg.norm(x - x_true) / np.linalg.norm(x_true))
    print(f"CG: n={csr.n} nnz={csr.nnz} residual={float(rnorm):.3e} "
          f"relative error={err:.3e}")
    return err


if __name__ == "__main__":
    main()
