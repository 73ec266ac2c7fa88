"""Scaling-efficiency sweep over a device mesh.

Measures distributed SpMV throughput at increasing device counts on
whatever mesh is available — real devices (call
`parallel.initialize_multihost()` first for several processes), or the
virtual CPU mesh in tests (meaningful for plumbing, not for absolute
numbers). Reports per-count ms / GFLOPS and parallel efficiency vs the
smallest count, a sweep the single-GPU reference never had
(SURVEY.md §2.3).
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Iterable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DEFAULT_CONFIG, TileConfig
from ..io.mmio import CSRMatrix
from ..parallel import DistributedSpMV, make_mesh


@dataclasses.dataclass
class ScalePoint:
    n_devices: int
    ms: float
    gflops: float
    efficiency: float  # vs the smallest device count, ideal = 1.0


def _bench_distributed(op: DistributedSpMV, x: np.ndarray,
                       k1: int = 8, k2: int = 72, reps: int = 3) -> float:
    """Difference-method timing of the sharded step (see
    bench/harness.py): cancels the fixed cost of one dispatch."""
    xj = jnp.asarray(x, dtype=op.compute_dtype)
    if op.x_mode == "halo":
        xj = jnp.pad(xj, (0, op.halo.n_x_pad - op.n))
        extra = (op._send_idx,)
    else:
        if op.n_pad != op.n:
            xj = jnp.pad(xj, (0, op.n_pad - op.n))
        extra = ()
    step = op._step

    @functools.partial(jax.jit, static_argnames=("iters",))
    def loop(plan, x_in, *ex, iters):
        def body(i, carry):
            x_cur, acc = carry
            y = step(plan, x_cur, *ex)
            s = jnp.sum(y).astype(x_cur.dtype)
            return x_cur + s * 1e-30, acc + jnp.sum(y)
        _, acc = jax.lax.fori_loop(
            0, iters, body, (x_in, jnp.zeros((), xj.dtype)))
        return acc

    def timed(iters):
        best = 1e9
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(
                loop(op.plan_sharded, xj, *extra, iters=iters))
            best = min(best, time.perf_counter() - t0)
        return best

    jax.block_until_ready(
        loop(op.plan_sharded, xj, *extra, iters=k1))  # compile
    return max((timed(k2) - timed(k1)) / (k2 - k1), 1e-9)


def scaling_sweep(csr: CSRMatrix,
                  device_counts: Optional[Iterable[int]] = None,
                  x_mode: str = "auto",
                  config: TileConfig = DEFAULT_CONFIG,
                  verbose: bool = True) -> list[ScalePoint]:
    """Throughput at each device count (powers of two up to all devices
    by default). Work is fixed (strong scaling)."""
    total = len(jax.devices())
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32, 64) if d <= total]
    x = ((np.arange(csr.n) % 10) / 4.0).astype(np.float32)
    flops = 2.0 * csr.nnz
    out: list[ScalePoint] = []
    base = None
    for nd in device_counts:
        op = DistributedSpMV(csr, mesh=make_mesh(nd), config=config,
                             x_mode=x_mode if nd > 1 else "replicated")
        dt = _bench_distributed(op, x)
        gf = flops / dt / 1e9
        if base is None:
            base = (device_counts[0], dt)
        eff = (base[1] / dt) * (base[0] / nd)
        out.append(ScalePoint(n_devices=nd, ms=dt * 1e3, gflops=gf,
                              efficiency=eff))
        if verbose:
            print(f"devices={nd:3d}: {dt*1e3:8.4f} ms  {gf:8.2f} GFLOPS  "
                  f"efficiency={eff:.2f}", flush=True)
    return out
