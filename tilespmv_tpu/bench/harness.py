"""Benchmark harness.

Measures steady-state SpMV time the way the reference does — warmup
iterations followed by a timed loop (reference tilespmv_cuda.h:1058-1139,
WARMUP_NUM=200 / BENCH_REPEAT=1000) — but with the repeat loop compiled
*on device* (`lax.fori_loop` with a real data dependence between
iterations), so the host's dispatch latency does not enter the
per-iteration time.

Reported metrics (reference parity + roofline):
  ms per SpMV, GFLOPS = 2*nnz/t (tilespmv_cuda.h:1138), Gnnz/s,
  effective GB/s over the plan's true byte traffic, and the share of the
  device's peak memory bandwidth that represents (None on the CPU, which
  has no roofline entry).
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.plan import SpMVPlan
from ..ops.spmv import TileSpMV, spmv
from . import roofline


@dataclasses.dataclass
class BenchResult:
    name: str
    m: int
    n: int
    nnz: int
    ms: float
    gflops: float
    gnnz_per_s: float
    gbytes_per_s: float
    roofline_frac: Optional[float]
    device: str       # jax device_kind
    iters: int
    # measurement quality: False when the k_big/k_small delta stayed
    # within host jitter after escalation, the rep spread exceeded 30%,
    # or the implied GFLOPS exceeds the device's compute peak.
    # Unreliable rows must NOT enter results.csv.
    reliable: bool = True
    spread: float = 0.0   # (p84 - p16) / median of the timed diffs

    def csv_row(self) -> str:
        """Reference results.csv schema: filename,m,n,nnz,ms,gflops
        (tilespmv_cuda.h:1145-1146)."""
        return (f"{self.name},{self.m},{self.n},{self.nnz},"
                f"{self.ms:.6f},{self.gflops:.4f}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@functools.partial(jax.jit, static_argnames=("iters",))
def _spmv_loop(plan: SpMVPlan, x: jax.Array, iters: int) -> jax.Array:
    """Run `iters` chained SpMVs on device; returns a scalar checksum.

    The tiny y-dependent perturbation of x defeats loop-invariant hoisting
    and dead-code elimination without affecting the result beyond one ulp
    scale (1e-30 * sum(y) underflows against typical x). The scalar return
    keeps the result tiny.
    """

    def body(_, carry):
        x_cur, acc = carry
        y = spmv(plan, x_cur)
        s = jnp.sum(y) * jnp.asarray(1e-30, y.dtype)
        return x_cur + s, acc + jnp.sum(y)

    x0 = x
    acc0 = jnp.zeros((), dtype=x0.dtype)
    _, acc = jax.lax.fori_loop(0, iters, body, (x0, acc0))
    return acc


def _timed(fn, *args) -> float:
    """Wall time of fn(*args), waiting for the device to finish."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0


def benchmark_op(op: TileSpMV, x: Optional[np.ndarray] = None,
                 name: str = "matrix", warmup: int = 2,
                 timed_reps: int = 5, iters_per_rep: int = 100,
                 budget_s: float = 3.0,
                 max_spread: float = 0.30,
                 min_delta_s: float = 0.025) -> BenchResult:
    """Benchmark one compiled operator on the current default device.

    Uses the difference method: per-iteration time is
    (T(k_big) - T(k_small)) / (k_big - k_small), which cancels the fixed
    dispatch and synchronisation latency of one call.
    """
    m, n, nnz = op.plan.m, op.plan.n, op.plan.nnz
    flops = op.plan.flops()
    nbytes = op.plan.bytes_accessed()
    if x is None:
        x = ((np.arange(n) % 10) / 4.0)
    xj = jnp.asarray(x, dtype=op.compute_dtype)

    def run(iters: int) -> float:
        return _timed(functools.partial(_spmv_loop, iters=iters),
                      op.plan, xj)

    MIN_DELTA_S = min_delta_s
    MAX_SPREAD = max_spread

    # Calibrate: pick k_big so the k_big-vs-k_small delta (the quantity we
    # actually measure) is ~50 ms — far above host jitter. One extra
    # compile, but tiny matrices would otherwise measure noise.
    k_cal = min(32, max(2, iters_per_rep))
    run(k_cal)
    t_cal = run(k_cal)
    per_iter_est = max(t_cal / k_cal, 1e-7)
    # >= 2 always: k_small = k_big // 16 floors at 1, and k_big == 1
    # would make the (k_big - k_small) divisor zero
    k_big = max(2, int(np.clip(max(0.05, 2 * MIN_DELTA_S)
                                / per_iter_est, iters_per_rep,
                               1_000_000)))

    # Measure; if the delta we measured is within host jitter or the rep
    # spread is wide, escalate the iteration count and retry rather than
    # recording a noise-floor number. Callers that need tight numbers
    # raise min_delta_s / lower max_spread and pay the wall time.
    dt = float("nan")
    spread = float("inf")
    for _attempt in range(3):
        k_small = max(1, k_big // 16)
        for _ in range(max(warmup, 1)):
            run(k_small)
            run(k_big)
        diffs = []
        deltas = []
        for _ in range(timed_reps):
            t_small = run(k_small)
            t_big = run(k_big)
            deltas.append(t_big - t_small)
            diffs.append((t_big - t_small) / (k_big - k_small))
        dt = float(np.median(diffs))
        delta_med = float(np.median(deltas))
        p16, p84 = np.percentile(diffs, [16, 84])
        spread = float((p84 - p16) / dt) if dt > 0 else float("inf")
        if delta_med >= MIN_DELTA_S and spread <= MAX_SPREAD and dt > 0:
            break
        # escalate within the wall-clock budget: one timed rep costs
        # ~k_big * dt, so cap k_big at budget_s / dt (keeps smoke-test
        # configs from ballooning into minutes on slow CPU paths)
        per_iter = dt if dt > 0 and np.isfinite(dt) else per_iter_est
        k_cap = min(4_000_000, int(budget_s / max(per_iter, 1e-9)))
        if k_big >= k_cap:
            break
        scale = max(2.0, MIN_DELTA_S / max(delta_med, 1e-4))
        k_big = max(2, int(min(k_big * scale, k_cap)))

    peak = roofline.peak_for()
    reliable = (dt > 0 and np.isfinite(dt) and spread <= MAX_SPREAD)
    dt = max(dt, 1e-9)
    gflops = flops / dt / 1e9
    if peak is not None:
        peak_gflops = (peak.fp64_gflops if op.compute_dtype == np.float64
                       else peak.fp32_gflops)
        if gflops > peak_gflops:
            reliable = False   # physically impossible: above the peak
    return BenchResult(
        name=name, m=m, n=n, nnz=nnz,
        ms=dt * 1e3, gflops=gflops,
        gnnz_per_s=nnz / dt / 1e9,
        gbytes_per_s=nbytes / dt / 1e9,
        roofline_frac=(None if peak is None
                       else (nbytes / dt / 1e9) / peak.hbm_gbps),
        device=jax.devices()[0].device_kind,
        iters=timed_reps * iters_per_rep,
        reliable=reliable, spread=spread)


def append_results_csv(path: str, result: BenchResult) -> None:
    """Append-only CSV in the reference's schema
    (tilespmv_cuda.h:1141-1147). Refuses unreliable rows: a record the
    harness knows is at the noise floor must never enter the results
    file."""
    if not result.reliable:
        raise ValueError(
            f"refusing to record unreliable measurement for {result.name} "
            f"(spread={result.spread:.2f}); escalate iterations or mark "
            "the row unmeasurable")
    with open(path, "a") as f:
        f.write(result.csv_row() + "\n")
