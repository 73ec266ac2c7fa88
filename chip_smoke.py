"""Smoke run of the public SpMV path on one CUDA card.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the distributed phase

Phases (one card):
  1. the tests marked `gpu`, in a child process that holds the card
     before this process touches JAX (one JAX process per card);
  2. the device: kind, count, `nvidia-smi` name and power limit, the JAX
     version, XLA_FLAGS and the compile cache directory;
  3. TileSpMV in float32 and float64 on banded_large, powerlaw_large,
     mixed_large and a 160^3 7-point stencil (4.1M rows, 28.5M nonzeros):
     host convert and plan time, first-call time, compiled memory
     analysis, both correctness gates of bench/check.py on the full y,
     20 calls ending in block_until_ready, peak device memory;
  4. `op.matmat` (k = 8) and `op.T` on mixed_large in float32;
  5. the jitted CG of examples/cg.py in float64 on a 4.2M-row SPD system
     (about 38M nonzeros), whose true residual must be within 10x of
     NumPy float64 CG's after the same number of iterations.

With --four-cards only DistributedSpMV (allgather, halo, auto) and
DistributedSpMV2D on a 2x2 mesh run, on the stencil in f32 and f64,
against the one-card TileSpMV result and the golden.

Times are smoke timings on the card named beside them, not benchmark
cells. The last line of stdout is one JSON object, printed only when
every phase passed; without a CUDA card the script exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

from tilespmv_tpu.bench.check import gates, golden  # noqa: E402
from tilespmv_tpu.io import generate  # noqa: E402

SPMV_REPS = 20
CG_TOL = 1e-10


def stencil_160():
    return generate.stencil_3d(160, 160, 160, seed=22)


MATRICES = {
    "banded_large": generate.CORPUS["banded_large"],
    "powerlaw_large": generate.CORPUS["powerlaw_large"],
    "mixed_large": generate.CORPUS["mixed_large"],
    "stencil3d_160": stencil_160,
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_names() -> list[str]:
    """`nvidia-smi` name and power limit of each card, read by a child
    process that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def run_gpu_tests() -> bool:
    """The `gpu`-marked tests in a child process; passes only when at
    least one ran and none failed, erred or skipped."""
    with tempfile.TemporaryDirectory() as tmp:
        xml = os.path.join(tmp, "gpu.xml")
        env = dict(os.environ, JAX_PLATFORMS="cuda")
        r = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
             "-p", "no:cacheprovider", f"--junitxml={xml}",
             str(REPO / "tests")],
            cwd=REPO, env=env, capture_output=True, text=True,
            timeout=900)
        log(r.stdout[-3000:])
        if r.returncode != 0:
            log(r.stderr[-3000:])
        if not os.path.exists(xml):
            return False
        suite = ET.parse(xml).getroot()
        suite = suite if suite.tag == "testsuite" else suite[0]
        n = {k: int(suite.get(k, 0))
             for k in ("tests", "errors", "failures", "skipped")}
    ok = (r.returncode == 0 and n["tests"] > 0
          and n["errors"] == n["failures"] == n["skipped"] == 0)
    log(f"gpu tests: {n} rc={r.returncode} -> {'PASS' if ok else 'FAIL'}")
    return ok


def _x(n: int, dtype) -> np.ndarray:
    """x in the compute dtype; the golden reads the same values."""
    return np.random.default_rng(0).standard_normal(n).astype(dtype)


def phase_spmv(name, csr, tm, dtype, label, reps=SPMV_REPS) -> dict:
    """One matrix at one precision through TileSpMV."""
    import jax

    from tilespmv_tpu.ops.spmv import TileSpMV, spmv

    t0 = time.perf_counter()
    op = TileSpMV(tm, compute_dtype=dtype)
    t_plan = time.perf_counter() - t0
    x = _x(csr.n, dtype)
    xj = jax.device_put(x)
    t0 = time.perf_counter()
    y = jax.block_until_ready(op(xj))
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    compiled = spmv.lower(op.plan, xj).compile()
    t_aot = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    ref, mag = golden(csr, x)
    g = gates(np.asarray(y), ref, mag, dtype)
    t0 = time.perf_counter()
    for _ in range(reps):
        y = op(xj)
    jax.block_until_ready(y)
    t_call = (time.perf_counter() - t0) / reps
    stats = jax.devices()[0].memory_stats() or {}
    rec = dict(
        phase="spmv", matrix=name, dtype=np.dtype(dtype).name,
        m=csr.m, n=csr.n, nnz=csr.nnz, plan_s=t_plan,
        first_call_s=t_first, aot_compile_s=t_aot,
        temp_bytes=getattr(mem, "temp_size_in_bytes", None),
        argument_bytes=getattr(mem, "argument_size_in_bytes", None),
        output_bytes=getattr(mem, "output_size_in_bytes", None),
        call_ms=t_call * 1e3,
        peak_bytes_in_use=stats.get("peak_bytes_in_use"),
        card=label, **g)
    log(json.dumps(rec))
    return rec


def _golden_t(csr, y):
    """A^T y in float64 from the CSR arrays."""
    rows = np.repeat(np.arange(csr.m), np.diff(csr.indptr))
    prod = csr.data * np.asarray(y, np.float64)[rows]
    return (np.bincount(csr.indices, weights=prod, minlength=csr.n),
            np.bincount(csr.indices, weights=np.abs(prod), minlength=csr.n))


def phase_entry_points(csr, label, k=8) -> dict:
    """op.matmat (k columns) and op.T in float32 against the golden."""
    import jax.numpy as jnp

    from tilespmv_tpu.ops.spmv import TileSpMV

    op = TileSpMV(csr, compute_dtype=jnp.float32)
    rng = np.random.default_rng(1)
    xs = rng.standard_normal((csr.n, k)).astype(np.float32)
    ys = np.asarray(op.matmat(xs))
    mm = [gates(ys[:, j], *golden(csr, xs[:, j]), np.float32)
          for j in range(k)]
    yt_in = rng.standard_normal(csr.m).astype(np.float32)
    t0 = time.perf_counter()
    yt = np.asarray(op.T(yt_in))
    t_t = time.perf_counter() - t0
    gt = gates(yt, *_golden_t(csr, yt_in), np.float32)
    rec = dict(phase="entry_points", matmat_k=k,
               matmat_ok=all(g["ok"] for g in mm),
               matmat_scaled_err=max(g["scaled_err"] for g in mm),
               transpose_ok=gt["ok"], transpose_scaled_err=gt["scaled_err"],
               transpose_plan_and_first_call_s=t_t, card=label)
    rec["ok"] = rec["matmat_ok"] and rec["transpose_ok"]
    log(json.dumps(rec))
    return rec


def numpy_cg(csr, b, tol=CG_TOL, max_iters=2000):
    """Plain float64 CG from x = 0; returns (x, iterations) at the first
    iterate whose recursive residual is below tol * |b|."""
    rows = np.repeat(np.arange(csr.m), np.diff(csr.indptr))

    def matvec(v):
        return np.bincount(rows, weights=csr.data * v[csr.indices],
                           minlength=csr.m)

    x = np.zeros_like(b)
    r = b.copy()
    p = r.copy()
    rs = r @ r
    bnorm = np.sqrt(b @ b)
    for k in range(1, max_iters + 1):
        ap = matvec(p)
        alpha = rs / (p @ ap)
        x += alpha * p
        r -= alpha * ap
        rs_new = r @ r
        if np.sqrt(rs_new) <= tol * bnorm:
            return x, k
        p = r + (rs_new / rs) * p
        rs = rs_new
    raise RuntimeError(f"NumPy CG did not reach {tol} in {max_iters}")


def phase_cg(n, label) -> dict:
    """examples/cg.py's jitted CG in float64 against NumPy CG."""
    import jax
    import jax.numpy as jnp

    from examples.cg import cg, make_spd
    from tilespmv_tpu.ops.spmv import TileSpMV

    t0 = time.perf_counter()
    csr = make_spd(n=n)
    t_gen = time.perf_counter() - t0
    x_true = np.random.default_rng(2).standard_normal(csr.n)
    b = golden(csr, x_true)[0]
    t0 = time.perf_counter()
    x_np, iters = numpy_cg(csr, b)
    t_np = time.perf_counter() - t0
    bnorm = np.linalg.norm(b)
    res_np = np.linalg.norm(b - golden(csr, x_np)[0]) / bnorm
    t0 = time.perf_counter()
    op = TileSpMV(csr, compute_dtype=jnp.float64)
    t_plan = time.perf_counter() - t0
    bj = jax.device_put(b)
    t0 = time.perf_counter()
    x_dev = np.asarray(jax.block_until_ready(cg(op, bj, iters=iters)[0]))
    t_dev = time.perf_counter() - t0
    res_dev = np.linalg.norm(b - golden(csr, x_dev)[0]) / bnorm
    ratio = res_dev / res_np if res_np > 0 else float("inf")
    rec = dict(phase="cg", n=csr.n, nnz=csr.nnz, iterations=iters,
               numpy_true_residual=res_np, device_true_residual=res_dev,
               ratio=ratio, gen_s=t_gen, numpy_cg_s=t_np, plan_s=t_plan,
               device_cg_s_with_compile=t_dev, card=label,
               ok=bool(res_np <= CG_TOL and np.isfinite(res_dev)
                       and 0.1 <= ratio <= 10.0))
    log(json.dumps(rec))
    return rec


def phase_distributed(name, csr, dtype, label, n_dev=4) -> list[dict]:
    """DistributedSpMV (allgather, halo, auto) and DistributedSpMV2D on
    a 2x2 mesh against the one-card TileSpMV result and the golden."""
    import jax

    from tilespmv_tpu.ops.spmv import TileSpMV
    from tilespmv_tpu.parallel import (DistributedSpMV, DistributedSpMV2D,
                                       make_mesh, make_mesh2d)

    x = _x(csr.n, dtype)
    ref, mag = golden(csr, x)
    t0 = time.perf_counter()
    y_one = np.asarray(TileSpMV(csr, compute_dtype=dtype)(x), np.float64)
    t_one = time.perf_counter() - t0
    tol = gates(y_one, ref, mag, dtype)["scaled_tol"]
    ops = [(f"1d_{mode}", lambda mode=mode: DistributedSpMV(
               csr, mesh=make_mesh(n_dev), x_mode=mode,
               compute_dtype=dtype))
           for mode in ("allgather", "halo", "auto")]
    ops.append(("2d_2x2", lambda: DistributedSpMV2D(
        csr, mesh=make_mesh2d(2, 2), compute_dtype=dtype)))
    out = []
    for tag, make in ops:
        t0 = time.perf_counter()
        op = make()
        t_build = time.perf_counter() - t0
        plan_devs = {d for leaf in jax.tree.leaves(op.plan_sharded)
                     for d in leaf.sharding.device_set}
        xj = jax.device_put(x)
        t0 = time.perf_counter()
        y = jax.block_until_ready(op(xj))
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(SPMV_REPS):
            y = op(xj)
        jax.block_until_ready(y)
        t_call = (time.perf_counter() - t0) / SPMV_REPS
        y_devs = {s.device for s in y.addressable_shards}
        yh = np.asarray(y, np.float64)
        g = gates(yh, ref, mag, dtype)
        d1 = float(np.max(np.abs(yh - y_one) / np.where(mag > 0, mag, 1)))
        rec = dict(phase="distributed", op=tag,
                   x_mode=getattr(op, "x_mode", None), matrix=name,
                   dtype=np.dtype(dtype).name, plan_devices=len(plan_devs),
                   y_devices=len(y_devs), build_s=t_build,
                   first_call_s=t_first, call_ms=t_call * 1e3,
                   one_card_s=t_one, vs_one_card_scaled=d1, card=label,
                   **{k: v for k, v in g.items() if k != "ok"})
        rec["ok"] = bool(g["ok"] and d1 <= 2 * tol
                         and len(plan_devs) == n_dev
                         and len(y_devs) == n_dev)
        log(json.dumps(rec))
        out.append(rec)
        del op, y
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the distributed phase, on four cards")
    args = ap.parse_args(argv)

    oks = []
    if not args.four_cards:
        oks.append(run_gpu_tests())

    import jax

    from tilespmv_tpu.utils.jax_cache import configure_compile_cache

    cache_dir = configure_compile_cache()
    jax.config.update("jax_enable_x64", True)
    devs = jax.devices()
    need = 4 if args.four_cards else 1
    if devs[0].platform != "gpu" or len(devs) < need:
        print(f"error: needs {need} CUDA card(s); JAX found "
              f"{len(devs)} {devs[0].platform} device(s)", file=sys.stderr)
        return 2
    cards = card_names()
    label = cards[0]
    log(f"device_kind={devs[0].device_kind} count={len(devs)}")
    for c in cards:
        log(c)             # as nvidia-smi prints it: name, power limit
    log(f"jax={jax.__version__} XLA_FLAGS={os.environ.get('XLA_FLAGS')!r} "
        f"compile_cache={cache_dir}")

    import jax.numpy as jnp

    if args.four_cards:
        csr = stencil_160()
        for dtype in (jnp.float32, jnp.float64):
            oks += [r["ok"] for r in phase_distributed(
                "stencil3d_160", csr, dtype, label)]
    else:
        from tilespmv_tpu.core.convert import tile_create
        for name, make in MATRICES.items():
            csr = make()
            t0 = time.perf_counter()
            tm = tile_create(csr)
            log(f"{name}: m={csr.m} nnz={csr.nnz} convert_s="
                f"{time.perf_counter() - t0}")
            for dtype in (jnp.float32, jnp.float64):
                oks.append(phase_spmv(name, csr, tm, dtype, label)["ok"])
            if name == "mixed_large":
                oks.append(phase_entry_points(csr, label)["ok"])
            del tm
        oks.append(phase_cg(1 << 22, label)["ok"])

    if not all(oks):
        log(f"FAILED: {oks.count(False)} of {len(oks)} checks")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
