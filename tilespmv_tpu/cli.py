"""Benchmark / validation CLI driver.

Equivalent of the reference's benchmark binary
(reference: src/main.cu:15-205, usage `./test -d <device> matrix.mtx`):
loads a matrix, converts it, validates the CPU tiled path exactly against
the scalar CSR golden model (tilespmv_cpu.h:274-284), runs the device path,
checks it at 1% relative tolerance (main.cu:186-197), prints runtime +
GFLOPS and appends to results.csv (tilespmv_cuda.h:1141-1147).

Usage:
    python -m tilespmv_tpu.cli [options] <matrix.mtx | corpus-name>
    python -m tilespmv_tpu.cli --sweep          # whole synthetic corpus
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tilespmv_tpu",
        description="tiled SpMV benchmark/validation driver")
    p.add_argument("matrix", nargs="?",
                   help=".mtx path or synthetic corpus name")
    p.add_argument("--sweep-dir", default=None, metavar="DIR",
                   help="benchmark every .mtx/.mtx.gz under DIR "
                        "(recursive) into the results CSV — the "
                        "drop-in real-corpus mode (reference "
                        "bench0.sh over the SuiteSparse list)")
    p.add_argument("--sweep-manifest", default=None, metavar="CSV",
                   help="benchmark the matrices of an id,group,name,"
                        "rows,cols,nnz manifest (the reference's "
                        "2757-matrix.csv schema; ships as "
                        "tilespmv_tpu/bench/suitesparse_2757.csv — "
                        "fetch the corpus with "
                        "scripts/fetch_suitesparse.py)")
    p.add_argument("--matrix-dir", default=".", metavar="DIR",
                   help="with --sweep-manifest: corpus root holding "
                        "<group>/<name>/<name>.mtx (bench0.sh layout; "
                        "falls back to <name>.mtx directly under DIR)")
    p.add_argument("--sweep", action="store_true",
                   help="benchmark the whole synthetic corpus")
    p.add_argument("--scaling", action="store_true",
                   help="strong-scaling sweep over the device mesh")
    p.add_argument("-d", "--device", default=None,
                   choices=["cpu", "gpu"],
                   help="platform select (reference main.cu -d; set "
                        "before any JAX op)")
    p.add_argument("--dtype", default="f32",
                   choices=["f32", "f64", "bf16"])
    p.add_argument("--tile-size", type=int, default=16)
    p.add_argument("--force-format", default=None,
                   choices=["csr", "coo", "ell", "dns"],
                   help="bypass the selector (forced-format mode)")
    p.add_argument("--truncate-rows", action="store_true",
                   help="truncate rows to a tile multiple "
                        "(reference main.cu:71 parity)")
    p.add_argument("--iters", type=int, default=100,
                   help="SpMVs per timed repetition")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--csv", default="results.csv",
                   help="append results here ('' disables)")
    p.add_argument("--no-check", action="store_true",
                   help="skip correctness validation")
    p.add_argument("--device-check", action="store_true",
                   help="full-vector device check over the whole "
                        "synthetic corpus")
    p.add_argument("--save-tiles", default=None, metavar="PATH.npz",
                   help="checkpoint the converted TileMatrix")
    p.add_argument("--load-tiles", default=None, metavar="PATH.npz",
                   help="load a converted TileMatrix instead of converting")
    p.add_argument("--save-plan", default=None, metavar="PATH.npz",
                   help="checkpoint the compiled SpMVPlan (plan build is "
                        "the dominant host cost on large matrices)")
    p.add_argument("--load-plan", default=None, metavar="PATH.npz",
                   help="load an SpMVPlan instead of converting+planning "
                        "(skips the CPU check)")
    p.add_argument("--resume", action="store_true",
                   help="with --sweep-dir/--sweep-manifest: skip "
                        "matrices that already have a row in --csv "
                        "(restart an interrupted sweep where it "
                        "stopped; pairs with --plan-cache)")
    p.add_argument("--plan-cache", default=None, metavar="DIR",
                   help="with --sweep-dir: reuse cached plans from DIR "
                        "(written on first visit, keyed by file name + "
                        "dtype)")
    p.add_argument("--x-pattern", default="mod10",
                   choices=["mod10", "ones", "random"],
                   help="mod10 matches the reference driver "
                        "(main.cu:93-97)")
    return p


def _load(name: str):
    from .io import generate, mmio
    if name in generate.CORPUS:
        return generate.get_matrix(name)
    return mmio.load_mtx(name)


def main(argv=None) -> int:
    # parse before importing anything that initializes JAX backends
    args = build_parser().parse_args(argv)
    import jax
    if args.device:
        # must run before backend initialization (reference -d,
        # main.cu:35-58)
        jax.config.update("jax_platforms",
                          {"cpu": "cpu", "gpu": "cuda"}[args.device])
    import jax.numpy as jnp

    from .bench.harness import append_results_csv, benchmark_op
    from .bench.sweep import sweep
    from .config import TileConfig
    from .core.convert import tile_create
    from .ops.cpu_reference import spmv_cpu
    from .ops.spmv import TileSpMV
    from .utils.jax_cache import configure_compile_cache

    configure_compile_cache()
    dtype = {"f32": jnp.float32, "f64": jnp.float64,
             "bf16": jnp.bfloat16}[args.dtype]
    if args.dtype == "f64":
        jax.config.update("jax_enable_x64", True)

    config = TileConfig(tile_size=args.tile_size,
                        force_format=args.force_format,
                        truncate_rows_to_tile=args.truncate_rows)

    if args.sweep:
        sweep(config=config, compute_dtype=dtype,
              csv_path=args.csv or None)
        return 0

    if args.sweep_dir or args.sweep_manifest:
        import glob
        import traceback
        if args.sweep_manifest:
            # reference bench0.sh: iterate the manifest rows over a
            # local UFget-layout mirror; rows whose file is absent are
            # counted and skipped (a partial fetch still sweeps)
            import csv as _csv
            files, missing = [], 0
            with open(args.sweep_manifest, newline="") as f:
                for row in _csv.reader(f):
                    if len(row) < 3 or not row[0].strip().isdigit():
                        continue
                    group, name = row[1].strip(), row[2].strip()
                    cands = [os.path.join(args.matrix_dir, group, name,
                                          f"{name}.mtx"),
                             os.path.join(args.matrix_dir,
                                          f"{name}.mtx")]
                    hit = next((c for c in cands if os.path.exists(c)),
                               None)
                    if hit is None:
                        missing += 1
                    else:
                        files.append(hit)
            if not files:
                print(f"error: no manifest matrices found under "
                      f"{args.matrix_dir} (fetch them with "
                      f"scripts/fetch_suitesparse.py)", file=sys.stderr)
                return 2
            print(f"sweeping {len(files)} manifest matrices "
                  f"({missing} not fetched)")
        else:
            files = sorted(
                glob.glob(os.path.join(args.sweep_dir, "**", "*.mtx"),
                          recursive=True)
                + glob.glob(os.path.join(args.sweep_dir, "**",
                                         "*.mtx.gz"),
                            recursive=True))
            if not files:
                print(f"error: no .mtx files under {args.sweep_dir}",
                      file=sys.stderr)
                return 2
            print(f"sweeping {len(files)} matrices under "
                  f"{args.sweep_dir}")
        if args.plan_cache:
            os.makedirs(args.plan_cache, exist_ok=True)
        done: set = set()
        if args.resume and args.csv and os.path.exists(args.csv):
            # results.csv schema: name,m,n,nnz,ms,gflops (append-only);
            # a name present = that matrix completed in a prior run
            with open(args.csv) as f:
                done = {line.split(",", 1)[0] for line in f if "," in line}
        failures = skipped = 0
        for path in files:
            if os.path.basename(path) in done:
                skipped += 1
                continue
            try:
                cpath = None
                if args.plan_cache:
                    cpath = os.path.join(
                        args.plan_cache,
                        f"{os.path.basename(path)}.{args.dtype}.plan.npz")
                if cpath and os.path.exists(cpath):
                    from .core.serialize import load_plan
                    op = TileSpMV.from_plan(load_plan(cpath),
                                            compute_dtype=dtype)
                else:
                    csr = _load(path)
                    op = TileSpMV(csr, config=config, compute_dtype=dtype)
                    if cpath:
                        from .core.serialize import save_plan
                        save_plan(cpath, op.plan)
                res = benchmark_op(
                    op, name=os.path.basename(path),
                    iters_per_rep=args.iters, timed_reps=args.reps,
                    warmup=args.warmup)
                print(f"{res.name}: ms={res.ms:.4f} "
                      f"GFLOPS={res.gflops:.2f} "
                      f"reliable={res.reliable}")
                if args.csv:
                    if res.reliable:
                        append_results_csv(args.csv, res)
                    else:
                        # noise-floor row: surfaced but never recorded
                        # (append_results_csv refuses it); NOT a failure
                        print(f"  not recorded (spread="
                              f"{res.spread:.2f} over the reliability "
                              f"gate)", file=sys.stderr)
            except Exception:
                failures += 1
                print(f"FAILED: {path}", file=sys.stderr)
                traceback.print_exc()
        if skipped:
            print(f"resumed: {skipped} matrices already in {args.csv}")
        print(f"sweep-dir done: {len(files) - failures}/{len(files)} ok")
        return 0 if failures == 0 else 1

    if args.device_check:
        # reference main.cu:186-197's gate, run per corpus archetype on
        # the CURRENT device with the FULL y vector
        import numpy as _np
        from .io import generate
        bad_total = 0
        for name in sorted(generate.CORPUS):
            csr = generate.get_matrix(name)
            op = TileSpMV(csr, config=config, compute_dtype=dtype)
            x = ((_np.arange(csr.n) % 10) / 4.0)
            y = _np.asarray(op(x.astype(_np.dtype(dtype).name if dtype
                                        != jnp.bfloat16 else _np.float32)))
            ref = _np.zeros(csr.m)
            _np.add.at(ref, _np.repeat(_np.arange(csr.m),
                                       _np.diff(csr.indptr)),
                       csr.data * x[csr.indices])
            tol = 0.05 if dtype == jnp.bfloat16 else 0.01
            bad = int(_np.sum(_np.abs(ref - y) > tol * _np.abs(ref)
                              + 1e-4))
            bad_total += bad
            print(f"{name}: {'PASS' if bad == 0 else f'NO PASS ({bad})'}")
        print("device-check:", "PASS" if bad_total == 0 else "NO PASS")
        return 0 if bad_total == 0 else 1

    if args.scaling:
        from .bench.scaling import scaling_sweep
        csr = _load(args.matrix or "mixed_medium")
        scaling_sweep(csr, config=config)
        return 0

    if not args.matrix:
        print("error: provide a matrix path/name or --sweep",
              file=sys.stderr)
        return 2

    if args.load_plan:
        # plan checkpoint path: no conversion, no CPU check (the plan
        # carries no TileMatrix); validate on-device vs the reloaded
        # matrix only when one is given
        from .core.serialize import load_plan
        t0 = time.perf_counter()
        op = TileSpMV.from_plan(load_plan(args.load_plan),
                                compute_dtype=dtype)
        print(f"plan loaded in {time.perf_counter() - t0:.3f}s: "
              f"m={op.plan.m} n={op.plan.n} nnz={op.plan.nnz}")
        x = ((np.arange(op.plan.n) % 10) / 4.0)
        if not args.no_check and args.matrix:
            csr = _load(args.matrix)
            y_golden = csr.matvec(x)[: op.plan.m]
            y_dev = np.asarray(op(x.astype(np.float64)), np.float64)
            bad = np.abs(y_golden - y_dev) > 0.01 * np.abs(y_dev) + 1e-6
            print(f"Check... {'PASS!' if not bad.any() else 'NO PASS'} "
                  f"(errors = {int(bad.sum())})")
            if bad.any():
                return 1
        res = benchmark_op(op, x=x, name=args.matrix or args.load_plan,
                           warmup=args.warmup, timed_reps=args.reps,
                           iters_per_rep=args.iters)
        print(f"TileSpMV: {res.ms:.4f} ms, {res.gflops:.2f} GFLOPS")
        if args.csv and res.reliable:
            append_results_csv(args.csv, res)
        return 0

    t0 = time.perf_counter()
    csr = _load(args.matrix)
    print(f"input matrix A: ( {csr.m}, {csr.n} ) nnz = {csr.nnz} "
          f"[loaded in {time.perf_counter() - t0:.3f}s]")

    t0 = time.perf_counter()
    if args.load_tiles:
        from .core.serialize import load_tile_matrix
        tm = load_tile_matrix(args.load_tiles)
        config = tm.config
    else:
        tm = tile_create(csr, config)
    if args.save_tiles:
        from .core.serialize import save_tile_matrix
        save_tile_matrix(args.save_tiles, tm)
    print(f"tiles: {tm.tilenum} ({tm.tilem} x {tm.tilen} grid) "
          f"formats = { {k: v for k, v in tm.format_histogram().items() if v} } "
          f"residual nnz = {tm.residual.nnz} "
          f"[converted in {time.perf_counter() - t0:.3f}s]")

    x = {
        "mod10": ((np.arange(tm.n) % 10) / 4.0),
        "ones": np.ones(tm.n),
        "random": np.random.default_rng(0).standard_normal(tm.n),
    }[args.x_pattern]

    if not args.no_check:
        # CPU tiled path, exact-equality count vs golden
        # (tilespmv_cpu.h:274-284)
        y_golden = csr.matvec(x)[: tm.m]
        y_cpu = spmv_cpu(tm, x)
        errs = int(np.sum(y_cpu != y_golden))
        print(f"CPU TileSpMV errcount = {errs}")

    op = TileSpMV(tm, config=config, compute_dtype=dtype)
    if args.save_plan:
        from .core.serialize import save_plan
        save_plan(args.save_plan, op.plan)
        print(f"plan saved to {args.save_plan}")
    t0 = time.perf_counter()
    y_dev = np.asarray(op(x.astype(np.float64)), dtype=np.float64)
    print(f"device path compiled+ran in {time.perf_counter() - t0:.2f}s "
          f"(dtype={args.dtype}, device={jax.devices()[0].device_kind}, "
          f"count={len(jax.devices())})")

    if not args.no_check:
        # 1% relative tolerance gate (main.cu:186-197)
        y_golden = csr.matvec(x)[: tm.m]
        bad = np.abs(y_golden - y_dev) > 0.01 * np.abs(y_dev) + 1e-6
        errors = int(bad.sum())
        print(f"Check... {'PASS!' if errors == 0 else 'NO PASS'} "
              f"(errors = {errors})")
        if errors:
            return 1

    res = benchmark_op(op, x=x, name=args.matrix, warmup=args.warmup,
                       timed_reps=args.reps, iters_per_rep=args.iters)
    qual = ("" if res.reliable
            else f"  [UNRELIABLE: spread={res.spread:.0%}]")
    roof = ("no roofline on the CPU" if res.roofline_frac is None
            else f"{res.roofline_frac:.1%} of peak HBM bandwidth")
    print(f"TileSpMV: {res.ms:.4f} ms, {res.gflops:.2f} GFLOPS, "
          f"{res.gnnz_per_s * 1e3:.2f} Mnnz/ms, "
          f"{res.gbytes_per_s:.1f} GB/s ({roof}) on {res.device}{qual}")
    if args.csv:
        if res.reliable:
            append_results_csv(args.csv, res)
        else:
            print(f"not recording unreliable row to {args.csv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
