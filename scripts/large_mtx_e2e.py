"""SuiteSparse-scale end-to-end workflow.

The reference's whole benchmark story is file-driven
(`/root/reference/src/main.cu:63-110`, `external/CSR5_cuda/bench0.sh`):
read a multi-M-nnz `.mtx`, convert, run, check, time. This recipe
reproduces that at SuiteSparse scale without committing a 100+ MB file:

1. generate a >=5M-nnz matrix (power-law web-graph archetype),
2. WRITE it as a real Matrix Market coordinate file,
3. run the full CLI workflow on the FILE PATH — the bytes go through
   io/mmio.py + native/mmio_parse.cpp, the converter, the device
   engines, and the full-vector check — with wall-time budgets asserted
   for the parse and convert stages.

Usage: python scripts/large_mtx_e2e.py [--nnz-min 5000000] [--keep]
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

PARSE_BUDGET_S = 60.0     # .mtx text parse (native mmio_parse.cpp)
CONVERT_BUDGET_S = 8.0    # CSR -> TileMatrix at ~6M nnz on one host core


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nnz-min", type=int, default=5_000_000)
    ap.add_argument("--keep", action="store_true",
                    help="keep the generated .mtx file")
    ap.add_argument("--no-device", action="store_true",
                    help="stop after conversion (no device stage)")
    args = ap.parse_args()

    import numpy as np

    from tilespmv_tpu.io import generate, mmio

    t0 = time.perf_counter()
    csr = generate.power_law(524288, 524288, 12, seed=42)
    nnz = int(csr.indptr[-1])
    assert nnz >= args.nnz_min, f"generator produced only {nnz} nnz"
    print(f"generated {csr.m}x{csr.n}, nnz={nnz} "
          f"[{time.perf_counter() - t0:.1f}s]")

    tmpdir = tempfile.mkdtemp(prefix="tilespmv_large_")
    path = os.path.join(tmpdir, "powerlaw_524288.mtx")
    t0 = time.perf_counter()
    mmio.save_mtx(path, csr)
    sz = os.path.getsize(path) / 1e6
    print(f"wrote {path} ({sz:.0f} MB) [{time.perf_counter() - t0:.1f}s]")

    try:
        # stage 1: file -> CSR through the real parser
        t0 = time.perf_counter()
        csr2 = mmio.load_mtx(path)
        t_parse = time.perf_counter() - t0
        print(f"parsed: nnz={int(csr2.indptr[-1])} [{t_parse:.1f}s]")
        assert t_parse < PARSE_BUDGET_S, \
            f"parse {t_parse:.1f}s over budget {PARSE_BUDGET_S}s"
        assert int(csr2.indptr[-1]) == nnz
        assert np.allclose(csr2.data[:100], csr.data[:100])

        # stage 2: conversion budget
        from tilespmv_tpu.core.convert import tile_create
        t0 = time.perf_counter()
        tm = tile_create(csr2)
        t_conv = time.perf_counter() - t0
        hist = {k: v for k, v in tm.format_histogram().items() if v}
        print(f"converted: {hist} [{t_conv:.1f}s]")
        assert t_conv < CONVERT_BUDGET_S, \
            f"convert {t_conv:.1f}s over budget {CONVERT_BUDGET_S}s"

        if args.no_device:
            return 0

        # stage 3: the reference CLI workflow on the file (device path,
        # full-vector check, timing; main.cu:63-197)
        from tilespmv_tpu import cli
        rc = cli.main([path, "--iters", "20", "--reps", "3",
                       "--warmup", "1", "--csv", ""])
        return rc
    finally:
        if not args.keep:
            try:
                os.remove(path)
                os.rmdir(tmpdir)
            except OSError:
                pass


if __name__ == "__main__":
    sys.exit(main())
