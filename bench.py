"""Benchmark entry point.

Prints ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": ..., "per_matrix_ms": {...},
   "roofline_frac": N or null, "device": {...}}

Metric: aggregate SpMV GFLOPS (2*nnz/t, the reference's headline metric,
tilespmv_cuda.h:1138) over the large synthetic corpus in float32 on the
default device, with the float64 rows (the reference's default
precision, common.h:12-14) timed beside it. `roofline_frac` is the
achieved share of the device's peak memory bandwidth over the
information-theoretic byte floor — 5 bytes/nnz (4B value + 1B packed
index, the reference's nibble-compacted format, encode.h:29-50) plus one
read of x and one write of y — NOT over the plan's padded traffic, so
plan padding lowers it instead of inflating it. It is null on the CPU,
which has no roofline entry (bench/roofline.py).

Correctness gate: the FULL y vector of every row, f32 and f64, is held
to both gates of bench/check.py before it is timed; a failure raises.
Per-matrix times go to stderr.
"""
import json
import sys


FLAGSHIP = ["banded_large", "powerlaw_large", "mixed_large"]
IDEAL_BYTES_PER_NNZ = 5.0    # 4B f32 value + 1B intra-tile index


def main() -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tilespmv_tpu.bench import roofline
    from tilespmv_tpu.bench.check import gates, golden
    from tilespmv_tpu.bench.harness import benchmark_op
    from tilespmv_tpu.io import generate
    from tilespmv_tpu.ops.spmv import TileSpMV
    from tilespmv_tpu.utils.jax_cache import configure_compile_cache

    configure_compile_cache()
    jax.config.update("jax_enable_x64", True)
    dev = jax.devices()[0]

    per_ms = {}
    agg_flops = agg_time = agg_ideal_bytes = 0.0
    for name in FLAGSHIP:
        csr = generate.get_matrix(name)
        tm = None
        for dtype in (jnp.float32, jnp.float64):
            op = TileSpMV(tm if tm is not None else csr,
                          compute_dtype=dtype)
            tm = op.tile_matrix          # convert once, plan per dtype
            x = ((np.arange(csr.n) % 10) / 4.0).astype(dtype)
            ref, mag = golden(csr, x)
            g = gates(np.asarray(op(x)), ref, mag, dtype)
            if not g["ok"]:
                raise AssertionError(
                    f"{name} {np.dtype(dtype).name}: correctness gates "
                    f"failed: {g}")
            res = benchmark_op(op, x=x, name=name, warmup=2, timed_reps=5,
                               iters_per_rep=50, min_delta_s=0.4,
                               max_spread=0.10, budget_s=8.0)
            key = f"{name}_{np.dtype(dtype).name}"
            per_ms[key] = res.ms
            print(f"# {key}: {res.ms} ms  {res.gflops} GFLOPS  "
                  f"{res.gbytes_per_s} GB/s plan traffic  "
                  f"scaled_err={g['scaled_err']}  "
                  f"reliable={res.reliable}", file=sys.stderr)
            if dtype == jnp.float32:
                agg_flops += 2.0 * res.nnz
                agg_time += res.ms * 1e-3
                agg_ideal_bytes += (res.nnz * IDEAL_BYTES_PER_NNZ
                                    + 4.0 * (csr.n + csr.m))

    peak = roofline.peak_for(dev)
    print(json.dumps({
        "metric": "spmv_gflops_large_corpus",
        "value": agg_flops / agg_time / 1e9,
        "unit": "GFLOPS",
        "per_matrix_ms": per_ms,
        "roofline_frac": (None if peak is None else
                          agg_ideal_bytes / agg_time / 1e9 / peak.hbm_gbps),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
