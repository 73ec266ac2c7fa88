"""Each engine of ops/xla_spmv.py against a dense product, in f32 and f64.

Every case builds a matrix whose tiles all land in one plan bucket (one
ELL width class, one CSR nnz class, ...), so the product exercises that
engine alone. Results are held to both gates of bench/check.py.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tilespmv_tpu import TileConfig, csr_from_coo, tile_create
from tilespmv_tpu.bench.check import gates
from tilespmv_tpu.io import generate
from tilespmv_tpu.ops.plan import CSR_NNZ_CLASSES, ELL_WIDTH_CLASSES
from tilespmv_tpu.ops.spmv import TileSpMV, spmv

B = 16


def _tiled(per_tile, n_tiles=24, grid=8, seed=0):
    """Matrix of `n_tiles` distinct tiles on a grid x grid tile grid;
    `per_tile(rng)` gives the (row, col) slots inside one tile."""
    rng = np.random.default_rng(seed)
    tiles = rng.choice(grid * grid, n_tiles, replace=False)
    rows, cols = [], []
    for t in tiles:
        r, c = per_tile(rng)
        rows.append((t // grid) * B + r)
        cols.append((t % grid) * B + c)
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = rng.standard_normal(rows.size)
    return csr_from_coo(grid * B, grid * B, rows, cols, vals)


def _ell_tiles(w):
    def per_tile(rng):
        r = np.repeat(np.arange(B), w)
        c = np.concatenate([rng.choice(B, w, replace=False)
                            for _ in range(B)])
        return r, c
    return per_tile


def _csr_tiles(nnz):
    def per_tile(rng):
        s = rng.choice(B * B, nnz, replace=False)
        return s // B, s % B
    return per_tile


# name -> (matrix, config, tile-matrix bucket that must hold every tile,
#          plan predicate naming the one engine that runs)
CASES = {
    "dense": (lambda: generate.dense_blocks(256, 256, num_blocks=24, seed=1),
              TileConfig(), "dns", lambda p: True),
    "rows": (lambda: generate.full_rows(256, 256, num_rows=5, seed=2),
             TileConfig(), "dnsrow", lambda p: True),
    "cols": (lambda: generate.full_cols(256, 256, num_cols=5, seed=3),
             TileConfig(), "dnscol", lambda p: True),
    "residual": (lambda: generate.random_uniform(256, 256, 0.002, seed=5),
                 TileConfig(force_format="coo"), "coo",
                 lambda p: not p.ells and not p.csrs),
}
for _w in ELL_WIDTH_CLASSES:
    CASES[f"ell_w{_w}"] = (
        lambda w=_w: _tiled(_ell_tiles(w), seed=w),
        TileConfig(force_format="ell"), "ell",
        lambda p, w=_w: [e.val.shape[1] for e in p.ells] == [w]
        and not p.csrs)
for _c in CSR_NNZ_CLASSES:
    CASES[f"csr_w{_c}"] = (
        lambda c=_c: _tiled(_csr_tiles(c), seed=c),
        TileConfig(force_format="csr"), "csr",
        lambda p, c=_c: [e.val.shape[1] for e in p.csrs] == [c]
        and not p.ells)

BUCKETS = ("csr", "coo", "ell", "hyb", "dns", "dnsrow", "dnscol")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", sorted(CASES))
def test_engine_matches_dense_product(name, dtype):
    make, cfg, bucket, plan_ok = CASES[name]
    csr = make()
    tm = tile_create(csr, cfg)
    counts = {k: getattr(tm, k).num_tiles for k in BUCKETS}
    assert counts[bucket] > 0 and sum(counts.values()) == counts[bucket], \
        counts
    op = TileSpMV(tm, config=cfg, compute_dtype=dtype)
    assert plan_ok(op.plan)
    x = np.random.default_rng(7).standard_normal(csr.n).astype(dtype)
    a = csr.to_dense().astype(np.float64)
    xd = x.astype(np.float64)
    g = gates(np.asarray(op(x)), a @ xd, np.abs(a) @ np.abs(xd), dtype)
    assert g["ok"], g


def _dot_generals(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for sub in jax.core.jaxprs_in_params(eqn.params):
            yield from _dot_generals(sub)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_every_dot_general_is_highest(dtype):
    """A float32 contraction on the GPU may run in TF32 unless asked
    for HIGHEST; every dot_general under spmv asks."""
    csr = generate.mixed_structure(512, 512, seed=1)
    op = TileSpMV(csr, compute_dtype=dtype)
    assert op.plan.csrs and op.tile_matrix.dns.num_tiles
    closed = jax.make_jaxpr(spmv)(op.plan, jnp.zeros(csr.n, dtype))
    dots = list(_dot_generals(closed.jaxpr))
    assert len(dots) >= 2
    for eqn in dots:
        prec = eqn.params["precision"]
        assert prec is not None and all(
            p == jax.lax.Precision.HIGHEST for p in prec), prec


def test_named_scope_per_bucket():
    """Each bucket's ops carry a stable scope name, which a profiler
    trace reports with the device time of the kernels it launches."""
    csr = generate.mixed_structure(512, 512, seed=1)
    op = TileSpMV(csr)
    text = spmv.lower(op.plan, jnp.zeros(csr.n, jnp.float32)).as_text(
        debug_info=True)
    names = ["dense", "cols", "rows", "residual"]
    names += [f"ell_w{e.val.shape[1]}" for e in op.plan.ells]
    names += [f"csr_w{e.val.shape[1]}" for e in op.plan.csrs]
    for name in names:
        assert f"/{name}/" in text, name
