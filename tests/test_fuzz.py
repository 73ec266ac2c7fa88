"""Property-based fuzz: random matrices x random configs, CPU engine
exact vs golden and the device path within f32 tolerance (the reference's
check discipline, main.cu:101-110 / 186-197, across the config space)."""
import numpy as np
import pytest

from tilespmv_tpu import TileConfig, tile_create
from tilespmv_tpu.io.mmio import CSRMatrix
from tilespmv_tpu.ops.cpu_reference import spmv_cpu
from tilespmv_tpu.ops.spmv import TileSpMV


def _random_csr(rng):
    m = int(rng.integers(16, 400))
    n = int(rng.integers(16, 400))
    style = rng.integers(0, 4)
    d = np.zeros((m, n))
    if style == 0:      # uniform sparse
        mask = rng.random((m, n)) < float(rng.uniform(0.002, 0.1))
        d = np.where(mask, rng.standard_normal((m, n)), 0.0)
    elif style == 1:    # banded
        for k in range(-3, 4):
            idx = np.arange(max(0, -k), min(m, n - k))
            d[idx, idx + k] = rng.standard_normal(idx.size)
    elif style == 2:    # dense row/col stripes + noise
        d[rng.integers(0, m)] = rng.standard_normal(n)
        d[:, rng.integers(0, n)] = rng.standard_normal(m)
        mask = rng.random((m, n)) < 0.01
        d = np.where(mask, rng.standard_normal((m, n)), d)
    else:               # power-law-ish rows
        for i in range(m):
            k = min(n, 1 + int(rng.pareto(1.2)))
            cols = rng.choice(n, size=k, replace=False)
            d[i, cols] = rng.standard_normal(k)
    rows, cols = np.nonzero(d)
    indptr = np.zeros(m + 1, np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    return CSRMatrix((m, n), indptr, cols.astype(np.int64), d[rows, cols])


def _random_config(rng):
    return TileConfig(
        coo_nnz_threshold=int(rng.integers(4, 16)),
        dense_threshold=float(rng.uniform(0.5, 0.9)),
        ell_cv_threshold=float(rng.uniform(0.1, 0.4)),
        enable_hyb=bool(rng.integers(0, 2)),
    )


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_configs_and_structures(seed):
    rng = np.random.default_rng(1000 + seed)
    csr = _random_csr(rng)
    cfg = _random_config(rng)
    tm = tile_create(csr, cfg)
    m_t = tm.shape[0]
    x = rng.standard_normal(csr.n)
    golden = csr.to_dense()[:m_t].astype(np.float64) @ x
    # CPU engine: exact against scalar golden on the same fp64 data
    y_cpu = spmv_cpu(tm, x)
    np.testing.assert_allclose(y_cpu, golden, rtol=1e-12, atol=1e-12)
    # device path: f32 tolerance
    op = TileSpMV(tm, config=cfg)
    y_dev = np.asarray(op(x.astype(np.float32)))
    np.testing.assert_allclose(y_dev, golden, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_configs_and_structures_f64(seed):
    """The same random cases in native f64, at the f64 scaled gate."""
    import jax.numpy as jnp
    from tilespmv_tpu.bench.check import gates, golden
    rng = np.random.default_rng(1000 + seed)
    csr = _random_csr(rng)
    cfg = _random_config(rng)
    tm = tile_create(csr, cfg)
    x = rng.standard_normal(csr.n)
    ref, mag = golden(csr, x)
    y = np.asarray(TileSpMV(tm, config=cfg, compute_dtype=jnp.float64)(x))
    g = gates(y, ref[: tm.shape[0]], mag[: tm.shape[0]], np.float64)
    assert g["ok"], g


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_distributed(seed):
    """Random structures through the distributed paths on the virtual
    mesh: halo (overlapped), allgather, and the 2-D block partition."""
    import jax
    from tilespmv_tpu.parallel import (DistributedSpMV, DistributedSpMV2D,
                                       make_mesh, make_mesh2d)
    assert len(jax.devices()) >= 8
    rng = np.random.default_rng(2000 + seed)
    csr = _random_csr(rng)
    # pad rows so every shard gets tile-aligned work
    x = rng.standard_normal(csr.n).astype(np.float32)
    golden = csr.to_dense().astype(np.float64) @ x

    op = DistributedSpMV(csr, mesh=make_mesh(4), x_mode="halo")
    y = np.asarray(op(x))[: golden.shape[0]]
    np.testing.assert_allclose(y, golden[: y.shape[0]], rtol=2e-4,
                               atol=2e-4)

    op = DistributedSpMV(csr, mesh=make_mesh(4), x_mode="allgather")
    y2 = np.asarray(op(x))[: golden.shape[0]]
    np.testing.assert_allclose(y2, golden[: y2.shape[0]], rtol=2e-4,
                               atol=2e-4)

    op3 = DistributedSpMV2D(csr, mesh=make_mesh2d(2, 2))
    y3 = np.asarray(op3(x))[: golden.shape[0]]
    np.testing.assert_allclose(y3, golden[: y3.shape[0]], rtol=2e-4,
                               atol=2e-4)
