"""Edge-shape hardening: tiny/ragged matrices through the device path."""
import numpy as np
import pytest

from tilespmv_tpu.io.mmio import CSRMatrix
from tilespmv_tpu.io import generate
from tilespmv_tpu.ops.spmv import TileSpMV


def _csr_from_dense(d):
    d = np.asarray(d, np.float64)
    m, n = d.shape
    indptr = np.zeros(m + 1, np.int64)
    cols, vals = [], []
    for i in range(m):
        nz = np.nonzero(d[i])[0]
        indptr[i + 1] = indptr[i] + nz.size
        cols.append(nz)
        vals.append(d[i, nz])
    return CSRMatrix((m, n), indptr,
                     np.concatenate(cols).astype(np.int64),
                     np.concatenate(vals))


def _check(csr, rtol=2e-4):
    op = TileSpMV(csr)
    x = np.linspace(-1, 1, csr.n).astype(np.float32)
    y = np.asarray(op(x))
    ref = csr.to_dense().astype(np.float64) @ x
    np.testing.assert_allclose(y, ref, rtol=rtol, atol=1e-4)


@pytest.mark.parametrize("m,n", [(16, 16), (16, 4096), (4096, 16),
                                 (17, 33), (1024, 100), (100, 1024)])
def test_ragged_shapes(m, n):
    rng = np.random.default_rng(m * 1000 + n)
    d = np.where(rng.random((m, n)) < 0.05, rng.standard_normal((m, n)), 0)
    # truncate_rows_to_tile drops trailing rows like reference main.cu:71;
    # keep shapes honest by comparing against the truncated matrix
    csr = _csr_from_dense(d)
    op = TileSpMV(csr)
    x = np.linspace(-1, 1, n).astype(np.float32)
    y = np.asarray(op(x))
    m_t = op.shape[0]
    ref = (d[:m_t].astype(np.float64) @ x)
    np.testing.assert_allclose(y, ref, rtol=2e-4, atol=1e-4)


def test_single_tile():
    d = np.zeros((16, 16))
    d[3, 5] = 2.5
    d[15, 15] = -1.0
    _check(_csr_from_dense(d))


def test_single_dense_row_matrix():
    d = np.zeros((16, 64))
    d[7, :] = np.arange(64) * 0.25
    _check(_csr_from_dense(d))


def test_empty_rows_and_cols():
    d = np.zeros((64, 64))
    d[0, 63] = 1.0
    d[63, 0] = 2.0
    _check(_csr_from_dense(d))


def test_halo_ragged_n():
    from tilespmv_tpu.parallel import DistributedSpMV, make_mesh
    mesh = make_mesh(8)
    rng = np.random.default_rng(3)
    m, n = 1024, 900          # n not a multiple of ndev*128
    d = np.where(rng.random((m, n)) < 0.01, rng.standard_normal((m, n)), 0)
    csr = _csr_from_dense(d)
    op = DistributedSpMV(csr, mesh=mesh, x_mode="halo")
    x = np.linspace(-1, 1, n).astype(np.float32)
    y = np.asarray(op(x))
    ref = d.astype(np.float64) @ x
    np.testing.assert_allclose(y, ref, rtol=2e-4, atol=1e-4)


def test_benchmark_column_partitioned():
    """benchmark_op on a wide operator; the CPU has no roofline entry,
    so the roofline share is None and the device is named."""
    import jax
    from tilespmv_tpu.bench.harness import benchmark_op
    csr = generate.mixed_structure(256, 1024, seed=9)
    op = TileSpMV(csr)
    res = benchmark_op(op, warmup=1, timed_reps=1, iters_per_rep=2,
                       budget_s=0.0)   # no escalation: smoke only
    assert res.nnz == csr.nnz and res.ms > 0
    assert res.n == 1024
    assert res.roofline_frac is None
    assert res.device == jax.devices()[0].device_kind


def test_empty_matrix():
    csr = CSRMatrix((64, 64), np.zeros(65, np.int64),
                    np.zeros(0, np.int64), np.zeros(0))
    from tilespmv_tpu import tile_create, spmv_cpu
    tm = tile_create(csr)
    assert np.abs(spmv_cpu(tm, np.ones(64))).max() == 0.0
    op = TileSpMV(csr)
    assert np.abs(np.asarray(op(np.ones(64, np.float32)))).max() == 0.0


def test_single_entry_matrix():
    indptr = np.zeros(33, np.int64)
    indptr[5:] = 1       # one entry in row 4
    csr = CSRMatrix((32, 32), indptr, np.array([7], np.int64),
                    np.array([2.5]))
    op = TileSpMV(csr)
    y = np.asarray(op(np.arange(32, dtype=np.float32)))
    assert abs(y[4] - 17.5) < 1e-5 and np.abs(np.delete(y, 4)).max() == 0


def test_spmv_cpu_validates_x_length():
    from tilespmv_tpu import tile_create, spmv_cpu
    csr = generate.mixed_structure(256, 300, seed=3)
    tm = tile_create(csr)
    with pytest.raises(ValueError, match="expected"):
        spmv_cpu(tm, np.zeros(299))
