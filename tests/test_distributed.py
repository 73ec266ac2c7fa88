"""Distributed SpMV tests on the virtual 8-device CPU mesh."""
import numpy as np
import pytest

import jax

from tilespmv_tpu.io import generate
from tilespmv_tpu.parallel import DistributedSpMV, make_mesh


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    return make_mesh(8)


@pytest.mark.parametrize("x_mode", ["allgather", "replicated"])
def test_distributed_matches_golden(mesh8, x_mode):
    csr = generate.mixed_structure(1024, 1024, seed=3)
    op = DistributedSpMV(csr, mesh=mesh8, x_mode=x_mode)
    x = np.linspace(-1, 1, 1024).astype(np.float32)
    y = np.asarray(op(x))
    y_golden = csr.to_dense().astype(np.float32) @ x
    np.testing.assert_allclose(y, y_golden, rtol=1e-4, atol=1e-4)


def test_distributed_uneven_rows(mesh8):
    # m not divisible by ndev*16: last shard is mostly padding
    csr = generate.mixed_structure(1000, 777, seed=4)
    op = DistributedSpMV(csr, mesh=mesh8)
    x = np.linspace(0.5, 1.5, 777).astype(np.float32)
    y = np.asarray(op(x))
    np.testing.assert_allclose(y, csr.to_dense().astype(np.float32) @ x,
                               rtol=1e-4, atol=1e-4)


def test_distributed_output_sharding(mesh8):
    csr = generate.banded(2048, 2048, 4, seed=5)
    op = DistributedSpMV(csr, mesh=mesh8)
    x = np.ones(2048, np.float32)
    y = op(x)
    # y rows land on the device owning them
    assert len(y.sharding.device_set) == 8


def test_distributed_small_mesh():
    mesh = make_mesh(2)
    csr = generate.mixed_structure(256, 256, seed=6)
    op = DistributedSpMV(csr, mesh=mesh)
    x = np.linspace(-1, 1, 256).astype(np.float32)
    np.testing.assert_allclose(np.asarray(op(x)),
                               csr.to_dense().astype(np.float32) @ x,
                               rtol=1e-4, atol=1e-4)


def test_halo_exchange_banded(mesh8=None):
    """Selective x exchange (SURVEY §2.3): banded matrices need only
    neighbor blocks, so halo traffic is far below an all-gather."""
    from tilespmv_tpu.parallel import DistributedSpMV, make_mesh
    mesh = make_mesh(8)
    csr = generate.get_matrix("banded_medium")
    x = np.linspace(-1, 1, csr.n).astype(np.float32)
    golden = csr.to_dense().astype(np.float64) @ x
    op = DistributedSpMV(csr, mesh=mesh, x_mode="halo")
    y = np.asarray(op(x))
    err = np.max(np.abs(y - golden) / (1 + np.abs(golden)))
    assert err < 1e-4
    assert op.halo is not None
    assert op.halo.traffic_ratio < 0.5  # near-diagonal: tiny packets


def test_halo_auto_fallback():
    """auto picks all-gather when packets would not be smaller."""
    from tilespmv_tpu.parallel import DistributedSpMV, make_mesh
    mesh = make_mesh(8)
    csr = generate.mixed_structure(16 * 8 * 16, 16 * 8 * 16, seed=1)
    op = DistributedSpMV(csr, mesh=mesh, x_mode="auto")
    assert op.x_mode == "allgather"
    op2 = DistributedSpMV(csr, mesh=mesh, x_mode="halo")
    x = np.linspace(-1, 1, csr.n).astype(np.float32)
    golden = csr.to_dense().astype(np.float64) @ x
    y = np.asarray(op2(x))
    assert np.max(np.abs(y - golden) / (1 + np.abs(golden))) < 1e-4


@pytest.mark.parametrize("grid", [(2, 4), (4, 2), (1, 8)])
def test_2d_block_partition(grid):
    """2-D block partition: x sharded P('col') with zero exchange, y
    reduced with one psum over the column axis (SURVEY §5)."""
    from tilespmv_tpu.parallel import DistributedSpMV2D, make_mesh2d
    mesh = make_mesh2d(*grid)
    csr = generate.mixed_structure(1024, 2048, seed=5)
    x = np.linspace(-1, 1, csr.n).astype(np.float32)
    golden = csr.to_dense().astype(np.float64) @ x
    op = DistributedSpMV2D(csr, mesh=mesh)
    y = np.asarray(op(x))
    err = np.max(np.abs(y - golden) / (1 + np.abs(golden)))
    assert err < 1e-4


def test_scaling_sweep_smoke(mesh8):
    """Scaling harness runs end to end on the virtual mesh (absolute
    numbers are CPU-meaningless; shapes/efficiency plumbing is what's
    under test)."""
    from tilespmv_tpu.bench.scaling import scaling_sweep
    csr = generate.mixed_structure(1024, 1024, seed=3)
    pts = scaling_sweep(csr, device_counts=[1, 2, 4], verbose=False)
    assert [p.n_devices for p in pts] == [1, 2, 4]
    assert all(p.ms > 0 and p.gflops > 0 for p in pts)
    assert abs(pts[0].efficiency - 1.0) < 1e-9


def test_distributed_stream_concentrated_in_one_shard(mesh8):
    """All COO (residual) entries live in the first shard's rows; the
    other shards' empty residual engines are padded to the same shape so
    the stacked plans share one treedef."""
    from tilespmv_tpu.io.mmio import CSRMatrix
    rng = np.random.default_rng(13)
    m = n = 8192                        # 8 shards x 1024 rows
    nnz = 6000
    r = rng.integers(0, 1024, nnz).astype(np.int64)   # shard 0 only
    c = rng.integers(0, n, nnz).astype(np.int64)
    key = np.unique(r * n + c)
    r, c = key // n, key % n
    v = rng.standard_normal(r.size)
    indptr = np.concatenate(
        [[0], np.cumsum(np.bincount(r, minlength=m))]).astype(np.int64)
    csr = CSRMatrix((m, n), indptr, c.astype(np.int64), v)
    op = DistributedSpMV(csr, mesh=mesh8, x_mode="allgather")
    x = np.linspace(-1, 1, n).astype(np.float32)
    y = np.asarray(op(x))
    ref = np.zeros(m)
    np.add.at(ref, r, v * x[c].astype(np.float64))
    np.testing.assert_allclose(y, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("x_mode", ["allgather", "halo"])
def test_distributed_df64(mesh8, x_mode):
    """f64 (reference default precision) under the SPMD row partition:
    the unifier must carry the f64 value dtype through its empties and
    pads."""
    if not jax.config.jax_enable_x64:
        pytest.skip("x64 disabled")
    csr = generate.mixed_structure(2048, 2048, seed=5)
    op = DistributedSpMV(csr, mesh=mesh8, x_mode=x_mode,
                         compute_dtype=np.float64)
    x = np.linspace(-1, 1, 2048)
    y = np.asarray(op(x))
    ref = csr.to_dense().astype(np.float64) @ x
    mag = np.abs(csr.to_dense()) @ np.abs(x)
    assert np.max(np.abs(y - ref) / (1 + mag)) < 1e-10


def test_distributed2d_df64():
    if not jax.config.jax_enable_x64:
        pytest.skip("x64 disabled")
    from tilespmv_tpu.parallel import DistributedSpMV2D, make_mesh2d
    csr = generate.mixed_structure(2048, 2048, seed=5)
    op = DistributedSpMV2D(csr, mesh=make_mesh2d(2, 4),
                           compute_dtype=np.float64)
    x = np.linspace(-1, 1, 2048)
    y = np.asarray(op(x))
    ref = csr.to_dense().astype(np.float64) @ x
    mag = np.abs(csr.to_dense()) @ np.abs(x)
    assert np.max(np.abs(y - ref) / (1 + mag)) < 1e-10


def test_distributed_bf16(mesh8):
    import jax.numpy as jnp
    csr = generate.mixed_structure(2048, 2048, seed=5)
    op = DistributedSpMV(csr, mesh=mesh8, compute_dtype=jnp.bfloat16)
    x = np.linspace(-1, 1, 2048).astype(np.float32)
    y = np.asarray(op(x)).astype(np.float64)
    ref = csr.to_dense().astype(np.float64) @ x.astype(np.float64)
    assert np.max(np.abs(y - ref) / (np.abs(ref) + 1.0)) < 0.05
