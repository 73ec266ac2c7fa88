"""Compute-dtype coverage: f32 (default), f64 (reference parity,
MAT_VAL_TYPE double, common.h:12) in native double precision, bf16."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tilespmv_tpu.bench.check import gates, golden
from tilespmv_tpu.io import generate
from tilespmv_tpu.ops.spmv import TileSpMV


def _golden(csr, x):
    return csr.to_dense().astype(np.float64) @ x.astype(np.float64)


def _check_f64(csr, seed):
    op = TileSpMV(csr, compute_dtype=jnp.float64)
    assert op.plan.dense.val.dtype == jnp.float64
    x = np.random.default_rng(seed).standard_normal(csr.n)
    ref, mag = golden(csr, x)
    g = gates(np.asarray(op(x)), ref, mag, np.float64)
    assert g["ok"], g
    return op


def test_f64_mixed_stays_on_pallas():
    """f64 on a matrix needing every engine family runs in native
    double precision, at the f64 scaled gate."""
    if not jax.config.jax_enable_x64:
        pytest.skip("x64 disabled in this session")
    op = _check_f64(generate.mixed_structure(512, 512, seed=7), 0)
    assert op.plan.csrs and op.plan.ells


def test_f64_stream_engine_df64():
    """A power-law matrix (COO tiles; the reference extracts these into
    double-precision CSR5, external/CSR5_cuda/anonymouslib_cuda.h:12)
    runs f64 through the residual engine."""
    if not jax.config.jax_enable_x64:
        pytest.skip("x64 disabled in this session")
    op = _check_f64(generate.power_law(4096, 4096, 12, seed=3), 1)
    assert op.tile_matrix.residual.nnz > 0


def test_f64_requires_x64_flag():
    if jax.config.jax_enable_x64:
        pytest.skip("x64 already on")
    csr = generate.mixed_structure(256, 256, seed=7)
    with pytest.raises(ValueError, match="x64"):
        TileSpMV(csr, compute_dtype=jnp.float64)


def test_bf16_pallas_path():
    csr = generate.mixed_structure(512, 512, seed=7)
    op = TileSpMV(csr, compute_dtype=jnp.bfloat16)
    x = np.random.default_rng(0).standard_normal(csr.n)
    y = np.asarray(op(x).astype(jnp.float32))
    ref = _golden(csr, x)
    rel = np.max(np.abs(y - ref) / (1 + np.abs(ref)))
    assert rel < 0.05  # bf16 mantissa: ~0.4% typical, 5% safe bound


def test_f32_precision_is_better_than_bf16():
    # guards the contraction precision: a bf16 or TF32 pass would make
    # f32 no better than the scaled gate allows
    csr = generate.mixed_structure(512, 512, seed=7)
    x = np.random.default_rng(0).standard_normal(csr.n).astype(np.float32)
    ref, mag = golden(csr, x)
    y32 = np.asarray(TileSpMV(csr, compute_dtype=jnp.float32)(x))
    g = gates(y32, ref, mag, np.float32)
    assert g["ok"], g


def test_f64_banded_routes_to_pallas_df64():
    """Band/dense-only matrices run f64 at near-f64 accuracy against the
    magnitude-sum (cancellation-free) error measure."""
    if not jax.config.jax_enable_x64:
        pytest.skip("x64 disabled in this session")
    _check_f64(generate.banded(2048, 2048, 8, seed=3), 1)


def test_f64_dense_blocks_pallas_df64():
    if not jax.config.jax_enable_x64:
        pytest.skip("x64 disabled in this session")
    op = _check_f64(generate.dense_blocks(1024, 1024, num_blocks=24,
                                          seed=5), 2)
    assert op.tile_matrix.dns.num_tiles > 0
