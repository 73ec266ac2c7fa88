"""Execution-plan + XLA engine tests (SpMV on the JAX path)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tilespmv_tpu import TileConfig, csr_from_coo, tile_create
from tilespmv_tpu.io import generate
from tilespmv_tpu.ops.plan import build_plan
from tilespmv_tpu.ops.spmv import TileSpMV, spmv


def _check(csr, rtol=1e-5, **kwargs):
    tm = tile_create(csr, kwargs.pop("config", TileConfig()))
    op = TileSpMV(tm, **kwargs)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(csr.n).astype(np.float32)
    y = np.asarray(op(x))
    y_golden = csr.to_dense().astype(np.float32) @ x
    # reference tolerance gate: |y_g - y| <= 0.01|y| (main.cu:186-197);
    # we check much tighter
    np.testing.assert_allclose(y, y_golden, rtol=rtol, atol=1e-4)
    return op


# Small instances of every corpus archetype: conversion + XLA compile must
# stay fast on the CPU test runner; the full-size corpus runs in
# bench/sweep on the card.
ARCHETYPES = {
    "mixed": lambda: generate.mixed_structure(512, 512, seed=1),
    "banded": lambda: generate.banded(1024, 1024, 8, seed=2),
    "uniform": lambda: generate.random_uniform(1024, 1024, 0.002, seed=3),
    "powerlaw": lambda: generate.power_law(1024, 1024, 12, seed=4),
    "ell": lambda: generate.ell_regular(1024, 1024, 7, seed=5),
    "dense_blocks": lambda: generate.dense_blocks(512, 512, num_blocks=128,
                                                  seed=6),
}


@pytest.mark.parametrize("name", sorted(ARCHETYPES))
def test_corpus_spmv_xla(name):
    _check(ARCHETYPES[name]())


@pytest.mark.parametrize("name", sorted(ARCHETYPES))
def test_corpus_spmv_xla_f64(name):
    """Native f64 (the reference's MAT_VAL_TYPE double) on every
    archetype, held to the f64 scaled gate (bench/check.py)."""
    from tilespmv_tpu.bench.check import gates, golden
    csr = ARCHETYPES[name]()
    op = TileSpMV(csr, compute_dtype=jnp.float64)
    x = np.random.default_rng(0).standard_normal(csr.n)
    ref, mag = golden(csr, x)
    g = gates(np.asarray(op(x)), ref, mag, np.float64)
    assert g["ok"], g


def test_partial_tile_shapes():
    _check(generate.mixed_structure(1000, 777, seed=11))


def test_single_format_matrices():
    # dense-only
    _check(generate.dense_blocks(256, 256, num_blocks=64, seed=1))
    # full rows only
    _check(generate.full_rows(256, 256, num_rows=5, seed=2))
    # full cols only
    _check(generate.full_cols(256, 256, num_cols=5, seed=3))
    # ELL only
    _check(generate.ell_regular(256, 256, 4, seed=4))
    # COO/residual only
    _check(generate.random_uniform(256, 256, 0.002, seed=5))


def test_hyb_plan():
    cfg = TileConfig(enable_hyb=True, hyb_cv_threshold=0.3, hyb_max_coo=64)
    csr = generate.power_law(256, 256, 20, seed=6)
    _check(csr, config=cfg)


def test_plan_shapes_are_padded():
    csr = generate.mixed_structure(256, 256, seed=0)
    tm = tile_create(csr)
    plan = build_plan(tm, pad_tiles_to=8)
    assert plan.dense.val.shape[0] % 8 == 0
    for e in plan.csrs:
        assert e.val.shape[0] % 8 == 0
        assert e.val.shape == e.rowcol.shape
    for e in plan.ells:
        assert e.val.shape == e.col.shape


def test_spmv_is_jittable_and_stable():
    csr = generate.mixed_structure(512, 512, seed=1)
    op = TileSpMV(csr)
    x = np.linspace(-1, 1, 512).astype(np.float32)
    y1 = np.asarray(op(x))
    y2 = np.asarray(op(x))
    np.testing.assert_array_equal(y1, y2)  # deterministic


def test_wrong_x_shape_raises():
    csr = generate.mixed_structure(64, 64, seed=0)
    op = TileSpMV(csr)
    with pytest.raises(ValueError, match="expected"):
        op(np.ones(10, np.float32))


def test_bytes_and_flops_reporting():
    csr = generate.mixed_structure(512, 512, seed=2)
    op = TileSpMV(csr)
    assert op.flops() == 2 * csr.nnz
    assert op.bytes_accessed() > 0


def test_f64_on_cpu():
    csr = generate.mixed_structure(128, 128, seed=3)
    with jax.enable_x64(True):
        op = TileSpMV(csr, compute_dtype=jnp.float64)
        x = np.linspace(0, 1, 128)
        y = np.asarray(op(x))
    np.testing.assert_allclose(y, csr.to_dense() @ x, rtol=1e-12)


def test_bf16_tolerance():
    csr = generate.banded(256, 256, 4, seed=4)
    op = TileSpMV(csr, compute_dtype=jnp.bfloat16)
    x = np.ones(256, np.float32)
    y = np.asarray(op(x).astype(jnp.float32))
    y_golden = csr.to_dense() @ x
    # 1% relative gate, the reference's own tolerance (main.cu:186-197)
    err = np.abs(y - y_golden) > 0.01 * np.abs(y_golden) + 1e-3
    assert not err.any()


def test_column_partitioned_wide_matrix():
    """A matrix wider than 2^21 columns runs as one plan, not as column
    parts."""
    rng = np.random.default_rng(9)
    m, n = 64, (1 << 21) + 100
    rows = rng.integers(0, m, 400)
    cols = np.concatenate([rng.integers(0, n, 396), [0, n - 1, n - 2, 7]])
    csr = csr_from_coo(m, n, rows, cols, rng.standard_normal(400))
    op = TileSpMV(csr)
    assert op.shape == (m, n) and op.plan.n == n
    x = rng.standard_normal(n)
    y = np.asarray(op(x))
    ref = csr.matvec(x.astype(np.float32).astype(np.float64))
    np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-5)
    assert op.flops() == 2 * csr.nnz


@pytest.mark.parametrize("fmt", ["csr", "coo", "ell", "dns"])
def test_forced_format_pallas(fmt):
    """BASELINE config 2: forced-format mode through the device path."""
    csr = generate.mixed_structure(256, 256, seed=12)
    cfg = TileConfig(force_format=fmt)
    op = TileSpMV(csr, config=cfg)
    hist = op.tile_matrix.format_histogram()
    assert set(k for k, v in hist.items() if v) <= {fmt}
    x = np.linspace(-1, 1, csr.n).astype(np.float32)
    y = np.asarray(op(x))
    ref = csr.to_dense().astype(np.float64) @ x
    np.testing.assert_allclose(y, ref, rtol=2e-4, atol=1e-4)


def test_spmm_multivector():
    """Y = A @ X (SpMM API; beyond-reference capability)."""
    csr = generate.mixed_structure(256, 256, seed=4)
    op = TileSpMV(csr)
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((csr.n, 5)).astype(np.float32)
    ys = np.asarray(op.matmat(xs))
    ref = csr.to_dense().astype(np.float64) @ xs
    np.testing.assert_allclose(ys, ref, rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("k", [1, 17])
def test_spmm_banded_edge_widths(k):
    """matmat with one column and with an odd width on a band-only
    matrix, against the golden."""
    csr = generate.banded(2048, 2048, 12, seed=11)
    op = TileSpMV(csr)
    rng = np.random.default_rng(4)
    xs = rng.standard_normal((csr.n, k)).astype(np.float32)
    Y = np.asarray(op.matmat(xs))
    ref = csr.to_dense().astype(np.float64) @ xs
    assert np.max(np.abs(Y - ref) / (1 + np.abs(ref))) < 1e-4


def test_fused_band_spmm_matches_golden():
    """matmat (k = 8) on a band-only matrix against the golden."""
    k = 8
    csr = generate.banded(2048, 2048, 12, seed=11)
    op = TileSpMV(csr)
    rng = np.random.default_rng(4)
    xs = rng.standard_normal((csr.n, k)).astype(np.float32)
    Y = np.asarray(op.matmat(xs))
    ref = csr.to_dense().astype(np.float64) @ xs
    assert np.max(np.abs(Y - ref) / (1 + np.abs(ref))) < 1e-4


def test_transpose_operator_and_matmul():
    """op.T = the transposed operator (lazy, cached, involutive);
    rmatvec and @ follow the scipy LinearOperator conventions. The
    transpose is planned from the source CSR via csr_transpose (the
    reference's CSR->CSC pass, utils.h:172-211)."""
    csr = generate.rectangular(512, 192, 6, seed=9)
    op = TileSpMV(csr)
    t = op.T
    assert t.shape == (192, 512) and op.T is t and t.T is op
    y = ((np.arange(512) % 7) / 3.0).astype(np.float32)
    ref = csr.to_dense().T.astype(np.float64) @ y
    np.testing.assert_allclose(np.asarray(t(y), np.float64), ref,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(op.rmatvec(y), np.float64),
                               ref, rtol=1e-4, atol=1e-5)
    # @ dispatches on rank
    x = ((np.arange(192) % 5) / 2.0).astype(np.float32)
    np.testing.assert_allclose(np.asarray(op @ x),
                               np.asarray(op(x)), rtol=0, atol=0)
    xs = np.stack([x, 2 * x], axis=1)
    assert (op @ xs).shape == (512, 2)
    # TileMatrix-built operators cannot transpose (no source CSR)
    op2 = TileSpMV(tile_create(csr))
    with pytest.raises(ValueError, match="source CSRMatrix"):
        _ = op2.T
