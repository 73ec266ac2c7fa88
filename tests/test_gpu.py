"""Tests that need a CUDA card: the compiled device path at moderate size.

Run on a card with `JAX_PLATFORMS=cuda pytest -m gpu tests/` (chip_smoke.py
runs them first); they skip where JAX finds no card.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tilespmv_tpu.bench.check import gates, golden
from tilespmv_tpu.bench.roofline import peak_for
from tilespmv_tpu.io import generate
from tilespmv_tpu.ops import xla_spmv
from tilespmv_tpu.ops.spmv import TileSpMV

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("name", ["mixed_medium", "powerlaw_medium",
                                  "banded_medium", "dense_blocks_medium"])
def test_spmv_on_card(gpu_device, name, dtype):
    csr = generate.get_matrix(name)
    op = TileSpMV(csr, compute_dtype=dtype)
    x = np.random.default_rng(0).standard_normal(csr.n).astype(dtype)
    y = op(jax.device_put(x, gpu_device))
    assert gpu_device in y.devices()
    g = gates(np.asarray(y), *golden(csr, x), dtype)
    assert g["ok"], g


def test_dense_contraction_is_not_tf32(gpu_device):
    """The dense engine alone, f32 on the card, at the f32 scaled gate
    that a TF32 product misses by about 100x."""
    csr = generate.dense_blocks(4096, 4096, num_blocks=2048, seed=6)
    op = TileSpMV(csr)
    assert op.tile_matrix.dns.num_tiles > 0
    x = np.random.default_rng(1).standard_normal(csr.n).astype(np.float32)
    x2d = jnp.zeros(op.plan.x_padded_len, jnp.float32).at[: csr.n].set(
        x).reshape(op.plan.tilen, op.plan.tile_size)
    blocks = np.asarray(jax.jit(xla_spmv.dense_blocks)(op.plan.dense, x2d))
    want = np.einsum("tij,tj->ti", np.asarray(op.plan.dense.val, np.float64),
                     np.asarray(x2d, np.float64)[np.asarray(
                         op.plan.dense.tilecol)])
    mag = np.einsum("tij,tj->ti",
                    np.abs(np.asarray(op.plan.dense.val, np.float64)),
                    np.abs(np.asarray(x2d, np.float64))[np.asarray(
                        op.plan.dense.tilecol)])
    err = np.abs(blocks - want) / np.where(mag > 0, mag, 1.0)
    assert err.max() <= 1e-5, err.max()


def test_roofline_entry_for_card(gpu_device):
    peak = peak_for(gpu_device)
    assert peak.hbm_gbps > 0 and peak.fp64_gflops > 0
