"""Native converter parity tests: the C++ analysis must reproduce the
NumPy analysis bit-for-bit (tile table, histograms, selector decisions,
sorted streams)."""
import numpy as np
import pytest

from tilespmv_tpu import TileConfig, tile_create
from tilespmv_tpu.core import native
from tilespmv_tpu.io import generate

pytestmark = pytest.mark.skipif(not native.native_available(),
                                reason="native library unavailable")


def _compare(csr, config=TileConfig()):
    tm_np = tile_create(csr, config, use_native=False)
    tm_cc = tile_create(csr, config, use_native=True)
    np.testing.assert_array_equal(tm_cc.tile_ptr, tm_np.tile_ptr)
    np.testing.assert_array_equal(tm_cc.tile_rowidx, tm_np.tile_rowidx)
    np.testing.assert_array_equal(tm_cc.tile_columnidx, tm_np.tile_columnidx)
    np.testing.assert_array_equal(tm_cc.tile_nnz, tm_np.tile_nnz)
    np.testing.assert_array_equal(tm_cc.fmt, tm_np.fmt)
    for name in ("csr", "coo", "ell", "hyb", "dns", "dnsrow", "dnscol"):
        a, b = getattr(tm_cc, name), getattr(tm_np, name)
        for field in a.__dataclass_fields__:
            np.testing.assert_array_equal(
                getattr(a, field), getattr(b, field),
                err_msg=f"bucket {name}.{field}")
    np.testing.assert_array_equal(tm_cc.residual.indptr,
                                  tm_np.residual.indptr)
    np.testing.assert_array_equal(tm_cc.residual.indices,
                                  tm_np.residual.indices)
    np.testing.assert_array_equal(tm_cc.residual.val, tm_np.residual.val)


@pytest.mark.parametrize("name", ["mixed", "banded", "powerlaw", "uniform"])
def test_native_matches_numpy(name):
    gens = {
        "mixed": lambda: generate.mixed_structure(700, 500, seed=21),
        "banded": lambda: generate.banded(1024, 1024, 7, seed=22),
        "powerlaw": lambda: generate.power_law(1024, 1024, 14, seed=23),
        "uniform": lambda: generate.random_uniform(1024, 1024, 0.002,
                                                   seed=24),
    }
    _compare(gens[name]())


def test_native_forced_format():
    csr = generate.mixed_structure(512, 512, seed=25)
    for f in ("csr", "coo", "ell", "dns"):
        _compare(csr, TileConfig(force_format=f))


def test_native_hyb_enabled():
    csr = generate.power_law(512, 512, 20, seed=26)
    _compare(csr, TileConfig(enable_hyb=True, hyb_cv_threshold=0.3,
                             hyb_max_coo=64))


def test_native_truncate_rows():
    csr = generate.mixed_structure(1000, 777, seed=27)
    _compare(csr, TileConfig(truncate_rows_to_tile=True))


def test_native_env_disable(monkeypatch):
    # the loader caches; just verify the public knob exists and converter
    # still works through the fallback path
    csr = generate.banded(256, 256, 2, seed=28)
    tm = tile_create(csr, use_native=False)
    assert tm.tilenum > 0
