"""Roofline table, correctness gates and the compile-cache helper."""
import pathlib
from types import SimpleNamespace

import numpy as np
import jax
import pytest

from tilespmv_tpu.bench import check, roofline
from tilespmv_tpu.utils import jax_cache


def test_roofline_h100_resolves():
    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    peak = roofline.peak_for(dev)
    assert peak.hbm_gbps == 3350.0
    assert peak.fp32_gflops == 67e3 and peak.fp64_gflops == 34e3
    assert "data sheet" in peak.source


def test_roofline_unknown_device_raises():
    dev = SimpleNamespace(platform="gpu", device_kind="Some Future Card")
    with pytest.raises(KeyError, match="Some Future Card"):
        roofline.peak_for(dev)


def test_roofline_cpu_is_none():
    assert roofline.peak_for(jax.devices("cpu")[0]) is None


def test_gates_pass_exact_and_flag_tf32_sized_error():
    rng = np.random.default_rng(0)
    ref = rng.standard_normal(1000)
    mag = np.abs(ref)
    ok = check.gates(ref.astype(np.float32), ref, mag, np.float32)
    assert ok["ok"] and ok["ref_gate_bad_rows"] == 0
    # ~1e-3 relative error: inside the reference's 1% gate, 100x over
    # the f32 scaled gate
    tf32 = ref * (1 + 1e-3 * rng.choice([-1, 1], ref.size))
    bad = check.gates(tf32, ref, mag, np.float32)
    assert not bad["ok"] and bad["ref_gate_bad_rows"] == 0
    assert bad["scaled_err"] > 50 * check.SCALED_TOL["float32"]
    # an f32-accurate result fails the f64 gate
    assert not check.gates(ref.astype(np.float32), ref, mag,
                           np.float64)["ok"]


def test_gates_zero_magnitude_rows_must_be_exact():
    ref = np.zeros(4)
    mag = np.zeros(4)
    assert check.gates(np.zeros(4), ref, mag, np.float64)["ok"]
    assert not check.gates(np.array([0, 0, 1e-30, 0]), ref, mag,
                           np.float64)["ok"]
    with pytest.raises(ValueError, match="shape"):
        check.gates(np.zeros(3), ref, mag, np.float64)


def test_cache_env_var_is_honoured(monkeypatch):
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/else")
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert jax_cache.configure_compile_cache() == "/somewhere/else"
    assert calls == []


def test_cache_default_path_is_fixed(monkeypatch):
    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    repo = pathlib.Path(__file__).resolve().parents[1]
    want = str(repo / ".cache" / "jax")
    assert jax_cache.configure_compile_cache() == want
    assert jax_cache.configure_compile_cache() == want
    assert ("jax_compilation_cache_dir", want) in calls
