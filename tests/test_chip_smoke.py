"""chip_smoke.py: refuses to run without a card, and its phases run on
the CPU at tiny sizes (the card runs them at full size)."""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from tilespmv_tpu.core.convert import tile_create  # noqa: E402
from tilespmv_tpu.io import generate  # noqa: E402


def _last_line_is_ok(stdout: str) -> bool:
    lines = stdout.strip().splitlines()
    try:
        return bool(lines) and json.loads(lines[-1]).get("ok") is True
    except json.JSONDecodeError:
        return False


def test_exits_nonzero_without_a_card(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode != 0
    assert not _last_line_is_ok(r.stdout)


def test_exits_nonzero_without_the_repo(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert not _last_line_is_ok(r.stdout)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_phase_spmv_tiny(dtype):
    csr = generate.mixed_structure(512, 512, seed=3)
    rec = chip_smoke.phase_spmv("mixed", csr, tile_create(csr), dtype,
                                "cpu", reps=2)
    assert rec["ok"], rec
    assert rec["nnz"] == csr.nnz and rec["call_ms"] > 0


def test_phase_entry_points_tiny():
    csr = generate.rectangular(384, 200, 6, seed=4)
    rec = chip_smoke.phase_entry_points(csr, "cpu", k=3)
    assert rec["ok"], rec


def test_phase_cg_tiny():
    rec = chip_smoke.phase_cg(1 << 12, "cpu")
    assert rec["ok"], rec
    assert rec["numpy_true_residual"] <= chip_smoke.CG_TOL


def test_numpy_cg_reaches_tolerance():
    from examples.cg import make_spd
    csr = make_spd(n=1 << 10)
    b = np.ones(csr.n)
    x, iters = chip_smoke.numpy_cg(csr, b)
    assert 0 < iters < 200
    assert np.linalg.norm(b - csr.matvec(x)) <= 1e-9 * np.linalg.norm(b)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_phase_distributed_tiny(dtype):
    """The --four-cards phase on four virtual CPU devices."""
    csr = generate.stencil_3d(12, 12, 12, seed=5)
    recs = chip_smoke.phase_distributed("stencil", csr, dtype, "cpu")
    assert [r["op"] for r in recs] == ["1d_allgather", "1d_halo",
                                       "1d_auto", "2d_2x2"]
    assert all(r["ok"] for r in recs), recs
