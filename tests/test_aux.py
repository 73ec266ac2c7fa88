"""Aux subsystem tests: host utils, serialization, the sweep CLI."""
import numpy as np
import pytest

from tilespmv_tpu import TileConfig, csr_from_coo, tile_create
from tilespmv_tpu.core.serialize import load_tile_matrix, save_tile_matrix
from tilespmv_tpu.io import generate
from tilespmv_tpu.ops.cpu_reference import spmv_cpu
from tilespmv_tpu.ops.spmv import TileSpMV
from tilespmv_tpu.utils import (binary_search_right_boundary, csr_transpose,
                                exclusive_scan)


def test_exclusive_scan():
    np.testing.assert_array_equal(exclusive_scan([3, 1, 4]), [0, 3, 4, 8])
    np.testing.assert_array_equal(exclusive_scan([]), [0])


def test_binary_search_right_boundary():
    b = np.array([0, 3, 4, 8])
    np.testing.assert_array_equal(
        binary_search_right_boundary(b, np.array([0, 2, 3, 7])),
        [0, 0, 1, 2])


def test_csr_transpose_roundtrip():
    csr = generate.mixed_structure(100, 77, seed=31)
    t = csr_transpose(csr)
    np.testing.assert_allclose(t.to_dense(), csr.to_dense().T)
    tt = csr_transpose(t)
    np.testing.assert_allclose(tt.to_dense(), csr.to_dense())


def test_tile_matrix_save_load(tmp_path):
    csr = generate.mixed_structure(512, 300, seed=32)
    tm = tile_create(csr, TileConfig(coo_nnz_threshold=10))
    p = str(tmp_path / "tm.npz")
    save_tile_matrix(p, tm)
    back = load_tile_matrix(p)
    assert back.shape == tm.shape and back.nnz == tm.nnz
    assert back.config.coo_nnz_threshold == 10
    np.testing.assert_array_equal(back.fmt, tm.fmt)
    x = np.linspace(-1, 1, tm.n)
    np.testing.assert_array_equal(spmv_cpu(back, x), spmv_cpu(tm, x))
    # loaded container feeds the device operator directly
    op = TileSpMV(back, config=back.config)
    y = np.asarray(op(x.astype(np.float32)))
    np.testing.assert_allclose(y, csr.to_dense().astype(np.float32)
                               @ x.astype(np.float32), rtol=2e-4, atol=1e-4)


def _plan_save_load(tmp_path, dtype, rtol):
    """SpMVPlans serialize (plan build is a large host cost): the arrays
    come back byte-identical and drive the operator end to end."""
    import dataclasses as _dc

    from tilespmv_tpu.core.serialize import load_plan, save_plan
    csr = generate.mixed_structure(2048, 2048, seed=34)
    op = TileSpMV(csr, compute_dtype=dtype)
    p = str(tmp_path / "plan.npz")
    save_plan(p, op.plan)
    back = load_plan(p, device=False)

    def _compare(a, b, path=""):
        if isinstance(a, tuple):
            assert isinstance(b, tuple) and len(a) == len(b), path
            for i, (ca, cb) in enumerate(zip(a, b)):
                _compare(ca, cb, f"{path}.{i}")
            return
        if _dc.is_dataclass(a):
            assert type(a).__name__ == type(b).__name__, path
            for f in _dc.fields(a):
                _compare(getattr(a, f.name), getattr(b, f.name),
                         f"{path}.{f.name}")
            return
        if hasattr(a, "shape"):
            av, bv = np.asarray(a), np.asarray(b)
            assert av.dtype == bv.dtype and av.shape == bv.shape, path
            np.testing.assert_array_equal(av, bv, err_msg=path)
            return
        assert a == b, path

    _compare(op.plan, back, "plan")
    op2 = TileSpMV.from_plan(load_plan(p))
    assert op2.shape == (csr.m, csr.n) and op2.compute_dtype == dtype
    x = np.linspace(-1, 1, csr.n).astype(dtype)
    np.testing.assert_allclose(np.asarray(op2(x)),
                               csr.matvec(x.astype(np.float64)),
                               rtol=rtol, atol=rtol)


def test_lane_plan_save_load_roundtrip(tmp_path):
    _plan_save_load(tmp_path, np.float32, 2e-4)


def test_lane_plan_save_load_df64(tmp_path):
    """f64 plans round-trip and run in native double precision."""
    _plan_save_load(tmp_path, np.float64, 1e-12)


def test_from_plan_rejects_other_types():
    with pytest.raises(TypeError, match="SpMVPlan"):
        TileSpMV.from_plan(object())


def test_sweep_manifest_smoke(tmp_path, capsys):
    """--sweep-manifest over a fixtures-scale manifest: the whole
    reference-parity real-corpus path (manifest parse -> UFget layout
    resolve -> load -> convert -> bench) minus the network fetch
    (reference bench0.sh:1-14; scripts/fetch_suitesparse.py documents
    the fetch)."""
    import shutil

    from tilespmv_tpu import cli
    root = tmp_path / "corpus"
    (root / "HB" / "nist").mkdir(parents=True)
    fix = "tests/fixtures/nist_example.mtx"
    shutil.copy(fix, root / "HB" / "nist" / "nist.mtx")
    # fallback layout: <name>.mtx directly under the root
    shutil.copy(fix, root / "flat.mtx")
    man = tmp_path / "man.csv"
    man.write_text("1,HB,nist,5,5,8\n2,HB,flat,5,5,8\n3,HB,absent,5,5,8\n")
    rc = cli.main(["--sweep-manifest", str(man), "--matrix-dir",
                   str(root), "--iters", "2", "--reps", "1",
                   "--warmup", "1", "--csv", ""])
    out = capsys.readouterr().out
    assert rc == 0
    assert "sweeping 2 manifest matrices (1 not fetched)" in out
    assert "2/2 ok" in out


def test_sweep_resume_skips_recorded_rows(tmp_path, capsys):
    """--resume: matrices whose name already has a results.csv row are
    skipped (an interrupted 2,757-matrix sweep restarts where it
    stopped instead of re-timing everything)."""
    import shutil

    from tilespmv_tpu import cli
    root = tmp_path / "corpus"
    root.mkdir()
    fix = "tests/fixtures/nist_example.mtx"
    shutil.copy(fix, root / "a.mtx")
    shutil.copy(fix, root / "b.mtx")
    csvp = tmp_path / "results.csv"
    csvp.write_text("a.mtx,5,5,8,0.001000,0.0160\n")  # prior-run row
    rc = cli.main(["--sweep-dir", str(root), "--resume",
                   "--iters", "2", "--reps", "1", "--warmup", "1",
                   "--csv", str(csvp)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "resumed: 1 matrices already in" in out
    assert "a.mtx: ms=" not in out      # skipped, not re-timed
    assert "b.mtx: ms=" in out          # the new row still runs
    # the pre-existing row was not duplicated
    names = [ln.split(",", 1)[0]
             for ln in csvp.read_text().splitlines() if ln]
    assert names.count("a.mtx") == 1


def test_cli_save_and_load_plan(tmp_path, capsys):
    """--save-plan writes the SpMVPlan; --load-plan runs it without
    conversion and checks it against the matrix."""
    from tilespmv_tpu import cli
    p = str(tmp_path / "mixed.plan.npz")
    common = ["--iters", "2", "--reps", "1", "--warmup", "1", "--csv", ""]
    assert cli.main(["mixed_small", "--save-plan", p] + common) == 0
    assert f"plan saved to {p}" in capsys.readouterr().out
    assert cli.main(["mixed_small", "--load-plan", p] + common) == 0
    out = capsys.readouterr().out
    assert "plan loaded in" in out and "PASS" in out
