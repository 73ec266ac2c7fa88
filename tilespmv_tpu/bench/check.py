"""Correctness gates against the float64 CSR golden model.

Every device result is held to two gates:

1. the reference gate, |y - ŷ| <= 0.01|ŷ| + 1e-4 (main.cu:186-197);
2. a scaled gate, |y - ŷ|_i / Σ_j |a_ij x_j| <= SCALED_TOL[dtype]. One
   rounding per product plus the order of the scatter-adds bounds the
   error by a small multiple of the unit roundoff times that magnitude
   sum, so f32 passes at 1e-5 and f64 at 1e-12. A float32 product run
   in TF32 (about 3 decimal digits) fails it by about 100x.
"""
from __future__ import annotations

import numpy as np

from ..io.mmio import CSRMatrix

SCALED_TOL = {"float32": 1e-5, "float64": 1e-12}


def golden(csr: CSRMatrix, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(ŷ, Σ_j |a_ij x_j|) in float64, rows in CSR order."""
    rows = np.repeat(np.arange(csr.m), np.diff(csr.indptr))
    prod = csr.data.astype(np.float64) * np.asarray(
        x, np.float64)[csr.indices]
    y = np.bincount(rows, weights=prod, minlength=csr.m)
    mag = np.bincount(rows, weights=np.abs(prod), minlength=csr.m)
    return y, mag


def gates(y, ref: np.ndarray, mag: np.ndarray, dtype) -> dict:
    """Both gates for one result; `ok` is True only when both pass.
    Rows whose magnitude sum is zero must match exactly."""
    y = np.asarray(y, np.float64)
    if y.shape != ref.shape:
        raise ValueError(f"y has shape {y.shape}, expected {ref.shape}")
    err = np.abs(y - ref)
    ref_bad = int(np.sum(err > 0.01 * np.abs(ref) + 1e-4))
    scaled = np.where(mag > 0, err / np.where(mag > 0, mag, 1.0),
                      np.where(err > 0, np.inf, 0.0))
    worst = float(scaled.max()) if scaled.size else 0.0
    tol = SCALED_TOL[np.dtype(dtype).name]
    return dict(ok=bool(ref_bad == 0 and worst <= tol),
                ref_gate_bad_rows=ref_bad, scaled_err=worst,
                scaled_tol=tol)
